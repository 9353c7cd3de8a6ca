"""Interactive hierarchy pages of the vendored CIFAR10 hierarchies.

Counterpart of ``examples/vis_demo.py``: writes two self-contained HTML
trees through :mod:`nbdt_torch.hierarchy.vis` (click a node to collapse or
expand its subtree, scroll to zoom, drag to pan): the WordNet hierarchy with
sublabels and its vertebrate subtree collapsed, and the induced hierarchy
with the path to "cat" coloured.

    python -m nbdt_torch.examples.vis_demo [out_dir]
"""

import sys

from ..hierarchy.vis import generate_hierarchy_vis
from ..utils import hierarchy_to_path_graph

PAGES = (("wordnet", dict(sublabels=True, collapse=["n01471682"])),  # vertebrate closed
         ("induced", dict(color_path_to="cat")))


def main(out_dir: str = "out/vis-demo") -> list:
    """Writes the two pages under ``out_dir``; returns their paths."""
    paths = [generate_hierarchy_vis("CIFAR10", hierarchy_to_path_graph("CIFAR10", name),
                                    out_dir=out_dir, **kwargs) for name, kwargs in PAGES]
    print(f"==> Open the HTML files under {out_dir}/ in a browser; "
          "click nodes to collapse, scroll to zoom, drag to pan.")
    return paths


if __name__ == "__main__":
    main(*sys.argv[1:2])
