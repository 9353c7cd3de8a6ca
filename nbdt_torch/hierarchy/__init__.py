"""Host-side hierarchy: the graph, wnids and mini-corpora, the builders,
generation and checks, the classifier probe and the HTML visualiser."""

from .digraph import (
    Digraph,
    get_depth,
    get_leaf_to_path,
    get_leaves,
    get_root,
    get_roots,
    read_graph,
)
from .wnid import get_wnids, wnid_to_name
