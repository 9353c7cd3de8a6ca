"""Execute every runnable Python snippet of docs/torch/MIGRATION.md on the
CPU, as tests/test_migration_doc.py does for the JAX package's guide.

The guide promises that its snippets run as-is from the repo root on the
device ``NBDT_DEVICE`` names (the card by default); here they run with
``NBDT_DEVICE=cpu`` and their ``/tmp`` scratch directory moved under
``tmp_path``. Snippets whose first non-blank line is ``# torch`` are
upstream's and are not run. chip_smoke.py's ``[docs]`` phase runs the same
snippets on the card.
"""

import ast
import re
from pathlib import Path

import pytest

from test_torch_port import FORBIDDEN, REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

DOC = REPO / "docs" / "torch" / "MIGRATION.md"
SCRATCH = "/tmp/nbdt_torch_mig"
DEVICE_LINE = 'DEVICE = os.environ.get("NBDT_DEVICE", "cuda")'


def _blocks():
    """(is_upstream, source) of each ```python block, in order."""
    out = []
    for block in re.findall(r"```python\n(.*?)```", DOC.read_text(), flags=re.S):
        first = next((line for line in block.splitlines() if line.strip()), "")
        out.append((first.strip() == "# torch", block))
    return out


SNIPPETS = [pytest.param(block, id=f"snippet{i}")
            for i, (upstream, block) in enumerate(_blocks()) if not upstream]


def _imported(block):
    names = []
    for node in ast.walk(ast.parse(block)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_doc_has_expected_snippet_split():
    """The ``# torch`` label tracks what a block is: upstream blocks import
    from ``nbdt.``; runnable blocks import ``nbdt_torch``, nothing of jax,
    flax or nbdt_tpu, and take their device from ``NBDT_DEVICE`` with the
    card as the default. A mislabelled runnable block would go unrun."""
    blocks = _blocks()
    for upstream, block in blocks:
        if upstream:
            assert re.search(r"\bfrom nbdt\.", block), f"upstream block without nbdt.:\n{block}"
            continue
        imported = _imported(block)
        assert any(name.split(".")[0] == "nbdt_torch" for name in imported), block
        assert not [n for n in imported if n.split(".")[0] in FORBIDDEN + ("nbdt",)], block
        assert DEVICE_LINE in block, f"runnable block without {DEVICE_LINE!r}:\n{block}"
    assert sum(upstream for upstream, _ in blocks) >= 2
    assert len(SNIPPETS) >= 5, "the guide lost its runnable examples"


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_snippet_runs(snippet, tmp_path, monkeypatch):
    monkeypatch.setenv("NBDT_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    snippet = snippet.replace(SCRATCH, str(tmp_path / Path(SCRATCH).name))
    exec(compile(snippet, str(DOC), "exec"), {"__name__": "__main__"})
