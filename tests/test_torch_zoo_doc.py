"""docs/torch/ZOO.md's inventory table lists exactly the port registry's
``--arch`` names (``nbdt_torch.models.get_model_choices()``), once each, as
tests/test_zoo_inventory.py pins docs/ZOO.md's claim for the JAX package."""

import re

from test_torch_port import REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

DOC = REPO / "docs" / "torch" / "ZOO.md"


def test_zoo_doc_lists_exactly_the_registry():
    from nbdt_torch.models import get_model_choices

    table = DOC.read_text().split("\n|---|---|---|---|---|\n", 1)[1]
    rows = re.findall(r"^\| `([^`]+)` \|", table, flags=re.M)
    assert len(rows) == len(set(rows)), sorted(r for r in rows if rows.count(r) > 1)
    assert sorted(rows) == get_model_choices()
    assert f" {len(rows)}, listed one per row" in DOC.read_text()
