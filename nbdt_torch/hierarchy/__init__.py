"""Host-side hierarchy: the graph, wnid naming and the classifier probe."""

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
