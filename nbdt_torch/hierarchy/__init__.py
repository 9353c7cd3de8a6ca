"""Host-side hierarchy: the graph, wnids and mini-corpora, the builders,
generation and checks, the classifier probe and the HTML visualiser.

This layer runs on the host only; its output, a node-link JSON hierarchy,
is compiled by :mod:`nbdt_torch.tree` into the static arrays the decision
rules move to the device."""

from .digraph import (
    Digraph,
    get_depth,
    get_leaf_to_path,
    get_leaves,
    get_root,
    get_roots,
    node_link_data,
    node_link_graph,
    read_graph,
    write_graph,
)
from .wnid import (
    FakeSynset,
    get_wnids,
    get_wnids_from_dataset,
    maybe_install_wordnet,
    synset_to_name,
    synset_to_wnid,
    wnid_to_name,
    wnid_to_synset,
    wordnet_available,
    write_wnids,
)
from .cluster import ward_children
from .build import (
    augment_graph,
    build_induced_graph,
    build_minimal_wordnet_graph,
    build_random_graph,
    prune_single_successor_nodes,
)
from .generate import (
    MODEL_FC_KEYS,
    check_hierarchy,
    generate_graph_fname,
    generate_hierarchy,
    get_centers_from_checkpoint,
    get_centers_from_state_dict,
    get_graph_path_from_args,
    resolve_centers,
    test_hierarchy,
)
