"""WordNet IDs, synsets, mini-corpora and wnid list files.

Counterpart of ``nbdt_tpu/hierarchy/wnid.py``. A wnid is
``<pos><offset:08d>`` (e.g. ``n02691156``). Synsets come from an installed
mini-corpus, else from the NLTK WordNet corpus where it is installed, else
are a :class:`FakeSynset` placeholder, exactly as in the JAX package. NLTK
stays optional and nothing here downloads: offline, a mini-corpus derived
from a vendored ``graph-wordnet.json`` runs the WordNet flows.
"""

from __future__ import annotations

import json
import os

from ..utils import ASSETS_ROOT, get_directory, makeparentdirs

_WORDNET_CHECKED = False
_WORDNET_AVAILABLE = False
_MINI_CORPUS = None  # {wnid: {"name": str, "hypernyms": [wnid, ...]}}


def install_mini_corpus(table) -> None:
    """Install a vendored mini WordNet: a dict (or JSON path) of
    ``{wnid: {"name": ..., "hypernyms": [wnid, ...]}}``, or a node-link
    hierarchy JSON (a vendored ``graph-wordnet.json``), whose hypernym
    chains are derived by :func:`_mini_corpus_from_node_link`. It takes
    precedence over NLTK while installed."""
    global _MINI_CORPUS
    if isinstance(table, (str, os.PathLike)):
        with open(table) as f:
            table = json.load(f)
    if isinstance(table, dict) and "nodes" in table and "links" in table:
        table = _mini_corpus_from_node_link(table)
    _MINI_CORPUS = dict(table)


def clear_mini_corpus() -> None:
    global _MINI_CORPUS
    _MINI_CORPUS = None


def mini_corpus_from_graph_json(path) -> dict:
    """The mini-corpus of a vendored WordNet hierarchy JSON. Pruning
    contracts every single-successor chain into its surviving child and
    records the removed ancestors in the node's ``contraction`` dict,
    nearest first, so each node's hypernym chain is ``node -> contraction
    keys... -> parent``; inverting that gives back the WordNet relations the
    builder saw, and the WordNet builder then reproduces the vendored graph
    offline."""
    with open(str(path)) as f:
        return _mini_corpus_from_node_link(json.load(f))


def _mini_corpus_from_node_link(data: dict) -> dict:
    table: dict = {}

    def ensure(wnid, name):
        table.setdefault(wnid, {"name": name, "hypernyms": []})

    for node in data["nodes"]:
        ensure(node["id"], node.get("label", node["id"]))
        for cw, cd in (node.get("contraction") or {}).items():
            ensure(cw, cd.get("label", cw))

    chains = {}
    for node in data["nodes"]:
        chain = [node["id"]] + list((node.get("contraction") or {}).keys())
        for lower, upper in zip(chain, chain[1:]):
            table[lower]["hypernyms"] = [upper]
        chains[node["id"]] = chain

    for link in data["links"]:
        top = chains[link["target"]][-1]
        # Append: a multi-path hierarchy gives a node several parents.
        hyp = table[top].setdefault("hypernyms", [])
        if link["source"] not in hyp:
            hyp.append(link["source"])
    return table


class MiniSynset:
    """Synset backed by a mini-corpus table: the NLTK surface the builders
    and analyzers touch (``pos/offset/name/definition/hypernyms``,
    ``common_hypernyms`` including itself as NLTK's does, ``max_depth``)."""

    def __init__(self, wnid: str, table: dict):
        self.wnid = wnid
        self._table = table

    def pos(self) -> str:
        return self.wnid[0]

    def offset(self) -> int:
        return int(self.wnid[1:])

    def name(self) -> str:
        return self._table[self.wnid]["name"]

    def definition(self) -> str:
        return self._table[self.wnid].get("definition", "(mini-corpus)")

    def hypernyms(self):
        return [MiniSynset(w, self._table) for w in self._table[self.wnid].get("hypernyms", [])]

    def _closure(self):
        seen, frontier = [], [self]
        while frontier:
            cur = frontier.pop(0)
            if cur.wnid in [s.wnid for s in seen]:
                continue
            seen.append(cur)
            frontier.extend(cur.hypernyms())
        return seen

    def common_hypernyms(self, other):
        mine = {s.wnid for s in self._closure()}
        return [s for s in other._closure() if s.wnid in mine]

    def max_depth(self) -> int:
        hyps = self.hypernyms()
        return 1 + max(h.max_depth() for h in hyps) if hyps else 0

    def __eq__(self, other):
        return isinstance(other, MiniSynset) and other.wnid == self.wnid

    def __hash__(self):
        return hash(self.wnid)


class FakeSynset:
    """Placeholder synset for generated (non-WordNet) nodes, ``f<offset>``,
    and for real wnids when no corpus can resolve them (``pos()`` keeps the
    wnid's own letter, so :func:`synset_to_wnid` gives the wnid back)."""

    def __init__(self, wnid: str):
        assert isinstance(wnid, str)
        self.wnid = wnid

    @staticmethod
    def create_from_offset(offset: int) -> "FakeSynset":
        return FakeSynset("f{:08d}".format(offset))

    def offset(self) -> int:
        return int(self.wnid[1:])

    def pos(self) -> str:
        return self.wnid[0]

    def name(self) -> str:
        return "(generated)"

    def definition(self) -> str:
        return "(generated)"

    def hypernyms(self):
        return []


def wordnet_available() -> bool:
    """True if a mini-corpus is installed or NLTK's WordNet corpus loads."""
    global _WORDNET_CHECKED, _WORDNET_AVAILABLE
    if _MINI_CORPUS is not None:
        return True
    if not _WORDNET_CHECKED:
        _WORDNET_CHECKED = True
        try:
            from nltk.corpus import wordnet as wn

            wn.synset_from_pos_and_offset("n", 2691156)  # 'airplane'
            _WORDNET_AVAILABLE = True
        except Exception:  # no nltk, or no corpus: degrade to FakeSynset
            _WORDNET_AVAILABLE = False
    return _WORDNET_AVAILABLE


def maybe_install_wordnet() -> bool:
    """Whether a WordNet corpus (NLTK's, or an installed mini-corpus) can
    serve synset lookups. Unlike the JAX package this never calls
    ``nltk.download``: the port downloads nothing."""
    return wordnet_available()


def wnid_to_synset(wnid: str):
    if wnid.startswith("f"):
        return FakeSynset(wnid)
    if _MINI_CORPUS is not None:
        if wnid in _MINI_CORPUS:
            return MiniSynset(wnid, _MINI_CORPUS)
        return FakeSynset(wnid)
    if not wordnet_available():
        return FakeSynset(wnid)
    from nltk.corpus import wordnet as wn

    try:
        return wn.synset_from_pos_and_offset(wnid[0], int(wnid[1:]))
    except Exception:  # offset unknown to the corpus
        return FakeSynset(wnid)


def synset_to_wnid(synset) -> str:
    """synset -> wnid: the pos letter and the 8-digit offset."""
    return f"{synset.pos()}{synset.offset():08d}"


def synset_to_name(synset) -> str:
    return synset.name().split(".")[0]


def wnid_to_name(wnid: str) -> str:
    return synset_to_name(wnid_to_synset(wnid))


def get_wnids(path_wnids) -> list:
    with open(str(path_wnids)) as f:
        return [wnid.strip() for wnid in f.readlines() if wnid.strip()]


def get_wnids_from_dataset(dataset: str, root: str = str(ASSETS_ROOT / "wnids")) -> list:
    """The wnids of ``root/dataset.txt``; by default the vendored list."""
    return get_wnids(f"{get_directory(dataset, root)}.txt")


def write_wnids(wnids, path) -> None:
    makeparentdirs(path)
    with open(str(path), "w") as f:
        f.write("\n".join(wnids))
