"""Ward agglomerative clustering over class embeddings.

Counterpart of ``nbdt_tpu/hierarchy/cluster.py`` (numpy; the port keeps its
own copy). The reference induces its hierarchy with sklearn's
``AgglomerativeClustering(linkage='ward', affinity='euclidean')`` over the
rows of the network's final FC layer (reference graph.py:437-439) and then
walks ``clustering.children_`` bottom-up (graph.py:443-461).

sklearn's ``children_`` is exactly the pair columns of scipy's
``scipy.cluster.hierarchy.ward`` linkage matrix (verified empirically), i.e.
the full (n-1)-merge tree sorted by merge distance with new clusters labeled
``n + merge_index``. We therefore reproduce *that* contract directly:

    ward_children(X) -> int array [n-1, 2]

preferring scipy when present and falling back to a pure-numpy greedy
Lance-Williams implementation that produces identical output for distinct
distances. This keeps hierarchy induction byte-compatible with reference-
generated graphs without depending on sklearn.
"""

from __future__ import annotations

import numpy as np


def ward_children(X: np.ndarray) -> np.ndarray:
    """Full ward merge list, scipy/sklearn ``children_`` compatible."""
    X = np.asarray(X, dtype=np.float64)
    assert X.ndim == 2, f"expected [n, d] centers, got {X.shape}"
    try:
        from scipy.cluster.hierarchy import ward as _scipy_ward

        Z = _scipy_ward(X)
        return Z[:, :2].astype(np.int64)
    except Exception:
        return _ward_children_numpy(X)


def _ward_children_numpy(X: np.ndarray) -> np.ndarray:
    """Greedy ward agglomeration (Lance-Williams), O(n^2) memory.

    At each step merges the globally closest active pair under the ward
    objective d(A,B)^2 = 2|A||B|/(|A|+|B|) * ||mu_A - mu_B||^2, labels the
    merge ``n + step``, and records the pair as (min_id, max_id) — matching
    scipy's sorted-by-height linkage for distinct merge distances.
    """
    n = X.shape[0]
    if n < 2:
        return np.zeros((0, 2), dtype=np.int64)

    # Active cluster state. ids grow past n as merges happen.
    centroids = X.copy()
    sizes = np.ones(n, dtype=np.float64)
    ids = np.arange(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)

    # Pairwise ward cost (squared) between active clusters, ∞ on diagonal
    # and inactive rows/cols.
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    cost = sq.copy()  # sizes all 1: 2*1*1/2 * d^2 = d^2
    np.fill_diagonal(cost, np.inf)

    children = np.zeros((n - 1, 2), dtype=np.int64)
    for step in range(n - 1):
        flat = np.argmin(cost)
        i, j = np.unravel_index(flat, cost.shape)
        a, b = ids[i], ids[j]
        children[step] = (min(a, b), max(a, b))

        # Merge j into i.
        si, sj = sizes[i], sizes[j]
        new_centroid = (centroids[i] * si + centroids[j] * sj) / (si + sj)
        centroids[i] = new_centroid
        sizes[i] = si + sj
        ids[i] = n + step
        active[j] = False
        cost[j, :] = np.inf
        cost[:, j] = np.inf

        # Recompute ward cost of the merged cluster vs all active others.
        mask = active.copy()
        mask[i] = False
        if mask.any():
            d2 = ((centroids[mask] - new_centroid) ** 2).sum(-1)
            sk = sizes[mask]
            w = 2.0 * sizes[i] * sk / (sizes[i] + sk)
            cost[i, mask] = w * d2
            cost[mask, i] = w * d2
        cost[i, i] = np.inf
    return children
