"""Leiden community detection (CPM and modularity objectives).

Counterpart of infercnv_tpu/subcluster/leiden.py (lines 1-249), host numpy
and scipy copied from there: ``auto_resolution``, ``knn_graph`` and
``snn_graph`` (:23-70) unchanged; ``leiden`` calls the native C++ Leiden
(infercnv_tpu_torch/native, built with g++ at first use) and raises if it
cannot be built, where the reference falls back quietly to Python
(:167-178); the reference's pure-Python Leiden (``_Partition``, ``_refine``,
``_aggregate``, :73-146, :212-249) is kept as ``leiden_plain``, the plain
version the tests hold the native one against.

The reference calls igraph's C implementation (``cluster_leiden``,
R/inferCNV_tumor_subclusters.R:714-715, 736-737) on an SNN or kNN graph,
with the auto resolution (11.98/n)^(1/1.165) (:588).
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def auto_resolution(num_cells: int) -> float:
    """reference: R/inferCNV_tumor_subclusters.R:588."""
    return (11.98 / num_cells) ** (1.0 / 1.165)


def knn_graph(nn_idx: np.ndarray, num_cells: int, mode: str = "undirected") -> sparse.csr_matrix:
    """Binary adjacency from a [C, k] neighbor-index array (self column
    included, as RANN returns), symmetrized like igraph
    graph_from_adjacency_matrix(mode='undirected' collapses, 'min' keeps
    mutual edges only) — reference .leiden_simple_snn (:725-741)."""
    C, k = nn_idx.shape
    if C != num_cells:
        raise ValueError(f"nn_idx has {C} rows but num_cells={num_cells}")
    rows = np.repeat(np.arange(C), k)
    cols = nn_idx.ravel()
    keep = rows != cols  # drop self loops
    A = sparse.csr_matrix(
        (np.ones(keep.sum(), np.float64), (rows[keep], cols[keep])), shape=(C, C)
    )
    if mode == "undirected":
        A = A.maximum(A.T)
    elif mode == "min":
        A = A.minimum(A.T)
    A.sum_duplicates()
    return A


def snn_graph(nn_idx: np.ndarray, num_cells: int, prune: float = 1.0 / 15.0) -> sparse.csr_matrix:
    """Seurat-style shared-nearest-neighbor graph: edge weight = Jaccard
    overlap of the two cells' k-neighborhoods, pruned below `prune`
    (Seurat FindNeighbors defaults; reference uses seurat_obs@graphs snn,
    R/inferCNV_tumor_subclusters.R:713-714)."""
    C, k = nn_idx.shape
    if C != num_cells:
        raise ValueError(f"nn_idx has {C} rows but num_cells={num_cells}")
    rows = np.repeat(np.arange(C), k)
    M = sparse.csr_matrix((np.ones(C * k), (rows, nn_idx.ravel())), shape=(C, C))
    shared = (M @ M.T).tocoo()  # counts of shared neighbors
    jac = shared.data / (2.0 * k - shared.data)
    keep = jac >= prune
    A = sparse.csr_matrix((jac[keep], (shared.row[keep], shared.col[keep])), shape=(C, C))
    A.setdiag(0)
    A.eliminate_zeros()
    # igraph mode="min" on the SNN (reference :714): keep symmetric min
    return A.minimum(A.T).tocsr()


class _Partition:
    def __init__(self, A: sparse.csr_matrix, node_sizes: np.ndarray,
                 objective: str, resolution: float, total_weight: float):
        self.A = A
        self.n = A.shape[0]
        self.sizes = node_sizes.astype(np.float64)
        self.objective = objective
        self.gamma = resolution
        self.m2 = total_weight  # 2m (sum of all entries incl both directions)
        self.membership = np.arange(self.n)
        self.strength = np.asarray(A.sum(axis=1)).ravel()
        self.comm_size = self.sizes.copy()
        self.comm_strength = self.strength.copy()

    def _gain(self, v: int, edges_to: float, target: int) -> float:
        if self.objective == "CPM":
            return edges_to - self.gamma * self.sizes[v] * self.comm_size[target]
        # modularity
        return edges_to - self.gamma * self.strength[v] * self.comm_strength[target] / self.m2

    def move_nodes(self, rng: np.random.Generator, max_iters: int = 20) -> bool:
        from collections import deque

        indptr, indices, data = self.A.indptr, self.A.indices, self.A.data
        improved_any = False
        order = rng.permutation(self.n)
        it = 0
        queue = deque(order)
        while queue and it < max_iters * self.n:
            v = queue.popleft()
            it += 1
            cv = self.membership[v]
            # remove v from its community
            self.comm_size[cv] -= self.sizes[v]
            self.comm_strength[cv] -= self.strength[v]
            # tally edges to neighboring communities
            acc = {}
            for j in range(indptr[v], indptr[v + 1]):
                u = indices[j]
                if u == v:
                    continue
                cu = self.membership[u]
                acc[cu] = acc.get(cu, 0.0) + data[j]
            best_c, best_gain = cv, self._gain(v, acc.get(cv, 0.0), cv)
            for c, w in acc.items():
                if c == cv:
                    continue
                g = self._gain(v, w, c)
                if g > best_gain + 1e-12:
                    best_gain, best_c = g, c
            self.membership[v] = best_c
            self.comm_size[best_c] += self.sizes[v]
            self.comm_strength[best_c] += self.strength[v]
            if best_c != cv:
                improved_any = True
                # re-queue neighbors not in the new community
                for j in range(indptr[v], indptr[v + 1]):
                    u = indices[j]
                    if self.membership[u] != best_c:
                        queue.append(u)
        return improved_any


def _relabel(membership: np.ndarray) -> np.ndarray:
    _, inv = np.unique(membership, return_inverse=True)
    return inv


def _aggregate(A: sparse.csr_matrix, membership: np.ndarray, sizes: np.ndarray):
    k = membership.max() + 1
    P = sparse.csr_matrix(
        (np.ones(membership.shape[0]), (membership, np.arange(membership.shape[0]))),
        shape=(k, membership.shape[0]),
    )
    A2 = (P @ A @ P.T).tocsr()
    sizes2 = np.asarray(P @ sizes).ravel()
    return A2, sizes2


def leiden(
    A: sparse.csr_matrix,
    resolution: float,
    objective: str = "CPM",
    seed: int = 0,
    max_levels: int = 10,
) -> np.ndarray:
    """Partition the graph with the native Leiden; returns int membership
    [C] (0-based).

    objective: 'CPM' or 'modularity' (igraph cluster_leiden semantics:
    modularity uses gamma * k_v * k_C / 2m)."""
    from infercnv_tpu_torch.native import leiden_native

    A = sparse.csr_matrix(A, dtype=np.float64)
    A.sum_duplicates()
    if A.shape[0] == 0:
        return np.zeros(0, np.int64)
    return leiden_native(A.indptr, A.indices, A.data, A.shape[0],
                         objective, resolution, seed, max_levels)


def leiden_plain(
    A: sparse.csr_matrix,
    resolution: float,
    objective: str = "CPM",
    seed: int = 0,
    max_levels: int = 10,
) -> np.ndarray:
    """The reference's pure-Python Leiden (local moving, refinement,
    aggregation), the plain version of :func:`leiden`: the same algorithm
    with numpy's generator in place of the native xorshift, so its
    partitions agree with the native ones in structure, not label for
    label."""
    A = sparse.csr_matrix(A, dtype=np.float64)
    A.sum_duplicates()
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    total_weight = float(A.sum())
    if total_weight == 0:
        return np.zeros(n, np.int64)
    sizes = np.ones(n)
    membership_full = np.arange(n)  # original node -> current Acur node
    Acur, sz = A, sizes
    final_done = False
    for _level in range(max_levels):
        part = _Partition(Acur, sz, objective, resolution, total_weight)
        improved = part.move_nodes(rng)
        memb = _relabel(part.membership)
        # refinement: split each community into connected, well-merged parts
        refined = _refine(Acur, sz, memb, objective, resolution, total_weight, rng)
        k = refined.max() + 1
        if (not improved) or k == Acur.shape[0]:
            # canonical Leiden RETURNS the move partition of the final
            # level; composing only `refined` here would silently discard
            # its merges and return a strictly finer partition
            membership_full = memb[membership_full]
            final_done = True
            break
        membership_full = refined[membership_full]
        Acur, sz = _aggregate(Acur, refined, sz)
    if not final_done:
        # level budget exhausted mid-merge: one last move pass realizes
        # the pending merges on the final aggregate graph
        part = _Partition(Acur, sz, objective, resolution, total_weight)
        part.move_nodes(rng)
        membership_full = _relabel(part.membership)[membership_full]
    return _relabel(membership_full)


def _refine(A, sizes, membership, objective, resolution, total_weight,
            rng) -> np.ndarray:
    """Leiden refinement: within each community, greedily merge singleton
    nodes into connected subcommunities."""
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data
    refined = np.arange(n)
    sub_size = sizes.astype(np.float64).copy()
    sub_strength = np.asarray(A.sum(axis=1)).ravel()
    strength = sub_strength.copy()
    for v in rng.permutation(n):
        if sub_size[refined[v]] != sizes[v] or refined[v] != v:
            # already merged into something (only merge singletons)
            continue
        acc = {}
        for j in range(indptr[v], indptr[v + 1]):
            u = indices[j]
            if u == v or membership[u] != membership[v]:
                continue
            ru = refined[u]
            acc[ru] = acc.get(ru, 0.0) + data[j]
        best_c, best_gain = refined[v], 0.0
        for c, w in acc.items():
            if c == refined[v]:
                continue
            if objective == "CPM":
                g = w - resolution * sizes[v] * sub_size[c]
            else:
                g = w - resolution * strength[v] * sub_strength[c] / total_weight
            if g > best_gain + 1e-12:
                best_gain, best_c = g, c
        if best_c != refined[v]:
            sub_size[best_c] += sizes[v]
            sub_strength[best_c] += strength[v]
            sub_size[refined[v]] -= sizes[v]
            sub_strength[refined[v]] -= strength[v]
            refined[v] = best_c
    return _relabel(refined)
