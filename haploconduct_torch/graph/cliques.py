"""Maximal clique enumeration over the (undirected view of the) overlap
graph — the input to superread construction.

Implements the Eppstein-Löffler-Strash degeneracy-ordered Bron-Kerbosch
with pivoting, O(d * n * 3^(d/3)): the same algorithm the reference invokes
through the vendored quick-cliques binary (`qc --algorithm=degeneracy`,
src/ViralQuasispecies.cpp:397-410) — re-implemented from the algorithm, with
a fully specified deterministic ordering:

- degeneracy order: repeatedly remove the minimum-degree vertex, smallest
  id first;
- pivot: vertex of P ∪ X maximizing |P ∩ N(u)|, scanning P then X in
  ascending id, first maximum wins;
- branch vertices v ∈ P \\ N(pivot) explored in ascending id.

Two backends: pure Python (reference/tests) and a C++ extension
(haploconduct_tpu/native/cliques.cpp) with identical output order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _build_adj(n: int, v1: np.ndarray, v2: np.ndarray) -> List[np.ndarray]:
    """Sorted, deduplicated undirected adjacency sets."""
    v1 = np.asarray(v1, dtype=np.int64)
    v2 = np.asarray(v2, dtype=np.int64)
    keep = v1 != v2
    a = np.concatenate([v1[keep], v2[keep]])
    b = np.concatenate([v2[keep], v1[keep]])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    if len(a):
        dup = np.zeros(len(a), dtype=bool)
        dup[1:] = (a[1:] == a[:-1]) & (b[1:] == b[:-1])
        a, b = a[~dup], b[~dup]
    counts = np.bincount(a, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [b[offsets[i]:offsets[i + 1]] for i in range(n)]


def degeneracy_order(n: int, adj: List[np.ndarray]) -> np.ndarray:
    """Smallest-last order: repeatedly remove the min-degree vertex
    (smallest id on ties) via a bucket queue."""
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    removed = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    import heapq

    heap = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    cur_deg = deg.copy()
    k = 0
    while heap:
        d, v = heapq.heappop(heap)
        if removed[v] or d != cur_deg[v]:
            continue
        removed[v] = True
        order[k] = v
        k += 1
        for w in adj[v]:
            if not removed[w]:
                cur_deg[w] -= 1
                heapq.heappush(heap, (int(cur_deg[w]), int(w)))
    assert k == n
    return order


def enumerate_cliques_py(n: int, v1: np.ndarray, v2: np.ndarray) -> List[List[int]]:
    """All maximal cliques (including isolated vertices as singletons)."""
    adj = _build_adj(n, v1, v2)
    adj_sets = [set(a.tolist()) for a in adj]
    order = degeneracy_order(n, adj)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)

    out: List[List[int]] = []

    def bk(r: List[int], p: List[int], x: List[int]) -> None:
        if not p and not x:
            out.append(list(r))
            return
        # pivot: max |P ∩ N(u)| over P then X, ascending, first max wins
        best_u, best_c = -1, -1
        for u in sorted(p) + sorted(x):
            c = sum(1 for w in p if w in adj_sets[u])
            if c > best_c:
                best_u, best_c = u, c
        for v in sorted(p):
            if v in adj_sets[best_u]:
                continue
            nv = adj_sets[v]
            bk(r + [v], [w for w in p if w in nv], [w for w in x if w in nv])
            p.remove(v)
            x.append(v)

    for v in order:
        v = int(v)
        later = [int(w) for w in adj[v] if rank[w] > rank[v]]
        earlier = [int(w) for w in adj[v] if rank[w] < rank[v]]
        bk([v], later, earlier)
    return out


def enumerate_cliques_tomita(n: int, v1: np.ndarray, v2: np.ndarray) -> List[List[int]]:
    """Adjacency-matrix Bron-Kerbosch with pivoting (Tomita et al.), the
    reference's `qc --algorithm=tomita` (quick-cliques/src/TomitaAlgorithm).
    Candidate sets are boolean vectors; the pivot scan |P ∩ N(u)| is one
    vectorized matrix-row reduction instead of a per-vertex loop."""
    adj = _build_adj(n, v1, v2)
    A = np.zeros((n, n), dtype=bool)
    for v, nbrs in enumerate(adj):
        A[v, nbrs] = True

    out: List[List[int]] = []

    def bk(r: List[int], p: np.ndarray, x: np.ndarray) -> None:
        if not p.any():
            if not x.any():
                out.append(list(r))
            return
        cand = np.flatnonzero(p | x)
        counts = A[cand][:, p].sum(axis=1)
        u = int(cand[np.argmax(counts)])  # first max wins, ascending id
        for v in np.flatnonzero(p & ~A[u]):
            v = int(v)
            nv = A[v]
            bk(r + [v], p & nv, x & nv)
            p = p.copy()
            x = x.copy()
            p[v] = False
            x[v] = True

    bk([], np.ones(n, dtype=bool), np.zeros(n, dtype=bool))
    return out


def enumerate_cliques_adjlist(n: int, v1: np.ndarray, v2: np.ndarray) -> List[List[int]]:
    """Adjacency-list Bron-Kerbosch with pivoting, no degeneracy ordering
    (the reference's `qc --algorithm=adjlist`,
    quick-cliques/src/AdjacencyListAlgorithm)."""
    adj = _build_adj(n, v1, v2)
    adj_sets = [set(a.tolist()) for a in adj]
    out: List[List[int]] = []

    def bk(r: List[int], p: List[int], x: List[int]) -> None:
        if not p and not x:
            out.append(list(r))
            return
        best_u, best_c = -1, -1
        for u in sorted(p) + sorted(x):
            c = sum(1 for w in p if w in adj_sets[u])
            if c > best_c:
                best_u, best_c = u, c
        for v in sorted(p):
            if v in adj_sets[best_u]:
                continue
            nv = adj_sets[v]
            bk(r + [v], [w for w in p if w in nv], [w for w in x if w in nv])
            p.remove(v)
            x.append(v)

    bk([], list(range(n)), [])
    return out


# adjacency-matrix variants allocate an n*n matrix; the reference only does
# so below 20k vertices (quick-cliques/src/main.cpp:167-191)
MATRIX_VERTEX_LIMIT = 20_000

ALGORITHMS = ("degeneracy", "tomita", "adjlist", "hybrid")


def enumerate_cliques(
    n: int, v1: np.ndarray, v2: np.ndarray, algorithm: str = "degeneracy"
) -> List[List[int]]:
    """All maximal cliques. `algorithm` mirrors the reference's
    `qc --algorithm=` dispatch (quick-cliques/src/main.cpp:209-220);
    `degeneracy` (the one every reference workflow uses) runs the native
    C++ backend when available, Python fallback otherwise. `hybrid` picks
    matrix vs list form by vertex count as the reference does."""
    if algorithm == "hybrid":
        algorithm = "tomita" if n < MATRIX_VERTEX_LIMIT else "adjlist"
    if algorithm == "tomita":
        if n >= MATRIX_VERTEX_LIMIT:
            raise ValueError(
                f"tomita needs an n^2 matrix; n={n} exceeds {MATRIX_VERTEX_LIMIT}")
        return enumerate_cliques_tomita(n, v1, v2)
    if algorithm == "adjlist":
        return enumerate_cliques_adjlist(n, v1, v2)
    if algorithm != "degeneracy":
        raise ValueError(f"unknown algorithm {algorithm!r}; one of {ALGORITHMS}")
    try:
        from ..native import load_cliques_ext

        ext = load_cliques_ext()
    except Exception:
        ext = None
    if ext is None:
        return enumerate_cliques_py(n, v1, v2)
    flat, offsets = ext.enumerate_cliques(
        int(n),
        np.ascontiguousarray(v1, dtype=np.int64),
        np.ascontiguousarray(v2, dtype=np.int64),
    )
    return [flat[offsets[i]:offsets[i + 1]].tolist() for i in range(len(offsets) - 1)]


def enumerate_cliques_ref(n: int, u: np.ndarray, v: np.ndarray) -> List[List[int]]:
    """All maximal cliques in the EXACT emission order (and member order) of
    the reference's `qc --algorithm=degeneracy` run on a graph.txt whose
    edge lines are (u[i], v[i]) in sequence — see
    OverlapGraph.graph_txt_pairs() for producing that sequence.

    Matches quick-cliques/src/DegeneracyAlgorithm.cpp:107-528 (verified
    against the compiled reference binary on random graphs and the bundled
    examples). Clique order feeds the EC used_nodes / remove_multi_occ
    filters, so this is what bit-identical contig parity requires. Falls
    back to the spec-order enumerator if the native extension is missing.
    """
    from ..native import load_refsem_ext

    ext = load_refsem_ext()
    if ext is None:
        import warnings

        warnings.warn("refsem extension unavailable; clique order will not "
                      "match the reference binary")
        return enumerate_cliques(n, u, v)
    flat, offsets = ext.enumerate_cliques_ref(int(n), u, v)
    return [flat[offsets[i]:offsets[i + 1]].tolist() for i in range(len(offsets) - 1)]


def max_clique_size(n: int, v1: np.ndarray, v2: np.ndarray) -> int:
    cliques = enumerate_cliques(n, v1, v2)
    return max((len(c) for c in cliques), default=0)


def write_cliques(path: str, cliques: List[List[int]]) -> None:
    """One clique per line, space-separated (quick-cliques
    PRINT_CLIQUES_ONE_BY_ONE format)."""
    with open(path, "w") as f:
        for c in cliques:
            f.write(" ".join(map(str, c)) + " \n")


def read_cliques(path: str) -> List[List[int]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out.append([int(x) for x in parts])
    return out
