"""Graph heuristics: orientation labelling, transitive reduction, tip and
cycle removal, branch removal.

Rebuild of src/GraphAlgos.cpp. The restart budgets (<=100 BFS labellings,
<=20 DFS orders) and fixed seeds are kept. The reference randomizes with
``std::srand(seed); std::random_shuffle(...)`` (glibc rand + libstdc++
shuffle); both are reimplemented here exactly so shuffle-dependent results
are reproducible and match a glibc/libstdc++ build of the reference.
"""

from __future__ import annotations

import os
from typing import List, Set, Tuple

import numpy as np

from .overlap_graph import OverlapGraph


# --------------------------------------------------------------------------
# glibc rand() (TYPE_3 additive feedback) + libstdc++ std::random_shuffle
# --------------------------------------------------------------------------

class GlibcRand:
    """Bit-exact glibc rand(): additive-feedback generator, degree 31."""

    def __init__(self, seed: int):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self.r = r
        self.idx = 344

    def rand(self) -> int:
        r = self.r
        i = self.idx
        val = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(val)
        self.idx += 1
        return val >> 1


def random_shuffle(seq: list, rng: GlibcRand) -> None:
    """libstdc++ std::random_shuffle: swap(a[i], a[rand() % (i+1)])."""
    for i in range(1, len(seq)):
        j = rng.rand() % (i + 1)
        seq[i], seq[j] = seq[j], seq[i]


class ShufflePerms:
    """Cached std::random_shuffle permutations for a fresh srand(seed).

    The reference re-seeds srand(seed) before every per-node shuffle
    (GraphAlgos.cpp:273), so the permutation applied to a list depends only
    on (seed, len). Simulating the 344-step glibc seeding per BFS node is
    a Python-loop hotspot; instead compute each (seed, len) permutation
    once and reuse it."""

    def __init__(self, seed: int):
        self._rng = GlibcRand(seed)
        self._rands: List[int] = []
        self._perms: dict = {0: [], 1: [0]}
        self._perms_np: dict = {}
        self._rands_np: "np.ndarray | None" = None

    def rands_np(self, n: int) -> np.ndarray:
        """First n values of the seed's glibc rand() stream (the shared
        stream all perm() lengths draw from), as an int64 array."""
        while len(self._rands) < n:
            self._rands.append(self._rng.rand())
        if self._rands_np is None or len(self._rands_np) < n:
            self._rands_np = np.asarray(self._rands, dtype=np.int64)
        return self._rands_np

    def perm(self, n: int) -> List[int]:
        p = self._perms.get(n)
        if p is None:
            while len(self._rands) < n - 1:
                self._rands.append(self._rng.rand())
            p = list(range(n))
            for i in range(1, n):
                j = self._rands[i - 1] % (i + 1)
                p[i], p[j] = p[j], p[i]
            self._perms[n] = p
        return p

    def perm_np(self, n: int) -> np.ndarray:
        p = self._perms_np.get(n)
        if p is None:
            p = self._perms_np[n] = np.asarray(self.perm(n), dtype=np.int64)
        return p

    def shuffle(self, seq: list) -> list:
        return [seq[i] for i in self.perm(len(seq))]


_shuffle_cache: dict = {}


def _shuffle_perms(seed: int) -> ShufflePerms:
    sp = _shuffle_cache.get(seed)
    if sp is None:
        sp = _shuffle_cache[seed] = ShufflePerms(seed)
    return sp


def shuffle_fresh_seed(seq: list, seed: int) -> list:
    """random_shuffle(seq) as if preceded by srand(seed), via the cache."""
    return _shuffle_perms(seed).shuffle(seq)


# --------------------------------------------------------------------------
# Vertex orientation labelling (GraphAlgos.cpp:178-349)
# --------------------------------------------------------------------------

def sort_vertices_by_indegree(g: OverlapGraph) -> np.ndarray:
    deg = g.in_degree()
    return np.lexsort((np.arange(g.n), deg))


class _LabelCtx:
    """Pass-independent state for the labelling heuristic: the merged
    per-node neighbor/parity arrays (adj_in entries first, then adj_out —
    the exact adjacency order the per-pass shuffle permutes) and the flat
    out-edge scan used for classification. Built once per call; the <=100
    passes differ only in the shuffle seed."""

    def __init__(self, g: OverlapGraph):
        from itertools import chain

        rows = g.edges
        n = g.n
        self.g = g
        self.n = n
        in_counts = np.fromiter(map(len, g.adj_in), np.int64, count=n)
        n_in = int(in_counts.sum())
        in_flat = np.fromiter(chain.from_iterable(g.adj_in), np.int64,
                              count=n_in)
        out_flat, out_src = g._flat_adj_out()
        out_counts = np.bincount(out_src, minlength=n)
        n_out = len(out_flat)
        in_nb = rows["v1"][in_flat].astype(np.int64)
        out_nb = rows["v2"][out_flat].astype(np.int64)
        in_dst = np.repeat(np.arange(n, dtype=np.int64), in_counts)

        # parity(entry) must equal the parity of the edge get_edge_idx(node,
        # nb) finds: adj_out[node] is searched first, so an in-entry whose
        # reverse out-edge exists (a 2-cycle) takes THAT edge's parity
        par_out = rows["ori1"][out_flat] == rows["ori2"][out_flat]
        key_out = out_src * n + out_nb
        uk, first_idx = np.unique(key_out, return_index=True)
        key_in_rev = in_dst * n + in_nb  # (node, u) for in-edge u -> node
        par_in_own = rows["ori1"][in_flat] == rows["ori2"][in_flat]
        if len(uk):
            pos = np.searchsorted(uk, key_in_rev)
            posc = np.minimum(pos, len(uk) - 1)
            found = (pos < len(uk)) & (uk[posc] == key_in_rev)
            par_in = np.where(found, par_out[first_idx[posc]], par_in_own)
        else:
            par_in = par_in_own

        deg = in_counts + out_counts
        start = np.concatenate([[0], np.cumsum(deg)])
        total = int(start[-1])
        merged_nb = np.empty(total, np.int64)
        merged_sm = np.empty(total, np.bool_)

        def within(counts, tot):
            return (np.arange(tot, dtype=np.int64)
                    - np.repeat(np.cumsum(counts) - counts, counts))

        in_pos = np.repeat(start[:-1], in_counts) + within(in_counts, n_in)
        out_pos = (np.repeat(start[:-1] + in_counts, out_counts)
                   + within(out_counts, n_out))
        merged_nb[in_pos] = in_nb
        merged_sm[in_pos] = par_in
        merged_nb[out_pos] = out_nb
        merged_sm[out_pos] = par_out
        self.start = start
        self.merged_nb = merged_nb
        self.merged_sm = merged_sm
        self.maxdeg = int(deg.max()) if n else 0
        self.order = [int(v) for v in sort_vertices_by_indegree(g)]
        # adj_in flat as (edge id, owning vertex) in list order; adj_out's is
        # (e_scan, c_v1) below. The tail rebuilds the lists it touches from them
        self.in_flat, self.in_dst = in_flat, in_dst

        # classification scan: alive edges in (source vertex, adjacency
        # position) order — the reference's iteration order
        self.e_scan = out_flat
        self.c_o1 = rows["ori1"][out_flat]
        self.c_o2 = rows["ori2"][out_flat]
        self.c_v1 = rows["v1"][out_flat].astype(np.int64)
        self.c_v2 = rows["v2"][out_flat].astype(np.int64)
        self.c_par = self.c_o1 == self.c_o2
        self.c_pos1 = rows["pos3"][out_flat].astype(np.int64)

    def bfs(self, rand_seed: int, orientations: np.ndarray,
            starts, visited: np.ndarray, comp: "np.ndarray | None" = None):
        """BFS labelling over the given start nodes (component roots or the
        full indegree order); writes orientations/visited in place. With
        `comp`, records the start index that discovered each node.

        Native path (native/bfslabel.cpp): the identical traversal with the
        per-node shuffle permutation rebuilt from the seed's glibc rand()
        stream — byte-for-byte the ShufflePerms order. HC_NATIVE_BFS=0
        forces this Python sweep (A/B oracle)."""
        from collections import deque

        sp = _shuffle_perms(rand_seed)
        if os.environ.get("HC_NATIVE_BFS") != "0":
            from ..native import load_bfslabel_ext

            ext = load_bfslabel_ext()
            if ext is not None:
                rands = sp.rands_np(max(self.maxdeg - 1, 0))
                ext.bfs_label(self.start, self.merged_nb, self.merged_sm,
                              rands,
                              np.asarray(starts, dtype=np.int64),
                              orientations, visited, comp, self.maxdeg)
                return
        start_arr = self.start
        merged_nb = self.merged_nb
        merged_sm = self.merged_sm
        bfs = deque()
        for ci, root in enumerate(starts):
            if visited[root]:
                continue
            visited[root] = True
            if comp is not None:
                comp[root] = ci
            bfs.append(root)
            while bfs:
                node = bfs.popleft()
                s0, e0 = int(start_arr[node]), int(start_arr[node + 1])
                k = e0 - s0
                if k == 0:
                    continue
                p = sp.perm_np(k)
                nbs = merged_nb[s0:e0][p].tolist()
                sms = merged_sm[s0:e0][p].tolist()
                o_node = bool(orientations[node])
                for nb, same in zip(nbs, sms):
                    if not visited[nb]:
                        visited[nb] = True
                        orientations[nb] = o_node == same
                        if comp is not None:
                            comp[nb] = ci
                        bfs.append(nb)

    def classify(self, orientations: np.ndarray):
        """Vectorized port of the reference's per-edge conflict scan.
        Returns (to_flip, to_move, to_delete) edge-id arrays in the same
        (source vertex, adjacency position) order the loop emitted."""
        l1 = orientations[self.c_v1]
        l2 = orientations[self.c_v2]
        ok = (self.c_o1 == l1) & (self.c_o2 == l2)
        par_violation = ~ok & (self.c_par != (l1 == l2))
        mv = ~ok & ~par_violation
        move_mask = mv & ((self.c_pos1 < 0)
                          | ((self.c_pos1 == 0) & (self.c_v1 > self.c_v2)))
        return (self.e_scan[mv & ~move_mask], self.e_scan[move_mask],
                self.e_scan[par_violation])

    def count_deletes(self, orientations: np.ndarray, sub: np.ndarray) -> int:
        l1 = orientations[self.c_v1[sub]]
        l2 = orientations[self.c_v2[sub]]
        ok = (self.c_o1[sub] == l1) & (self.c_o2[sub] == l2)
        return int(np.count_nonzero(~ok & (self.c_par[sub] != (l1 == l2))))


def _switch_edge_orientations(rows: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Edge::switch_edge_orientation (src/Edge.h:90-121) applied in place to
    the edges `ids`, all at once; returns the mask of those that changed
    direction (must be moved)."""
    r = rows[ids]
    pos1, pos2 = r["pos3"], r["pos4"]
    v1, v2 = r["v1"], r["v2"]
    moved = (pos1 < 0) | ((pos1 == 0) & (v1 > v2))
    neg2 = pos2 < 0
    rows["pos1"][ids] = np.where(moved, -pos1, pos1)
    rows["pos2"][ids] = np.where(neg2, -pos2, pos2)
    rows["pos3"][ids], rows["pos4"][ids] = r["pos1"], r["pos2"]
    ori1, ori2 = ~r["ori1"], ~r["ori2"]
    rows["ori1"][ids] = np.where(moved, ori2, ori1)
    rows["ori2"][ids] = np.where(moved, ori1, ori2)
    rows["v1"][ids] = np.where(moved, v2, v1)
    rows["v2"][ids] = np.where(moved, v1, v2)
    # ord as the reference's four branches set it
    rows["ord"][ids] = np.where(
        neg2, np.where(moved, b"1", b"2"),
        np.where(r["ord"] == b"-", b"-", np.where(moved, b"2", b"1")))
    return moved


def _rebuild_adj(adj: List[List[int]], flat: np.ndarray, owner: np.ndarray,
                 gone: np.ndarray, new_ids: np.ndarray,
                 new_owner: np.ndarray) -> None:
    """Rewrite each list of `adj` that loses an edge marked in `gone` or
    gains one of `new_ids`, once: its surviving edges in their old order,
    then the gained ones in `new_ids` order, as per-edge list.remove and
    append calls would leave it. `flat`/`owner` hold every entry of `adj`
    (edge id, list it is in) in list order."""
    lost = gone[flat]
    touched = np.unique(np.concatenate([owner[lost], new_owner]))
    if len(touched) == 0:
        return
    hit = np.zeros(len(adj), dtype=bool)
    hit[touched] = True
    keep = hit[owner] & ~lost
    ids = np.concatenate([flat[keep], new_ids])
    own = np.concatenate([owner[keep], new_owner])
    flat_new = ids[np.argsort(own, kind="stable")].tolist()
    ends = np.cumsum(np.bincount(own, minlength=len(adj))[touched]).tolist()
    start = 0
    for v, end in zip(touched.tolist(), ends):
        adj[v] = flat_new[start:end]
        start = end


def vertex_labelling_heuristic(g: OverlapGraph,
                               stats: "dict | None" = None) -> int:
    """Try up to 100 BFS labellings, keep the one deleting fewest edges,
    then flip/move/delete edges to make every edge agree with the labels.
    Returns the number of conflicting edges removed; with `stats`, also
    records there how many edges were rewritten without a move
    (`label_flipped`) and with one (`label_moved`).

    Identical results to the reference's full-restart scheme
    (GraphAlgos.cpp:178-349) at a fraction of the cost: orientations are
    root-relative edge-parity products, so in a component with no parity-
    inconsistent cycle every BFS tree yields the SAME labelling (the root —
    the component's first vertex in indegree order — never depends on the
    shuffle, and the reference re-seeds srand per node, so per-component
    traversals are independent of each other). Deletions can only come from
    parity-inconsistent components; passes 2..100 therefore re-BFS only
    those components and score deletions on their edges alone."""
    ctx = _LabelCtx(g)
    n = g.n

    # pass 1: full BFS + component discovery
    orientations = np.ones(n, dtype=bool)
    visited = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    ctx.bfs(1, orientations, ctx.order, visited, comp)
    assert visited.all()
    to_flip, to_move, to_delete = ctx.classify(orientations)
    best_count = len(to_delete)
    best_seed = 1

    if best_count > 0:
        # conflicted components = those containing a parity-violating edge
        conf_comps = np.unique(comp[g.edges["v1"][to_delete].astype(np.int64)])
        conf_set = np.zeros(n, dtype=bool)
        conf_set[conf_comps] = True
        sub = np.flatnonzero(conf_set[comp[ctx.c_v1]])
        # comp[v] is the index into pass 1's start sequence (= ctx.order)
        # whose BFS discovered v, so order[ci] is that component's root
        roots = [ctx.order[int(ci)] for ci in conf_comps]

        count = 1
        scratch_vis = np.zeros(n, dtype=bool)
        while count < 100 and best_count > 0:
            count += 1
            trial_ori = orientations.copy()
            scratch_vis[:] = False
            ctx.bfs(count, trial_ori, roots, scratch_vis)
            trial_count = ctx.count_deletes(trial_ori, sub)
            if trial_count < best_count:
                best_count = trial_count
                best_seed = count

        if best_seed != 1:
            scratch_vis[:] = False
            ctx.bfs(best_seed, orientations, roots, scratch_vis)
            to_flip, to_move, to_delete = ctx.classify(orientations)

    rows = g.edges
    ids = np.concatenate([to_flip, to_move])
    moved = _switch_edge_orientations(rows, ids)
    nf = len(to_flip)
    assert not moved[:nf].any() and moved[nf:].all()
    if stats is not None:
        stats["label_flipped"] = nf
        stats["label_moved"] = len(to_move)
    if len(to_move) or len(to_delete):
        g.invalidate_adj_cache()
        gone = np.zeros(len(rows), dtype=bool)
        gone[to_move] = True
        gone[to_delete] = True
        _rebuild_adj(g.adj_out, ctx.e_scan, ctx.c_v1, gone, to_move,
                     rows["v1"][to_move].astype(np.int64))
        _rebuild_adj(g.adj_in, ctx.in_flat, ctx.in_dst, gone, to_move,
                     rows["v2"][to_move].astype(np.int64))
        g.alive[to_delete] = False
    g.vertex_orientations = orientations
    return len(to_delete)


# --------------------------------------------------------------------------
# Inclusion removal (GraphAlgos.cpp:20-48)
# --------------------------------------------------------------------------

def remove_inclusions(g: OverlapGraph) -> None:
    ids_to_remove: Set[int] = set()
    rows = g.edges
    for v in np.flatnonzero(g.inclusions):
        v = int(v)
        edge_vec: List[np.void] = []
        for e in g.adj_out[v]:
            ids_to_remove.add(e)
            edge_vec.append(rows[e].copy())
        for e in g.adj_in[v]:
            ids_to_remove.add(e)
            edge_vec.append(rows[e].copy())
        g.inclusion_edges.append(edge_vec)
    g.remove_edge_ids(ids_to_remove)


# --------------------------------------------------------------------------
# Transitive reduction (GraphAlgos.cpp:746-795, 938-1123)
# --------------------------------------------------------------------------

def _adj_to_csr(n: int, v1: np.ndarray, v2: np.ndarray):
    from scipy.sparse import csr_matrix

    data = np.ones(len(v1), dtype=np.int32)
    return csr_matrix((data, (v1, v2)), shape=(n, n), dtype=np.int32)


def find_transitive_mask(n: int, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """edge i is transitive iff some 2-path v1[i] -> w -> v2[i] exists.

    Native path: per-edge sorted out(u) x in(w) intersection with early
    exit (the reference's own formulation, src/GraphAlgos.cpp:746-776),
    OpenMP over edges. Fallback: scipy boolean A@A + pair extraction
    (identical output; HC_NATIVE_TRANS=0 forces it)."""
    if len(v1) == 0:
        return np.zeros(0, dtype=bool)
    import os

    if os.environ.get("HC_NATIVE_TRANS") != "0":
        from ..native import load_transitive_ext

        ext = load_transitive_ext()
        if ext is not None:
            order = np.lexsort((v2, v1))
            out_idx = v2[order]
            out_ptr = np.zeros(n + 1, np.int64)
            np.add.at(out_ptr, v1 + 1, 1)
            np.cumsum(out_ptr, out=out_ptr)
            iorder = np.lexsort((v1, v2))
            in_idx = v1[iorder]
            in_ptr = np.zeros(n + 1, np.int64)
            np.add.at(in_ptr, v2 + 1, 1)
            np.cumsum(in_ptr, out=in_ptr)
            return ext.transitive_mask(out_ptr, out_idx, in_ptr, in_idx,
                                       v1, v2)
    a = _adj_to_csr(n, v1, v2)
    a2 = (a @ a).tocsr()
    return np.asarray(a2[v1, v2]).ravel() > 0


def remove_transitive_edges(g: OverlapGraph) -> None:
    """Remove single/double/triple transitive edges per remove_trans, plus
    the 3-clique branch pruning used with branch_reduction."""
    s = g.s
    if s.remove_trans == 0:
        return
    g.sort_adj_out_by_target()
    g.rebuild_adj_in()
    rows = g.edges
    alive_idx = np.flatnonzero(g.alive)
    v1 = rows["v1"][alive_idx].astype(np.int64)
    v2 = rows["v2"][alive_idx].astype(np.int64)
    trans = find_transitive_mask(g.n, v1, v2)
    # iterate on the graph of transitive edges for double/triple
    for _ in range(1, s.remove_trans):
        tv1, tv2 = v1[trans], v2[trans]
        sub = find_transitive_mask(g.n, tv1, tv2)
        new_trans = np.zeros(len(v1), dtype=bool)
        new_trans[np.flatnonzero(trans)[sub]] = True
        trans = new_trans

    to_delete: Set[Tuple[int, int]] = set()
    if s.remove_trans == 1 and s.branch_reduction:
        # prune branches around each transitive edge (3-clique evidence);
        # vectorized: concatenate the transitive edges' out/in adjacency
        # once and mask shorter-overlap neighbours in flat passes (the set
        # union below is order-insensitive — consumers sort it)
        len0 = rows["len1"].astype(np.int64) + rows["len2"].astype(np.int64)
        t_edges = alive_idx[trans]
        if len(t_edges):
            t_n1 = rows["v1"][t_edges].astype(np.int64)
            t_n2 = rows["v2"][t_edges].astype(np.int64)
            t_ov = len0[t_edges]
            for side_nodes, adj, first in ((t_n1, g.adj_out, True),
                                           (t_n2, g.adj_in, False)):
                nbr_lists = [adj[int(n)] for n in side_nodes]
                cnt = np.fromiter((len(l) for l in nbr_lists), np.int64,
                                  count=len(nbr_lists))
                if not cnt.sum():
                    continue
                flat = np.fromiter(
                    (e for l in nbr_lists for e in l), np.int64,
                    count=int(cnt.sum()))
                ovs = np.repeat(t_ov, cnt)
                keep = len0[flat] <= ovs
                if first:
                    a = np.repeat(side_nodes, cnt)[keep]
                    b = rows["v2"][flat[keep]].astype(np.int64)
                else:
                    a = rows["v1"][flat[keep]].astype(np.int64)
                    b = np.repeat(side_nodes, cnt)[keep]
                to_delete.update(zip(a.tolist(), b.tolist()))

    # match surviving branch-prune pairs to edge ids in one sorted lookup
    # ((v, w) keys are unique — check_no_duplicate_edges invariant), then
    # remove everything in one bulk pass; equivalent to the former
    # per-pair check_edge/remove_edge loop since key lookups are
    # order-independent
    del_ids = alive_idx[trans]
    if to_delete:
        rem_idx = alive_idx[~trans]
        rk = (v1[~trans] << 32) | v2[~trans]
        order = np.argsort(rk)
        rk_sorted = rk[order]
        pairs = np.asarray(sorted(to_delete), dtype=np.int64)
        pk = (pairs[:, 0] << 32) | pairs[:, 1]
        pos = np.searchsorted(rk_sorted, pk)
        posc = np.minimum(pos, max(len(rk_sorted) - 1, 0))
        found = (pos < len(rk_sorted)) & (rk_sorted[posc] == pk) \
            if len(rk_sorted) else np.zeros(len(pk), dtype=bool)
        del_ids = np.concatenate([del_ids, rem_idx[order[posc[found]]]])
    g.remove_edge_ids(del_ids)


# --------------------------------------------------------------------------
# Tip removal (GraphAlgos.cpp:543-637) and Edge::ext_len (src/Edge.h:220-275)
# --------------------------------------------------------------------------

def edge_ext_len(g: OverlapGraph, e: int, forward: bool) -> int:
    rows = g.edges
    r = rows[e]
    store = g.store
    i1, i2 = int(r["v1"]), int(r["v2"])
    p1, p2 = store.is_paired[i1], store.is_paired[i2]
    len1, len2 = int(r["len1"]), int(r["len2"])
    overlap_len = len1 + len2
    pos1, pos2 = int(r["pos1"]), int(r["pos2"])
    ordc = r["ord"]
    if forward:
        if (p1 and p2 and ordc == b"1") or (not p1 and not p2):
            return max(store.read_len(i2) - overlap_len, 0)
        if p1 and p2:  # ord == '2'
            u1, u2 = store.units_of(i2)
            if bool(r["ori2"]):
                rl1, rl2 = store.unit_len(u1), store.unit_len(u2)
            else:
                rl1, rl2 = store.unit_len(u2), store.unit_len(u1)
            return max(rl1 - len1, 0) + max(rl2 - pos2 - len2, 0)
        if not p1 and p2:  # S-P
            u1, u2 = store.units_of(i2)
            if bool(r["ori2"]):
                rl1, rl2 = store.unit_len(u1), store.unit_len(u2)
            else:
                rl1, rl2 = store.unit_len(u2), store.unit_len(u1)
            return max(max(rl1 - len1, 0), max(rl2 - len2, 0))
        # P-S
        return max(store.read_len(i2) - pos2 - len2, 0)
    else:
        if p1 and p2 and ordc == b"1":
            return pos1
        return pos1 + pos2


def remove_tips(g: OverlapGraph) -> None:
    rows = g.edges
    max_tip_len = g.s.max_tip_len
    edges_to_remove: Set[Tuple[int, int]] = set()
    tip_reads: Set[int] = set()
    # outgoing tips
    for i in range(g.n):
        adj = g.adj_out[i]
        if len(adj) <= 1:
            continue
        alltips = True
        local: List[Tuple[int, int]] = []
        local_reads: List[int] = []
        for e in adj:
            v1 = int(rows["v2"][e])
            if len(g.adj_out[v1]) == 0:
                ext = edge_ext_len(g, e, forward=True)
                if ext == 0:  # inclusion edge: always a tip
                    edges_to_remove.add((i, v1))
                    tip_reads.add(v1)
                elif ext < max_tip_len:
                    local.append((i, v1))
                    local_reads.append(v1)
            else:
                alltips = False
        if not alltips:
            edges_to_remove.update(local)
            tip_reads.update(local_reads)
    # incoming tips
    for i in range(g.n):
        adj = g.adj_in[i]
        if len(adj) <= 1:
            continue
        alltips = True
        local = []
        local_reads = []
        for e in adj:
            v1 = int(rows["v1"][e])
            if len(g.adj_in[v1]) == 0:
                ext = edge_ext_len(g, e, forward=False)
                if ext == 0:
                    edges_to_remove.add((v1, i))
                    tip_reads.add(v1)
                elif ext < max_tip_len:
                    local.append((v1, i))
                    local_reads.append(v1)
            else:
                alltips = False
        if not alltips:
            edges_to_remove.update(local)
            tip_reads.update(local_reads)
    for v, w in sorted(edges_to_remove):
        edge = g.remove_edge(v, w)
        g.branching_edges.append(edge)
    g.tip_vertices |= tip_reads


# --------------------------------------------------------------------------
# Cycle removal (GraphAlgos.cpp:352-541)
# --------------------------------------------------------------------------

def _sorted_out_neighbors(g: OverlapGraph, node: int, randomize: int) -> List[int]:
    rows = g.edges
    adj = g.adj_out[node]
    if randomize == 1:  # by increasing pos1, tie by vertex
        pairs = sorted(((int(rows["v2"][e]), int(rows["pos1"][e])) for e in adj),
                       key=lambda t: (t[1], t[0]))
        return [v for v, _ in pairs]
    if randomize == 2:  # by decreasing score
        pairs = sorted(((int(rows["v2"][e]), float(rows["score"][e])) for e in adj),
                       key=lambda t: (-t[1], t[0]))
        return [v for v, _ in pairs]
    if randomize == 3:  # by decreasing overlap length
        pairs = sorted(((int(rows["v2"][e]), int(rows["len1"][e]) + int(rows["len2"][e])) for e in adj),
                       key=lambda t: (-t[1], t[0]))
        return [v for v, _ in pairs]
    if randomize == 4:  # by increasing mismatch rate
        pairs = sorted(((int(rows["v2"][e]), float(rows["mismatch_rate"][e])) for e in adj),
                       key=lambda t: (t[1], t[0]))
        return [v for v, _ in pairs]
    neighbors = [int(rows["v2"][e]) for e in adj]
    return shuffle_fresh_seed(neighbors, randomize)


def find_cycles(g: OverlapGraph, randomize: int) -> Set[Tuple[int, int]]:
    """Iterative DFS reproducing the reference's recursive dfs_helper."""
    visited = np.zeros(g.n, dtype=bool)
    marked = np.zeros(g.n, dtype=bool)
    backedges: Set[Tuple[int, int]] = set()
    order = sort_vertices_by_indegree(g)
    for root in order:
        root = int(root)
        if visited[root]:
            continue
        # stack of (parent, node, neighbor-iterator state)
        stack: List[Tuple[int, int, List[int], int]] = [(g.n, root, [], -1)]
        while stack:
            parent, node, neighbors, ptr = stack.pop()
            if ptr == -1:  # first visit of this frame
                if marked[node]:
                    backedges.add((parent, node))
                    continue
                if visited[node]:
                    continue
                marked[node] = True
                neighbors = _sorted_out_neighbors(g, node, randomize)
                ptr = 0
            if ptr < len(neighbors):
                stack.append((parent, node, neighbors, ptr + 1))
                stack.append((node, neighbors[ptr], [], -1))
            else:
                marked[node] = False
                visited[node] = True
    return backedges


def cycle_removal_heuristic(g: OverlapGraph, remove_edges: bool) -> Set[Tuple[int, int]]:
    best = find_cycles(g, 1)
    count = 1
    while count < 20 and len(best) > 0:
        count += 1
        cur = find_cycles(g, count)
        if len(cur) < len(best):
            best = cur
    g.backedge_count = len(best)
    if remove_edges:
        for u, v in sorted(best):
            edge = g.remove_edge(u, v)
            g.branching_edges.append(edge)
    return best


# --------------------------------------------------------------------------
# Branch removal by connected components (GraphAlgos.cpp:714-744, 835-936)
# --------------------------------------------------------------------------

def remove_branches(g: OverlapGraph) -> None:
    rows = g.edges
    alive_idx = np.flatnonzero(g.alive)
    v1 = rows["v1"][alive_idx].astype(np.int64)
    v2 = rows["v2"][alive_idx].astype(np.int64)
    trans = find_transitive_mask(g.n, v1, v2)
    keep = ~trans
    kv1, kv2 = v1[keep], v2[keep]
    # drop all edges out of branching (out-degree>1) and into branching
    # (in-degree>1) vertices of the reduced graph
    out_deg = np.bincount(kv1, minlength=g.n)
    in_deg = np.bincount(kv2, minlength=g.n)
    ok = (out_deg[kv1] <= 1) & (in_deg[kv2] <= 1)
    bv1, bv2 = kv1[ok], kv2[ok]
    # connected components of the branch-free graph (undirected)
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    a = csr_matrix((np.ones(len(bv1)), (bv1, bv2)), shape=(g.n, g.n))
    _, comp = connected_components(a, directed=False)
    # remove all original edges crossing components (bulk; branching_edges
    # keeps the ascending-edge-id order of the former per-edge loop)
    cross_ids = alive_idx[comp[v1] != comp[v2]]
    g.branching_edges.extend(rows[e].copy() for e in cross_ids)
    g.remove_edge_ids(cross_ids)


def reduce_diploid_branching(g: OverlapGraph) -> None:
    """GraphAlgos.cpp:50-110 (not called by the reference main; kept for
    API parity)."""
    rows = g.edges
    min_diploid_overlap = 30
    unique_out = {}
    for v in range(g.n):
        adj = g.adj_out[v]
        if len(adj) == 1:
            e = adj[0]
            if (int(rows["len1"][e]) + int(rows["len2"][e])) >= min_diploid_overlap \
                    and float(rows["mismatch_rate"][e]) < 1e-6:
                unique_out[v] = int(rows["v2"][e])
    unique_in = {}
    for v in range(g.n):
        if len(g.adj_in[v]) == 1:
            unique_in[v] = int(rows["v1"][g.adj_in[v][0]])
    to_delete: Set[Tuple[int, int]] = set()
    for v, w in unique_out.items():
        for e in g.adj_in[w]:
            inn = int(rows["v1"][e])
            if unique_out.get(inn) != w:
                to_delete.add((inn, w))
    for w, inn in unique_in.items():
        for e in g.adj_out[inn]:
            out = int(rows["v2"][e])
            if unique_in.get(out) != inn:
                to_delete.add((inn, out))
    for v, w in sorted(to_delete):
        g.remove_edge(v, w)


def get_edges_for_merging(g: OverlapGraph) -> List[Tuple[int, int]]:
    """Greedy node-disjoint edge selection (GraphAlgos.cpp:112-148)."""
    rows = g.edges
    used = np.zeros(g.n, dtype=bool)
    pairs: List[Tuple[int, int]] = []
    for node in range(g.n):
        if used[node] or not g.adj_out[node]:
            continue
        for e in g.adj_out[node]:
            nb = int(rows["v2"][e])
            if not used[nb]:
                pairs.append((node, nb))
                used[node] = True
                used[nb] = True
                break
    return pairs
