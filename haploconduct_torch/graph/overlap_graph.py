"""The overlap graph: vertices = reads, directed edges = suffix-prefix
overlaps that passed verification.

Rebuild of the reference's OverlapGraph (src/OverlapGraph.{h,cpp}) with a
different layout: edges live in one structured NumPy array (EDGE_DTYPE from
ops/verify.py) with an alive mask, and adjacency lists hold edge indices.
List-order semantics (push-back on add, first-match erase on remove, the
sortEdges ordering) are preserved because downstream heuristics iterate
adjacency in order.

Candidate insertion replaces the reference's sequential insert-or-replace
loop (src/EdgeCalculator.cpp:427-539) with a vectorized winner-per-group
selection: the reference's 7-level deterministic tie-break defines a total
order on candidate edges, so the surviving edge of each (vertex pair,
orientation-parity) group is simply the maximum under that order —
independent of insertion order, which also removes the reference's
thread-arrival nondeterminism.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore
from ..ops.verify import EDGE_DTYPE
from ..utils.config import Settings


def _f64_order_key(arr: np.ndarray) -> np.ndarray:
    """uint64 keys whose unsigned order equals the float64 value order
    (IEEE total-order transform: flip the sign bit for non-negatives, all
    bits for negatives). Lets float tie-break keys ride a packed lexsort."""
    u = np.ascontiguousarray(arr, dtype=np.float64).view(np.uint64)
    mask = np.where(u >> np.uint64(63),
                    np.uint64(0xFFFFFFFFFFFFFFFF),
                    np.uint64(0x8000000000000000))
    return u ^ mask


def edge_sort_winners(cand: np.ndarray) -> np.ndarray:
    """Return indices of the winning candidate per duplicate group.

    Group key: (unordered vertex pair, ori-parity). Winner = lexicographic
    max of (score desc, total overlap len desc, mismatch_rate asc,
    v1 asc, ori1=True first, ori2=True first, pos1 asc, pos2 asc)
    mirroring src/EdgeCalculator.cpp:470-520.

    The 11 logical keys are packed into 6 lexsort keys (ints share words;
    floats use the order-preserving bit transform) — the raw 11-key
    lexsort was ~6s per 44k-read envelope patch.
    """
    if len(cand) == 0:
        return np.zeros(0, dtype=np.int64)
    vmin = np.minimum(cand["v1"], cand["v2"]).astype(np.int64)
    vmax = np.maximum(cand["v1"], cand["v2"]).astype(np.int64)
    assert vmax.max() < (1 << 31), "packed keys require node ids < 2^31"
    parity = cand["ori1"] == cand["ori2"]
    len0 = cand["len1"].astype(np.int64) + cand["len2"].astype(np.int64)
    group = (vmin << 32) | (vmax << 1) | parity
    score_key = ~_f64_order_key(cand["score"])  # desc
    mism_key = _f64_order_key(cand["mismatch_rate"])  # asc
    # v1 asc, then ori1/ori2 True-first: 31+1+1 bits
    vo = ((cand["v1"].astype(np.int64) << 2)
          | ((~cand["ori1"]).astype(np.int64) << 1)
          | (~cand["ori2"]).astype(np.int64))
    # pos1 asc then pos2 asc: pos1 < 2^31 and |pos2| < 2^31, so the sum
    # orders identically to the (pos1, pos2) pair
    pos_key = ((cand["pos1"].astype(np.int64) << 32)
               + cand["pos2"].astype(np.int64))
    # np.lexsort: last key is primary. Winner FIRST in its group.
    order = np.lexsort((pos_key, vo, mism_key, -len0, score_key, group))
    g_sorted = group[order]
    first_of_group = np.ones(len(order), dtype=bool)
    first_of_group[1:] = g_sorted[1:] != g_sorted[:-1]
    return order[first_of_group]


def canonicalize_candidates(cand: np.ndarray) -> np.ndarray:
    """Direct pos1==0 edges from small to large vertex id (swap_reads,
    src/EdgeCalculator.cpp:443-448 + src/Edge.h:74-88). Returns a copy."""
    cand = cand.copy()
    swap = (cand["pos1"] == 0) & (cand["v1"] > cand["v2"])
    if np.any(swap):
        sw = cand[swap]
        v1, v2 = sw["v2"].copy(), sw["v1"].copy()
        o1, o2 = sw["ori2"].copy(), sw["ori1"].copy()
        sw["v1"], sw["v2"] = v1, v2
        sw["ori1"], sw["ori2"] = o1, o2
        ordv = sw["ord"].copy()
        sw["ord"] = np.where(ordv == b"1", b"2", np.where(ordv == b"2", b"1", ordv))
        sw["pos3"] = -sw["pos3"]
        sw["pos4"] = -sw["pos4"]
        cand[swap] = sw
    return cand


class OverlapGraph:
    def __init__(self, n_vertices: int, store: ReadStore, settings: Settings):
        self.n = int(n_vertices)
        self.store = store
        self.s = settings
        self.edges = np.zeros(0, dtype=EDGE_DTYPE)
        self.alive = np.zeros(0, dtype=bool)
        self.adj_out: List[List[int]] = [[] for _ in range(self.n)]
        self.adj_in: List[List[int]] = [[] for _ in range(self.n)]
        self.inclusions = np.zeros(self.n, dtype=bool)
        self.vertex_orientations = np.ones(self.n, dtype=bool)
        self.branching_edges: List[np.void] = []  # removed edges FNO1 revisits
        self.inclusion_edges: List[List[np.void]] = []  # per inclusion vertex
        self.backedge_count = 0
        self.dup_count = 0
        self.inclusion_count = 0
        self.tip_vertices: set = set()
        # flat adj_out cache: (edge ids, owning vertex) in list order, valid
        # while _adj_version is unchanged. Every phase flattens adjacency
        # (labelling ctx, transitive CSR, sorts, bulk removals); at 44k-read
        # patch scale the repeated np.fromiter over lists-of-lists was
        # ~13s/stage of pure re-flattening.
        self._adj_version = 0
        self._flat_cache = None

    # ------------------------------------------------------------- basics
    @property
    def edge_count(self) -> int:
        return int(np.count_nonzero(self.alive))

    def alive_edges(self) -> np.ndarray:
        return self.edges[self.alive]

    def out_edges(self, v: int) -> List[int]:
        return self.adj_out[v]

    def in_neighbors(self, v: int) -> List[int]:
        return [int(self.edges["v1"][e]) for e in self.adj_in[v]]

    def _append_edges(self, rows: np.ndarray) -> np.ndarray:
        self.invalidate_adj_cache()
        start = len(self.edges)
        self.edges = np.concatenate([self.edges, rows]) if start else rows.copy()
        self.alive = np.concatenate([self.alive, np.ones(len(rows), dtype=bool)])
        idx = np.arange(start, start + len(rows))
        if len(rows) <= 8:
            for i, r in zip(idx, rows):
                self.adj_out[int(r["v1"])].append(int(i))
                self.adj_in[int(r["v2"])].append(int(i))
            return idx
        # bulk: group new edge ids by endpoint (stable => input order kept)
        for col, adj in (("v1", self.adj_out), ("v2", self.adj_in)):
            vv = rows[col].astype(np.int64)
            order = np.argsort(vv, kind="stable")
            sv = vv[order]
            cuts = np.flatnonzero(np.diff(sv)) + 1
            for grp, ids in zip(sv[np.concatenate([[0], cuts])] if len(sv) else [],
                                np.split(idx[order], cuts)):
                adj[int(grp)].extend(ids.tolist())
        return idx

    def add_edge(self, row: np.void) -> int:
        return int(self._append_edges(np.array([row], dtype=EDGE_DTYPE))[0])

    def remove_edge(self, v: int, w: int, parity: Optional[bool] = None) -> np.void:
        """Remove first v->w edge (optionally matching ori-parity); returns
        a copy of the removed edge row (removeEdge / removeEdgeWithOri)."""
        for e in self.adj_out[v]:
            if int(self.edges["v2"][e]) == w:
                if parity is not None:
                    if bool(self.edges["ori1"][e] == self.edges["ori2"][e]) != parity:
                        continue
                self.invalidate_adj_cache()
                self.adj_out[v].remove(e)
                self.adj_in[w].remove(e)
                self.alive[e] = False
                return self.edges[e].copy()
        raise KeyError(f"edge to be removed not found: {v} -> {w}")

    def remove_edge_ids(self, ids) -> None:
        """Bulk-remove edges by id; touched adjacency lists are filtered
        once (preserving order) instead of per-edge list.remove scans.

        Large removals (transitive reduction can kill most of the graph —
        the reference has a >50%-edges rebuild fast path for exactly this,
        src/GraphAlgos.cpp:995-1062) rebuild BOTH adjacency structures from
        flat arrays: flatten in list order, mask by alive, regroup — order-
        preserving and free of per-entry Python set probes."""
        arr = np.unique(np.asarray(
            ids if not isinstance(ids, set) else list(ids), dtype=np.int64))
        if len(arr) == 0:
            return
        if 4 * len(arr) > self.edge_count:
            # flat adj_out (possibly cached) first, then mark dead
            out_flat, out_v = self._flat_adj_out()
            self.alive[arr] = False
            n = self.n
            from itertools import chain

            keep = self.alive[out_flat]
            kept, kept_v = out_flat[keep], out_v[keep]
            cuts = np.cumsum(np.bincount(kept_v, minlength=n))[:-1]
            self.adj_out = [lst.tolist() for lst in np.split(kept, cuts)]
            self._set_flat_cache(kept, kept_v)

            in_counts = np.fromiter(map(len, self.adj_in), np.int64, count=n)
            in_flat = np.fromiter(chain.from_iterable(self.adj_in),
                                  np.int64, count=int(in_counts.sum()))
            ikeep = self.alive[in_flat]
            iv_of = np.repeat(np.arange(n, dtype=np.int64), in_counts)[ikeep]
            icuts = np.cumsum(np.bincount(iv_of, minlength=n))[:-1]
            self.adj_in = [lst.tolist()
                           for lst in np.split(in_flat[ikeep], icuts)]
            return
        self.invalidate_adj_cache()
        id_set = set(arr.tolist())
        touched_out = np.unique(self.edges["v1"][arr])
        touched_in = np.unique(self.edges["v2"][arr])
        self.alive[arr] = False
        for v in touched_out:
            self.adj_out[int(v)] = [e for e in self.adj_out[int(v)] if e not in id_set]
        for w in touched_in:
            self.adj_in[int(w)] = [e for e in self.adj_in[int(w)] if e not in id_set]

    def remove_edges_bulk(self, pairs, collect_branching: bool = False) -> None:
        """Remove a set of (v, w) edges; order-insensitive."""
        rows = self.edges
        ids: List[int] = []
        used: set = set()
        for v, w in pairs:
            v, w = int(v), int(w)
            e_found = -1
            for e in self.adj_out[v]:
                if e not in used and int(rows["v2"][e]) == w:
                    e_found = e
                    break
            if e_found < 0:
                raise KeyError(f"edge to be removed not found: {v} -> {w}")
            used.add(e_found)
            ids.append(e_found)
        if collect_branching:
            self.branching_edges.extend(rows[e].copy() for e in ids)
        self.remove_edge_ids(ids)

    def check_edge(self, v: int, w: int, reverse_allowed: bool = True) -> float:
        """Score of edge v->w (or w->v if allowed), else -1 (checkEdge)."""
        for e in self.adj_out[v]:
            if int(self.edges["v2"][e]) == w:
                return float(self.edges["score"][e])
        if reverse_allowed:
            for e in self.adj_out[w]:
                if int(self.edges["v2"][e]) == v:
                    return float(self.edges["score"][e])
        return -1.0

    def get_edge_idx(self, v: int, w: int, reverse_allowed: bool = True) -> int:
        for e in self.adj_out[v]:
            if int(self.edges["v2"][e]) == w:
                return e
        if reverse_allowed:
            for e in self.adj_out[w]:
                if int(self.edges["v2"][e]) == v:
                    return e
        raise KeyError(f"edge not found: {v} {w}")

    # -------------------------------------------------- candidate insertion
    def insert_candidates(self, cand: np.ndarray) -> None:
        """Bulk-insert verified edge candidates with dedup + tie-break.

        Replaces src/EdgeCalculator.cpp:427-539. Also performs inclusion
        marking for ignore_inclusions mode: determined from the FIRST
        candidate of each duplicate group in input order (the reference's
        single-thread behavior), not from the group winner.
        """
        if len(cand) == 0:
            return
        cand = canonicalize_candidates(cand)
        self.inclusion_count += int(np.count_nonzero(cand["perc"] == 100))
        winners = np.sort(edge_sort_winners(cand))
        self.dup_count += len(cand) - len(winners)

        if self.s.ignore_inclusions:
            # first candidate per group in input order decides marking.
            # Packed keys here (and in fno.py / check_no_duplicate_edges)
            # assume node ids < 2^31 so vmax<<1 cannot spill into the vmin
            # field; largest real workloads are ~10^6 vertices.
            vmin = np.minimum(cand["v1"], cand["v2"]).astype(np.int64)
            vmax = np.maximum(cand["v1"], cand["v2"]).astype(np.int64)
            assert len(vmax) == 0 or vmax.max() < (1 << 31), \
                "packed dedup keys require node ids < 2^31"
            parity = (cand["ori1"] == cand["ori2"]).astype(np.int64)
            keys = (vmin << 32) | (vmax << 1) | parity
            _, first_idx = np.unique(keys, return_index=True)
            f = cand[np.sort(first_idx)]
            mark = (f["perc"] == 100) & (f["mismatch_rate"] < 1e-6) & (f["mismatch_rate"] >= 0)
            mark_v1 = mark & (f["pos3"] < 0) & (f["pos1"] == 0)
            mark_v2 = mark & (f["pos3"] >= 0)
            self.inclusions[f["v1"][mark_v1]] = True
            self.inclusions[f["v2"][mark_v2]] = True

        self._append_edges(cand[winners])

    # -------------------------------------------------------------- sorting
    def nonoverlap_len(self, rows: np.ndarray) -> np.ndarray:
        """len(read1) + len(read2) - 2*overlap_len (Edge::get_nonoverlap_len)."""
        read_lens = np.array([self.store.read_len(i) for i in range(len(self.store))], dtype=np.int64)
        l1 = read_lens[rows["v1"]]
        l2 = read_lens[rows["v2"]]
        return l1 + l2 - 2 * (rows["len1"].astype(np.int64) + rows["len2"].astype(np.int64))

    def sort_edges(self) -> None:
        """Sort each adjacency list by (non-overlap length, v2) and rebuild
        adj_in in v1-major order (src/OverlapGraph.cpp:723-765).

        One flat lexsort over all alive edges: primary key = owning vertex,
        then (nol, v2), final tie key = current position in the list (the
        reference's std::list::sort is stable)."""
        rows = self.edges
        flat, v1_of = self._flat_adj_out()
        total = len(flat)
        if total == 0:
            self.adj_in = [[] for _ in range(self.n)]
            return
        counts = np.bincount(v1_of, minlength=self.n)
        pos_in = np.arange(total, dtype=np.int64)  # global, but per-v ascending
        read_lens = np.array([self.store.read_len(i) for i in range(len(self.store))], dtype=np.int64)
        v2_of = rows["v2"][flat].astype(np.int64)
        nol = (
            read_lens[rows["v1"][flat]] + read_lens[v2_of]
            - 2 * (rows["len1"][flat].astype(np.int64) + rows["len2"][flat].astype(np.int64))
        )
        order = np.lexsort((pos_in, v2_of, nol, v1_of))
        flat_sorted = flat[order]
        cuts = np.cumsum(counts)[:-1]
        self.adj_out = [ids.tolist() for ids in np.split(flat_sorted, cuts)]
        self._set_flat_cache(flat_sorted, v1_of[order])
        # adj_in[w] in v1-major traversal order of the new adj_out
        v2_sorted = v2_of[order]
        in_order = np.lexsort((np.arange(total, dtype=np.int64), v2_sorted))
        in_counts = np.bincount(v2_sorted, minlength=self.n)
        in_cuts = np.cumsum(in_counts)[:-1]
        self.adj_in = [ids.tolist() for ids in np.split(flat_sorted[in_order], in_cuts)]

    def invalidate_adj_cache(self) -> None:
        """Must be called after any DIRECT mutation of adj_out lists that
        bypasses the graph's own methods (graph/algos.py edge moves)."""
        self._adj_version += 1
        self._flat_cache = None

    def _set_flat_cache(self, flat: np.ndarray, v_of: np.ndarray) -> None:
        self._adj_version += 1
        self._flat_cache = (self._adj_version, flat, v_of)

    def _flat_adj_out(self) -> Tuple[np.ndarray, np.ndarray]:
        """(edge ids, owning vertex) of every adj_out entry in list order;
        cached until the adjacency mutates."""
        c = self._flat_cache
        if c is not None and c[0] == self._adj_version:
            return c[1], c[2]
        from itertools import chain

        counts = np.fromiter(map(len, self.adj_out), dtype=np.int64,
                             count=self.n)
        total = int(counts.sum())
        flat = np.fromiter(chain.from_iterable(self.adj_out),
                           dtype=np.int64, count=total)
        v_of = np.repeat(np.arange(self.n, dtype=np.int64), counts)
        self._flat_cache = (self._adj_version, flat, v_of)
        return flat, v_of

    def sort_adj_out_by_target(self) -> None:
        """Sort adj_out lists by out-neighbor id (sortAdjOut) — one flat
        stable lexsort instead of a per-node key-callback sort."""
        flat, v_of = self._flat_adj_out()
        if len(flat) == 0:
            return
        v2_of = self.edges["v2"][flat].astype(np.int64)
        order = np.lexsort((np.arange(len(flat), dtype=np.int64), v2_of, v_of))
        flat_sorted = flat[order]
        cuts = np.cumsum(np.bincount(v_of, minlength=self.n))[:-1]
        self.adj_out = [ids.tolist() for ids in np.split(flat_sorted, cuts)]
        self._set_flat_cache(flat_sorted, v_of[order])

    def rebuild_adj_in(self) -> None:
        """adj_in[w] rebuilt in v1-major adj_out traversal order."""
        flat, v_of = self._flat_adj_out()
        if len(flat) == 0:
            self.adj_in = [[] for _ in range(self.n)]
            return
        v2_of = self.edges["v2"][flat].astype(np.int64)
        order = np.lexsort((np.arange(len(flat), dtype=np.int64), v2_of))
        cuts = np.cumsum(np.bincount(v2_of, minlength=self.n))[:-1]
        self.adj_in = [ids.tolist() for ids in np.split(flat[order], cuts)]

    # ------------------------------------------------------------- queries
    def out_degree(self) -> np.ndarray:
        return np.array([len(l) for l in self.adj_out], dtype=np.int64)

    def in_degree(self) -> np.ndarray:
        return np.array([len(l) for l in self.adj_in], dtype=np.int64)

    def edge_endpoints(self) -> Tuple[np.ndarray, np.ndarray]:
        e = self.alive_edges()
        return e["v1"].astype(np.int64), e["v2"].astype(np.int64)

    def graph_txt_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """The directed pair sequence of the reference's graph.txt
        (src/OverlapGraph.cpp:322-385): vertices in id order, out-edges in
        adjacency-list order, inclusion endpoints skipped, two-cycles
        written once (at the first endpoint encountered), and each kept
        edge emitted in both directions back-to-back. Feeds
        enumerate_cliques_ref, whose emission order depends on this exact
        line order."""
        rows = self.edges
        incl = self.inclusions
        us: List[int] = []
        vs: List[int] = []
        for i in range(self.n):
            if incl[i]:
                continue
            for e in self.adj_out[i]:
                j = int(rows["v2"][e])
                if incl[j]:
                    continue
                if j < i and self.check_edge(j, i, reverse_allowed=False) > 0:
                    continue
                us.append(i)
                vs.append(j)
                us.append(j)
                vs.append(i)
        return np.asarray(us, dtype=np.int64), np.asarray(vs, dtype=np.int64)

    def check_no_duplicate_edges(self) -> None:
        """Assert no two alive edges share (v1, v2) (checkDuplicateEdges)."""
        v1, v2 = self.edge_endpoints()
        if len(v1) == 0:
            return
        # packed 1-d keys: np.unique(..., axis=0) row-sorts through void
        # views and was an 8s/stage sweep at envelope patch scale
        key = (v1.astype(np.int64) << 32) | v2.astype(np.int64)
        uniq = np.unique(key)
        assert len(uniq) == len(key), "duplicate edges in overlap graph"
