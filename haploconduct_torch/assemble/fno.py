"""FindNextOverlaps: induce next-iteration overlaps.

FNO1 (src/FindNextOverlaps.cpp): map every current edge (plus removed
branching/tip edges, plus optionally nonedge overlaps, plus edges through
removed inclusion vertices) onto the superreads containing its endpoints.

FNO3 (src/FindNextOverlaps3.cpp): for every pair of superreads sharing an
ORIGINAL read, deduce the overlap purely from OriginalIndex offsets (used
in error-correction iterations where edges are too many).

Output overlaps use NEW read IDs; FNO1 output is the sorted set of overlap
lines (the reference writes an ordered std::set of strings), FNO3 output is
in candidate order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.reads import ReadStore
from ..graph.overlap_graph import OverlapGraph
from ..io.overlaps import OVERLAP_DTYPE, empty_overlaps
from ..utils.config import Settings
from .superreads import Superread, SuperreadBuilder


_F100 = np.float32(100)


def _perc_f32(ov: int, la: int, lb: Optional[int] = None) -> int:
    """floor(max(ov/float(la), ov/float(lb)) * 100) in FLOAT32 — exactly
    how the reference computes induced-overlap percentages
    (FindNextOverlaps.cpp:375,429,487,549; FindNextOverlaps3.cpp:226-361).
    The divisions AND the *100 product are single precision, which rounds
    differently from f64 near integer boundaries: 87/150*100 = 58.0 in
    f32 but 57.999... in f64. Latent until envelope-patch parity (44k
    reads) exposed perc 57-vs-58 diffs in induced overlaps."""
    ovf = np.float32(ov)
    m = ovf / np.float32(la)
    if lb is not None:
        m = max(m, ovf / np.float32(lb))
    return int(np.floor(m * _F100))


def _find_clique_index(sr: Superread, node: int, leftside: bool, second_occ: bool) -> int:
    si = sr.subread_map[node]
    if leftside and not second_occ:
        return si.index1 - si.startpos1
    return si.index2 - si.startpos2


def _compute_overlap_data(sr1, sr2, idx1l, idx1r, idx2l, idx2r,
                          edge_pos1, edge_pos2, edge_ord):
    """Port of SRBuilder::computeOverlapData (FindNextOverlaps.cpp:351-565).

    sr1/sr2 expose is_paired and seq lengths via (paired, l1, l2) tuples:
    for singles l1 is the sequence length and l2 is 0.
    Returns None on failure, else a dict of the overlap fields.
    """
    p1, a1, a2 = sr1
    p2, b1, b2 = sr2
    pos1, pos2 = edge_pos1, edge_pos2
    if not p1 and not p2:  # S-S
        new_pos1 = (pos1 + idx1l) - idx2l
        if new_pos1 < 0:
            ord1, new_pos1, ln = "2", -new_pos1, b1
        else:
            ord1, ln = "1", a1
        ov_len1 = min(ln - new_pos1, a1, b1)
        ov_len2 = 0
        perc = _perc_f32(ov_len1, a1, b1)
        if new_pos1 >= ln:
            return None
        return dict(pos1=new_pos1, pos2=0, ord1=ord1, ord2="-", type1="s", type2="s",
                    perc=perc, len1=ov_len1, len2=ov_len2)
    if p1 and not p2:  # P-S
        len_a, len_b = a1 + a2, b1
        new_pos1 = (pos1 + idx1l) - idx2l
        if new_pos1 < 0:
            ord1, new_pos1 = "2", -new_pos1
            if new_pos1 >= b1:
                return None
            ov_len1 = a1
        else:
            ord1 = "1"
            if new_pos1 >= a1:
                return None
            ov_len1 = a1 - new_pos1
        if edge_ord == b"1":
            new_pos2 = idx2r - (idx1r + pos2)
        else:
            new_pos2 = (pos2 + idx2r) - idx1r
        if new_pos2 >= b1 or new_pos2 < 0:
            return None
        ov_len2 = min(b1 - new_pos2, a2)
        total = ov_len1 + ov_len2
        perc = min(_perc_f32(total, len_a, len_b), 100)
        return dict(pos1=new_pos1, pos2=new_pos2, ord1=ord1, ord2="-", type1="p", type2="s",
                    perc=perc, len1=ov_len1, len2=ov_len2)
    if not p1 and p2:  # S-P
        len_a, len_b = a1, b1 + b2
        new_pos1 = pos1 + idx1l - idx2l
        if new_pos1 < 0:
            ord1, new_pos1 = "2", -new_pos1
            if new_pos1 >= b1:
                return None
            ov_len1 = b1 - new_pos1
        else:
            ord1 = "1"
            if new_pos1 >= a1:
                return None
            ov_len1 = b1
        if edge_ord == b"2":
            new_pos2 = idx1r - (pos2 + idx2r)
        else:
            new_pos2 = idx1r + pos2 - idx2r
        if new_pos2 >= a1 or new_pos2 < 0:
            return None
        ov_len2 = min(a1 - new_pos2, b2)
        total = ov_len1 + ov_len2
        perc = min(_perc_f32(total, len_a, len_b), 100)
        return dict(pos1=new_pos1, pos2=new_pos2, ord1=ord1, ord2="-", type1="s", type2="p",
                    perc=perc, len1=ov_len1, len2=ov_len2)
    # P-P
    new_pos1 = (pos1 + idx1l) - idx2l
    if new_pos1 < 0:
        ord1, new_pos1 = "2", -new_pos1
        if new_pos1 >= b1:
            return None
        ov_len1 = min(a1, b1 - new_pos1)
    else:
        ord1 = "1"
        if new_pos1 >= a1:
            return None
        ov_len1 = min(a1 - new_pos1, b1)
    if edge_ord == b"1":
        new_pos2 = (pos2 + idx1r) - idx2r
    else:
        new_pos2 = idx1r - (pos2 + idx2r)
    if new_pos2 < 0:
        ord2 = "2" if ord1 == "1" else "1"
        new_pos2 = -new_pos2
        if new_pos2 >= b2:
            return None
        ov_len2 = min(a2, b2 - new_pos2)
    else:
        ord2 = "1" if ord1 == "1" else "2"
        if new_pos2 >= a2:
            return None
        ov_len2 = min(a2 - new_pos2, b2)
    total = ov_len1 + ov_len2
    total_a, total_b = a1 + a2, b1 + b2
    perc = min(_perc_f32(total, total_a, total_b), 100)
    return dict(pos1=new_pos1, pos2=new_pos2, ord1=ord1, ord2=ord2, type1="p", type2="p",
                perc=perc, len1=ov_len1, len2=ov_len2)


def _sr_shape(sr: Superread) -> Tuple[bool, int, int]:
    return (sr.is_paired, len(sr.seq1), len(sr.seq2))


def _read_shape(store: ReadStore, idx: int) -> Tuple[bool, int, int]:
    u1, u2 = store.units_of(idx)
    if store.is_paired[idx]:
        return (True, store.unit_len(u1), store.unit_len(u2))
    return (False, store.unit_len(u1), 0)


class FNO1:
    """Edge-driven overlap induction (findNextOverlaps, FNO=1)."""

    def __init__(self, builder: SuperreadBuilder):
        self.b = builder
        self.g = builder.g
        self.store = builder.store
        self.s = builder.s
        # HC_FNO_BATCH=0 forces the scalar sweep (A/B oracle); read once —
        # the batch path is called once per 4M-pair chunk in hot loops
        self._force_scalar = os.environ.get("HC_FNO_BATCH") == "0"
        self.lines: Set[str] = set()
        self.found: Set[int] = set()  # packed (lo<<32|hi) pair keys
        self._tbl: Optional[dict] = None
        # non-edge overlaps reconsidered after the edge check, and those of
        # them that fell back to the scalar port (run_iteration's stats)
        self.nonedge_rows = 0
        self.nonedge_scalar = 0
        # node -> superreads containing it
        self.nodes_to_sr: Dict[int, List[Superread]] = {}
        for sr in builder.single_SR:
            for node in sr.sorted_clique1:
                self.nodes_to_sr.setdefault(node, []).append(sr)
        for sr in builder.paired_SR:
            for node in sr.sorted_clique1:
                self.nodes_to_sr.setdefault(node, []).append(sr)

    def _mark_found(self, id1: int, id2: int) -> bool:
        key = (min(id1, id2) << 32) | max(id1, id2)
        if key in self.found:
            return False
        self.found.add(key)
        return True

    def _emit(self, id_first, id_second, d, ori1, ori2) -> None:
        line = (f"{id_first}\t{id_second}\t{d['pos1']}\t{d['pos2']}\t{d['ord2']}\t"
                f"{ori1}\t{ori2}\t{d['perc']}\t0\t{d['len1']}\t{d['len2']}\t"
                f"{d['t1']}\t{d['t2']}")
        if not (self.s.no_inclusions and d["perc"] == 100):
            self.lines.add(line)

    def _update_overlap(self, erow: np.void) -> None:
        """Port of updateOverlap (FindNextOverlaps.cpp:25-327)."""
        g, store, s, b = self.g, self.store, self.s, self.b
        u, v = int(erow["v1"]), int(erow["v2"])
        score = float(erow["score"])
        if s.resolve_orientations and score == 0:
            ori1 = "+" if bool(erow["ori1"]) == bool(g.vertex_orientations[u]) else "-"
            ori2 = "+" if bool(erow["ori2"]) == bool(g.vertex_orientations[v]) else "-"
        else:
            ori1 = ori2 = "+"
        pos1, pos2 = int(erow["pos1"]), int(erow["pos2"])
        edge_ord = erow["ord"]
        r1_paired = store.is_paired[u]
        r2_paired = store.is_paired[v]

        if not b.visited[u] and not b.visited[v]:
            id1 = b.nodes_to_new_ids[u]
            id2 = b.nodes_to_new_ids[v]
            perc = int(erow["perc"])
            line = (f"{id1}\t{id2}\t{pos1}\t{pos2}\t{edge_ord.decode()}\t{ori1}\t{ori2}\t"
                    f"{perc}\t0\t{int(erow['len1'])}\t{int(erow['len2'])}\t"
                    f"{'p' if r1_paired else 's'}\t{'p' if r2_paired else 's'}")
            if not (s.no_inclusions and perc == 100):
                self.lines.add(line)
        elif not b.visited[u]:
            id1 = b.nodes_to_new_ids[u]
            for sr in self.nodes_to_sr.get(v, []):
                id2 = sr.read_id
                if not self._mark_found(id1, id2):
                    continue
                if sr.is_paired:
                    idx2l = _find_clique_index(sr, v, True, False)
                    idx2r = _find_clique_index(sr, v, False, False)
                elif r2_paired:
                    idx2l = _find_clique_index(sr, v, True, False)
                    idx2r = _find_clique_index(sr, v, True, True)
                else:
                    idx2l = idx2r = _find_clique_index(sr, v, True, False)
                d = _compute_overlap_data(_read_shape(store, u), _sr_shape(sr),
                                          0, 0, idx2l, idx2r, pos1, pos2, edge_ord)
                if d is None:
                    continue
                if d["ord1"] == "1":
                    d["t1"], d["t2"] = d["type1"], d["type2"]
                    self._emit(id1, id2, d, ori1, ori2)
                else:
                    d["t1"], d["t2"] = d["type2"], d["type1"]
                    self._emit(id2, id1, d, ori1, ori2)
        elif not b.visited[v]:
            id1 = b.nodes_to_new_ids[v]
            for sr in self.nodes_to_sr.get(u, []):
                id2 = sr.read_id
                if not self._mark_found(id1, id2):
                    continue
                if sr.is_paired:
                    idx1l = _find_clique_index(sr, u, True, False)
                    idx1r = _find_clique_index(sr, u, False, False)
                elif r1_paired:
                    idx1l = _find_clique_index(sr, u, True, False)
                    idx1r = _find_clique_index(sr, u, True, True)
                else:
                    idx1l = idx1r = _find_clique_index(sr, u, True, False)
                d = _compute_overlap_data(_sr_shape(sr), _read_shape(store, v),
                                          idx1l, idx1r, 0, 0, pos1, pos2, edge_ord)
                if d is None:
                    continue
                if d["ord1"] == "1":
                    d["t1"], d["t2"] = d["type1"], d["type2"]
                    self._emit(id2, id1, d, ori1, ori2)
                else:
                    d["t1"], d["t2"] = d["type2"], d["type1"]
                    self._emit(id1, id2, d, ori1, ori2)
        else:
            for sr1 in self.nodes_to_sr.get(u, []):
                id1 = sr1.read_id
                if sr1.is_paired:
                    idx1l = _find_clique_index(sr1, u, True, False)
                    idx1r = _find_clique_index(sr1, u, False, False)
                elif r1_paired:
                    idx1l = _find_clique_index(sr1, u, True, False)
                    idx1r = _find_clique_index(sr1, u, True, True)
                else:
                    idx1l = idx1r = _find_clique_index(sr1, u, True, False)
                for sr2 in self.nodes_to_sr.get(v, []):
                    id2 = sr2.read_id
                    if id1 == id2:
                        continue
                    if not self._mark_found(id1, id2):
                        continue
                    if sr2.is_paired:
                        idx2l = _find_clique_index(sr2, v, True, False)
                        idx2r = _find_clique_index(sr2, v, False, False)
                    elif r2_paired:
                        idx2l = _find_clique_index(sr2, v, True, False)
                        idx2r = _find_clique_index(sr2, v, True, True)
                    else:
                        idx2l = idx2r = _find_clique_index(sr2, v, True, False)
                    d = _compute_overlap_data(_sr_shape(sr1), _sr_shape(sr2),
                                              idx1l, idx1r, idx2l, idx2r,
                                              pos1, pos2, edge_ord)
                    if d is None:
                        continue
                    if d["ord1"] == "1":
                        d["t1"], d["t2"] = d["type1"], d["type2"]
                        self._emit(id1, id2, d, ori1, ori2)
                    else:
                        d["t1"], d["t2"] = d["type2"], d["type1"]
                        self._emit(id2, id1, d, ori1, ori2)

    # ------------------------------------------------------- batched path
    #
    # updateOverlap is data-parallel over edge rows: the reference runs it
    # under OpenMP with per-thread dedup sets (FindNextOverlaps.cpp:568-601).
    # Here the all-single cases (the dominant population once contigs merge
    # — 94% of 4.9M calls in the envelope-scale stage b were
    # both-endpoints-in-superreads S-S) are computed as flat numpy batches;
    # rows touching paired reads/superreads fall back to the scalar port,
    # processed in row order so the first-wins dedup (`found`) semantics
    # are bit-identical. HC_FNO_BATCH=0 forces the scalar path (A/B oracle).

    def _ensure_tables(self) -> dict:
        if self._tbl is not None:
            return self._tbl
        g, b, store = self.g, self.b, self.store
        n = g.n
        counts = np.zeros(n + 1, np.int64)
        for node, srs in self.nodes_to_sr.items():
            counts[node + 1] = len(srs)
        ptr = np.cumsum(counts)
        total = int(ptr[-1])
        gid = np.zeros(max(total, 1), np.int64)
        gil = np.zeros(max(total, 1), np.int64)
        gl1 = np.ones(max(total, 1), np.int64)
        any_paired = np.zeros(n, bool)
        for node, srs in self.nodes_to_sr.items():
            o = int(ptr[node])
            for j, sr in enumerate(srs):
                si = sr.subread_map[node]
                gid[o + j] = sr.read_id
                gil[o + j] = si.index1 - si.startpos1
                gl1[o + j] = len(sr.seq1)
                if sr.is_paired:
                    any_paired[node] = True
        new_ids = np.full(n, -1, np.int64)
        for node, nid in b.nodes_to_new_ids.items():
            if node < n:
                new_ids[node] = nid
        rlen = np.fromiter(
            (store.unit_len(store.units_of(i)[0]) for i in range(n)),
            np.int64, count=n)
        self._tbl = dict(
            ptr=ptr, id=gid, il=gil, l1=gl1, any_paired=any_paired,
            new_ids=new_ids, read_len=rlen,
            is_paired=np.asarray(store.is_paired[:n], dtype=bool),
            vo=np.asarray(g.vertex_orientations, dtype=bool)
            if self.s.resolve_orientations else np.zeros(n, bool),
        )
        return self._tbl

    def _update_overlaps_batch(self, rows: np.ndarray) -> int:
        """Apply updateOverlap to every row, in row order; returns how
        many rows went through the scalar port."""
        if len(rows) == 0:
            return 0
        if self._force_scalar:
            for erow in rows:
                self._update_overlap(erow)
            return len(rows)
        T = self._ensure_tables()
        b = self.b
        v1 = rows["v1"].astype(np.int64)
        v2 = rows["v2"].astype(np.int64)
        vis1 = b.visited[v1]
        vis2 = b.visited[v2]
        isp, anyP = T["is_paired"], T["any_paired"]
        fb = ((~vis1 & vis2) & (isp[v1] | anyP[v2])
              | (vis1 & ~vis2) & (anyP[v1] | isp[v2])
              | (vis1 & vis2) & (anyP[v1] | anyP[v2]))
        if not fb.any():
            self._vector_run(rows)
            return 0
        # scalar-fallback rows interleave in row order to keep `found`
        # first-wins marks identical to the pure scalar sweep
        start = 0
        for f in np.flatnonzero(fb):
            f = int(f)
            if f > start:
                self._vector_run(rows[start:f])
            self._update_overlap(rows[f])
            start = f + 1
        if start < len(rows):
            self._vector_run(rows[start:])
        return int(np.count_nonzero(fb))

    def _vector_run(self, rows: np.ndarray) -> None:
        """All-single batch: every visited endpoint's superreads are
        single-end and every unvisited endpoint is a single-end read, so
        every induced overlap is the S-S case of computeOverlapData
        (FindNextOverlaps.cpp:371-398)."""
        s, b, store = self.s, self.b, self.store
        T = self._tbl
        R = len(rows)
        v1 = rows["v1"].astype(np.int64)
        v2 = rows["v2"].astype(np.int64)
        vis1 = b.visited[v1]
        vis2 = b.visited[v2]
        pos1 = rows["pos1"].astype(np.int64)
        if s.resolve_orientations:
            zm = rows["score"] == 0.0
            vo = T["vo"]
            o1 = np.where(zm, rows["ori1"] == vo[v1], True)
            o2 = np.where(zm, rows["ori2"] == vo[v2], True)
        else:
            o1 = np.ones(R, bool)
            o2 = np.ones(R, bool)

        add = self.lines.add
        nn = ~vis1 & ~vis2
        if nn.any():
            idx = np.flatnonzero(nn)
            newid = T["new_ids"]
            isp = T["is_paired"]
            id1 = newid[v1[idx]]
            id2 = newid[v2[idx]]
            percs = rows["perc"][idx]
            keep = (percs != 100) if s.no_inclusions else np.ones(len(idx), bool)
            for (i1v, i2v, p1v, p2v, ov, av, bv, pv, l1v, l2v,
                 pp1, pp2, kp) in zip(
                    id1.tolist(), id2.tolist(), pos1[idx].tolist(),
                    rows["pos2"][idx].tolist(), rows["ord"][idx],
                    o1[idx].tolist(), o2[idx].tolist(), percs.tolist(),
                    rows["len1"][idx].tolist(), rows["len2"][idx].tolist(),
                    isp[v1[idx]].tolist(), isp[v2[idx]].tolist(),
                    keep.tolist()):
                if kp:
                    add(f"{i1v}\t{i2v}\t{p1v}\t{p2v}\t{ov.decode()}\t"
                        f"{'+' if av else '-'}\t{'+' if bv else '-'}\t{pv}\t0\t"
                        f"{l1v}\t{l2v}\t{'p' if pp1 else 's'}\t{'p' if pp2 else 's'}")

        mv = np.flatnonzero(~nn)
        if len(mv) == 0:
            return
        ptr, gid, gil, gl1 = T["ptr"], T["id"], T["il"], T["l1"]
        newid, rlen = T["new_ids"], T["read_len"]
        nv1, nv2 = v1[mv], v2[mv]
        w1, w2 = vis1[mv], vis2[mv]
        cu = np.where(w1, ptr[nv1 + 1] - ptr[nv1], 1)
        cv = np.where(w2, ptr[nv2 + 1] - ptr[nv2], 1)
        rep = cu * cv
        tot = int(rep.sum())
        if tot == 0:
            return
        row_of = np.repeat(np.arange(len(mv)), rep)
        base = np.cumsum(rep) - rep
        within = np.arange(tot, dtype=np.int64) - base[row_of]
        cvr = cv[row_of]
        iu = within // cvr
        iv = within - iu * cvr
        nu, nv = nv1[row_of], nv2[row_of]
        vu, vv = w1[row_of], w2[row_of]
        cap = len(gid) - 1
        suc = np.minimum(ptr[nu] + iu, cap)
        svc = np.minimum(ptr[nv] + iv, cap)
        # an unvisited endpoint MUST have a new id: -1 (the fill value)
        # would corrupt the packed pair key via sign bits, where the
        # scalar path raised KeyError for the same state
        assert (newid[nu[~vu]] >= 0).all() and (newid[nv[~vv]] >= 0).all(), \
            "unvisited node missing from nodes_to_new_ids"
        idU = np.where(vu, gid[suc], newid[nu])
        ilU = np.where(vu, gil[suc], 0)
        l1U = np.where(vu, gl1[suc], rlen[nu])
        idV = np.where(vv, gid[svc], newid[nv])
        ilV = np.where(vv, gil[svc], 0)
        l1V = np.where(vv, gl1[svc], rlen[nv])

        np1 = pos1[mv][row_of] + ilU - ilV
        neg = np1 < 0
        np1a = np.where(neg, -np1, np1)
        ln = np.where(neg, l1V, l1U)
        ov1 = np.minimum(np.minimum(ln - np1a, l1U), l1V)
        # f32 like the reference (see _perc_f32): divisions and *100 in
        # single precision
        ovf = ov1.astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            perc = np.floor(
                np.maximum(ovf / l1U.astype(np.float32),
                           ovf / l1V.astype(np.float32)) * _F100
            ).astype(np.int64)
        valid = np1a < ln

        cand = ~(vu & vv & (idU == idV))
        key = (np.minimum(idU, idV) << 32) | np.maximum(idU, idV)
        # first occurrence per pair key, in candidate order (= scalar order)
        masked = np.where(cand, key, np.int64(-1))
        _, first_idx = np.unique(masked, return_index=True)
        first = np.zeros(tot, bool)
        first[first_idx] = True
        first &= cand
        sel = np.flatnonzero(first)
        keys_sel = key[sel].tolist()
        found = self.found
        fresh = np.fromiter((k not in found for k in keys_sel), bool,
                            count=len(sel))
        found.update(k for k, kn in zip(keys_sel, fresh) if kn)
        emit = sel[fresh]
        emit = emit[valid[emit]]
        if s.no_inclusions:
            emit = emit[perc[emit] != 100]
        if len(emit) == 0:
            return
        is1 = ~neg[emit]
        idf = np.where(is1, idU[emit], idV[emit])
        ids_ = np.where(is1, idV[emit], idU[emit])
        o1e = o1[mv][row_of[emit]]
        o2e = o2[mv][row_of[emit]]
        for a_, b_, p_, pc, l_, x, y in zip(
                idf.tolist(), ids_.tolist(), np1a[emit].tolist(),
                perc[emit].tolist(), ov1[emit].tolist(),
                o1e.tolist(), o2e.tolist()):
            add(f"{a_}\t{b_}\t{p_}\t0\t-\t{'+' if x else '-'}\t"
                f"{'+' if y else '-'}\t{pc}\t0\t{l_}\t0\ts\ts")

    def run(self, nonedge_overlaps: Optional[np.ndarray] = None) -> List[str]:
        g = self.g
        rows = g.edges
        # current edges (adjacency order)
        eidx, _ = g._flat_adj_out()
        self._update_overlaps_batch(rows[eidx])
        # removed branching/tip/cycle edges
        if len(g.branching_edges):
            self._update_overlaps_batch(
                np.asarray(g.branching_edges, dtype=rows.dtype))
        # nonedge overlaps (only when optimize=false)
        if not self.s.optimize and nonedge_overlaps is not None:
            self._reconsider_nonedges(nonedge_overlaps)
        self._inclusion_overlaps()
        return sorted(self.lines)

    def _reconsider_nonedges(self, overlaps: np.ndarray) -> None:
        """Rebuild pseudo-edges (score 0) from stored nonedge overlaps
        (FindNextOverlaps.cpp:635-813, resolve_orientations path).

        All rows at once: ids to vertices, checkEdge's rule against packed
        keys of the alive edges (the forward edge's score if there is one,
        else the reverse edge's; where a pair has several edges, the first
        in adj_out order), then one batch in row order, so the scalar
        fallback and the first-wins `found` marks are the per-row loop's."""
        from ..utils.log import nested_phase

        with nested_phase("fno.nonedges"):
            id_to_index = self.store.id_to_index
            n = len(overlaps)
            i1 = np.fromiter((id_to_index[k] for k in overlaps["id1"].tolist()),
                             np.int64, count=n)
            i2 = np.fromiter((id_to_index[k] for k in overlaps["id2"].tolist()),
                             np.int64, count=n)
            g = self.g
            eidx, _ = g._flat_adj_out()
            ekey = (g.edges["v1"][eidx] << 32) | g.edges["v2"][eidx]
            # np.unique's index is each key's first occurrence in adj_out order
            keys, first = np.unique(ekey, return_index=True)
            kscore = g.edges["score"][eidx[first]]
            score = np.full(n, -1.0)
            if len(keys):
                # the reverse edge's score, then the forward edge's over it
                for key in ((i2 << 32) | i1, (i1 << 32) | i2):
                    p = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
                    hit = keys[p] == key
                    score[hit] = kscore[p[hit]]
            keep = ~(score > 0)
            r = overlaps[keep]
            rows = np.zeros(len(r), dtype=rows_dtype())
            rows["v1"], rows["v2"] = i1[keep], i2[keep]
            rows["pos1"], rows["pos2"] = r["pos1"], r["pos2"]
            rows["ori1"] = r["ori1"] == b"+"
            rows["ori2"] = r["ori2"] == b"+"
            rows["ord"] = r["ord"]
            perc1 = r["perc1"].astype(np.int64)
            perc2 = r["perc2"].astype(np.int64)
            # int(0.5 * (perc1 + perc2)): a float, truncated toward zero
            rows["perc"] = np.where(perc2 > 0, (0.5 * (perc1 + perc2)).astype(np.int64),
                                    perc1)
            rows["len1"], rows["len2"] = r["len1"], r["len2"]
            self.nonedge_rows += len(rows)
            self.nonedge_scalar += self._update_overlaps_batch(rows)

    def _inclusion_overlaps(self) -> None:
        """Induce S-S edges through removed inclusion vertices
        (findInclusionOverlaps, FindNextOverlaps.cpp:816-887).

        The per-vertex pair enumeration is vectorized (triu pair indices in
        the reference's i<j order); only surviving candidates reach the
        Python emit path, in the original emission order."""
        g, store, s = self.g, self.store, self.s
        if not g.inclusion_edges:
            return
        paired = np.asarray(store.is_paired, dtype=bool)
        read_lens = np.array([store.read_len(i) for i in range(len(store))],
                             dtype=np.int64)
        av1, av2 = g.edge_endpoints()
        # undirected packed keys, sorted, for vectorized existing-edge checks
        a64 = av1.astype(np.int64)
        b64 = av2.astype(np.int64)
        edge_keys = np.unique((np.minimum(a64, b64) << 32)
                              | np.maximum(a64, b64))
        # flatten every inclusion list's triu pairs into ONE candidate batch
        # (preserving list order and i<j order within a list, so the
        # surviving emit order below equals the per-list loop's); the
        # per-list numpy overhead was a 10x-scale hotspot
        lists = [el for el in g.inclusion_edges if len(el) >= 2]
        if not lists:
            return
        arr = np.array([row for el in lists for row in el], dtype=rows_dtype())
        # compact per-column views: indexing these for millions of triu
        # pairs avoids gathering full ~60B struct rows per pair
        cv1 = arr["v1"].astype(np.int64)
        cv2 = arr["v2"].astype(np.int64)
        cpos1 = arr["pos1"].astype(np.int64)
        cori1 = arr["ori1"].copy()
        cori2 = arr["ori2"].copy()
        sizes = np.fromiter((len(el) for el in lists), np.int64,
                            count=len(lists))
        starts = np.cumsum(sizes) - sizes
        tri_cache = {}

        def process_chunk(i_parts, j_parts):
            i_idx = np.concatenate(i_parts)
            j_idx = np.concatenate(j_parts)
            e1v1, e1v2 = cv1[i_idx], cv2[i_idx]
            e2v1, e2v2 = cv1[j_idx], cv2[j_idx]
            case1 = (e1v1 != e2v1) & (e1v1 == e2v2)
            case2 = (e1v1 != e2v1) & ~case1 & (e1v2 == e2v1)
            n1 = np.where(case1, e2v1, e1v1)
            n2 = np.where(case1, e1v2, e2v2)
            okm = (case1 | case2) & ~paired[n1] & ~paired[n2]
            idxs = np.flatnonzero(okm)
            if len(idxs) == 0:
                return
            pos1 = np.where(case1, cpos1[j_idx], cpos1[i_idx])
            ori1 = np.where(case1, cori1[j_idx], cori1[i_idx])
            ori2 = np.where(case1, cori2[i_idx], cori2[j_idx])
            # drop candidates whose endpoints already share an edge
            # (either direction), vectorized against the sorted key table
            ka = n1[idxs]
            kb = n2[idxs]
            ukey = (np.minimum(ka, kb) << 32) | np.maximum(ka, kb)
            if len(edge_keys):
                p = np.minimum(np.searchsorted(edge_keys, ukey),
                               len(edge_keys) - 1)
                idxs = idxs[edge_keys[p] != ukey]
            if len(idxs) == 0:
                return
            l1 = read_lens[n1[idxs]]
            l2 = read_lens[n2[idxs]]
            length = np.minimum(l1 - pos1[idxs], l2)
            perc = (100 * length) // np.minimum(l1, l2)
            erows = np.zeros(len(idxs), dtype=rows_dtype())
            erows["v1"] = n1[idxs]
            erows["v2"] = n2[idxs]
            erows["score"] = s.edge_threshold
            erows["pos1"] = pos1[idxs]
            erows["ori1"] = ori1[idxs].astype(bool)
            erows["ori2"] = ori2[idxs].astype(bool)
            erows["ord"] = b"-"
            erows["perc"] = perc
            erows["len1"] = length
            self._update_overlaps_batch(erows)

        # bounded chunks: peak memory is O(PAIR_CAP), not O(sum ln^2); chunks
        # are processed in list order so the emit order is unchanged
        PAIR_CAP = 4_000_000
        i_parts, j_parts, pending = [], [], 0
        for st, ln in zip(starts, sizes):
            cached = tri_cache.get(int(ln))
            if cached is None:
                cached = np.triu_indices(int(ln), k=1)
                tri_cache[int(ln)] = cached
            i_parts.append(cached[0] + st)
            j_parts.append(cached[1] + st)
            pending += len(cached[0])
            if pending >= PAIR_CAP:
                process_chunk(i_parts, j_parts)
                i_parts, j_parts, pending = [], [], 0
        if pending:
            process_chunk(i_parts, j_parts)


def rows_dtype():
    from ..ops.verify import EDGE_DTYPE

    return EDGE_DTYPE


def find_next_overlaps3(builder: SuperreadBuilder) -> List[str]:
    """FNO3: overlaps between superreads sharing an original read
    (src/FindNextOverlaps3.cpp:20-173). Each superread PAIR emits one
    overlap, deduced from whichever shared original is reached first — so
    the outer iteration order decides coordinates. In reference-order mode
    that is the libstdc++ iteration order of original_to_index (superread
    originals are already stored in their maps' iteration order)."""
    s = builder.s
    # original read -> superreads, in single/paired/trivial insertion order
    orig_to_sr: Dict[int, List[Superread]] = {}
    for group in (builder.single_SR, builder.paired_SR, builder.trivial_SR):
        for sr in group:
            for orig_id in sr.originals:
                orig_to_sr.setdefault(orig_id, []).append(sr)
    if s.reference_order:
        from ..utils.cpporder import umap_order

        outer = umap_order(orig_to_sr.keys())
    else:
        outer = list(orig_to_sr.keys())
    found: Dict[int, Set[int]] = {}
    lines: List[str] = []
    for orig_id in outer:
        sr_list = orig_to_sr[orig_id]
        n = len(sr_list)
        for i in range(n):
            sr1 = sr_list[i]
            for j in range(i + 1, n):
                sr2 = sr_list[j]
                lo, hi = min(sr1.read_id, sr2.read_id), max(sr1.read_id, sr2.read_id)
                seen = found.setdefault(lo, set())
                if hi in seen:
                    continue
                seen.add(hi)
                line = _deduce_overlap(sr1, sr2, orig_id, s)
                if line is not None:
                    lines.append(line)
    return lines


def _deduce_overlap(sr1: Superread, sr2: Superread, orig_id: int, s: Settings) -> Optional[str]:
    """Port of deduceOverlap (FindNextOverlaps3.cpp:176-406). Returns the
    overlap line or None when the overlap is degenerate/ignored."""
    o1 = sr1.originals[orig_id]
    o2 = sr2.originals[orig_id]
    if not sr1.is_paired and not sr2.is_paired:  # S-S
        idx1, idx2 = o1.index1, o2.index1
        la, lb = len(sr1.seq1), len(sr2.seq1)
        if idx1 - idx2 >= 0:
            id1, id2 = sr1.read_id, sr2.read_id
            pos1 = idx1 - idx2
            if pos1 > la:
                return None
            len1 = min(la - pos1, lb)
        else:
            id1, id2 = sr2.read_id, sr1.read_id
            pos1 = idx2 - idx1
            if pos1 > lb:
                return None
            len1 = min(la, lb - pos1)
        if len1 <= 0:
            return None
        perc1 = _perc_f32(len1, la, lb)
        if s.no_inclusions and perc1 == 100:
            return None
        return f"{id1}\t{id2}\t{pos1}\t0\t-\t+\t+\t{perc1}\t0\t{len1}\t0\ts\ts"
    if sr1.is_paired and not sr2.is_paired:  # P-S
        idx1l, idx1r = o1.index1, o1.index2
        idx2l, idx2r = o2.index1, o2.index2
        la1, la2 = len(sr1.seq1), len(sr1.seq2)
        lb = len(sr2.seq1)
        if idx1l - idx2l >= 0:
            id1, id2 = sr1.read_id, sr2.read_id
            pos1 = idx1l - idx2l
            len1 = la1 - pos1
            t1, t2 = "p", "s"
        else:
            id1, id2 = sr2.read_id, sr1.read_id
            pos1 = idx2l - idx1l
            len1 = min(la1, lb - pos1)
            t1, t2 = "s", "p"
        if len1 <= 0:
            return None
        perc1 = _perc_f32(len1, la1)
        pos2 = idx2r - idx1r
        len2 = min(la2, lb - pos2)
        if len2 <= 0 or pos2 < 0:
            return None
        perc2 = _perc_f32(len2, la2)
        full_perc = int(0.5 * (perc1 + perc2)) if perc2 > 0 else perc1
        if s.no_inclusions and full_perc == 100:
            return None
        return f"{id1}\t{id2}\t{pos1}\t{pos2}\t-\t+\t+\t{perc1}\t{perc2}\t{len1}\t{len2}\t{t1}\t{t2}"
    if not sr1.is_paired and sr2.is_paired:  # S-P
        idx1l, idx1r = o1.index1, o1.index2
        idx2l, idx2r = o2.index1, o2.index2
        la = len(sr1.seq1)
        lb1, lb2 = len(sr2.seq1), len(sr2.seq2)
        if idx1l - idx2l >= 0:
            id1, id2 = sr1.read_id, sr2.read_id
            pos1 = idx1l - idx2l
            len1 = min(lb1, la - pos1)
            t1, t2 = "s", "p"
        else:
            id1, id2 = sr2.read_id, sr1.read_id
            pos1 = idx2l - idx1l
            len1 = lb1 - pos1
            t1, t2 = "p", "s"
        if len1 <= 0:
            return None
        perc1 = _perc_f32(len1, lb1)
        pos2 = idx1r - idx2r
        len2 = min(lb2, la - pos2)
        if len2 <= 0 or pos2 < 0:
            return None
        perc2 = _perc_f32(len2, lb2)
        full_perc = int(0.5 * (perc1 + perc2)) if perc2 > 0 else perc1
        if s.no_inclusions and full_perc == 100:
            return None
        return f"{id1}\t{id2}\t{pos1}\t{pos2}\t-\t+\t+\t{perc1}\t{perc2}\t{len1}\t{len2}\t{t1}\t{t2}"
    # P-P
    idx1l, idx1r = o1.index1, o1.index2
    idx2l, idx2r = o2.index1, o2.index2
    la, lb = len(sr1.seq1), len(sr2.seq1)
    lc, ld = len(sr1.seq2), len(sr2.seq2)
    if idx1l - idx2l >= 0:
        id1, id2 = sr1.read_id, sr2.read_id
        pos1 = idx1l - idx2l
        len1 = min(la - pos1, lb)
        front_ord = True
    else:
        id1, id2 = sr2.read_id, sr1.read_id
        pos1 = idx2l - idx1l
        len1 = min(la, lb - pos1)
        front_ord = False
    if idx1r - idx2r >= 0:
        pos2 = idx1r - idx2r
        len2 = min(lc - pos2, ld)
        back_ord = True
    else:
        pos2 = idx2r - idx1r
        len2 = min(lc, ld - pos2)
        back_ord = False
    if len1 <= 0 or len2 <= 0:
        return None
    perc1 = _perc_f32(len1, la, lb)
    perc2 = _perc_f32(len2, lc, ld)
    ordc = "1" if front_ord == back_ord else "2"
    full_perc = int(0.5 * (perc1 + perc2)) if perc2 > 0 else perc1
    if s.no_inclusions and full_perc == 100:
        return None
    return f"{id1}\t{id2}\t{pos1}\t{pos2}\t{ordc}\t+\t+\t{perc1}\t{perc2}\t{len1}\t{len2}\tp\tp"
