"""Superread (consensus contig) construction from cliques or merge edges.

Rebuild of the reference SRBuilder (src/SRBuilder.cpp). The per-position
Bayesian base call (consensus_pos, SRBuilder.cpp:297-402) is vectorized:
each clique's member sequences are stacked into offset windows and the four
per-base log10 likelihood columns are accumulated with NumPy float64 (the
reference's double math), then argmax with the reference's A,T,C,G
tie-break priority.

Superreads carry the provenance needed for iteration: the per-end sorted
clique node lists, the node -> SubreadInfo map (offsets into the consensus
after trimming), and the ORIGINAL read index map (OriginalIndex) updated
through the index arithmetic of constructSuperread
(SRBuilder.cpp:750-806).
"""

from __future__ import annotations

import bisect
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import N_CODE, ReadStore, revcomp_codes
from ..native import load_consensus_ext
from ..graph.overlap_graph import OverlapGraph
from ..io.subreads import OriginalIndex, SubreadDict
from ..utils.config import Settings
from ..utils.cpporder import reorder_map, umap_order

LOG10 = np.log(10.0)
N_QUAL = ord("$") - 33  # phred 3, the reference's quality for masked 'N's


@dataclass
class SubreadInfo:
    index1: int = 0
    index2: int = -1
    startpos1: int = 0
    startpos2: int = -1


@dataclass
class Superread:
    is_paired: bool
    seq1: np.ndarray  # codes
    qual1: np.ndarray
    seq2: np.ndarray
    qual2: np.ndarray
    sorted_clique1: List[int] = field(default_factory=list)
    sorted_clique2: List[int] = field(default_factory=list)
    subread_map: Dict[int, SubreadInfo] = field(default_factory=dict)
    originals: Dict[int, OriginalIndex] = field(default_factory=dict)
    read_id: int = -1

    def seq_len(self, end: int) -> int:
        if end == 1 or end == 0:
            return len(self.seq1)
        return len(self.seq2)

    def total_len(self) -> int:
        return len(self.seq1) + (len(self.seq2) if self.is_paired else 0)

    def n_rate_ok(self) -> bool:
        """N fraction < 5% (Read::test_N_rate, src/Read.h:214-234)."""
        if self.is_paired:
            total = np.concatenate([self.seq1, self.seq2])
        else:
            total = self.seq1
        return int(np.count_nonzero(total == N_CODE)) < 0.05 * len(total)


class SuperreadBuilder:
    def __init__(self, store: ReadStore, graph: OverlapGraph, settings: Settings,
                 originals_dict: SubreadDict):
        self.store = store
        self.g = graph
        self.s = settings
        self.originals_dict = originals_dict  # current read ID -> originals
        self.single_SR: List[Superread] = []
        self.paired_SR: List[Superread] = []
        self.trivial_SR: List[Superread] = []
        self.tips: List[int] = []  # read indices stored separately
        self.visited = np.zeros(graph.n, dtype=bool)
        self.nodes_to_new_ids: Dict[int, int] = {}
        self.new_read_count = 0
        self.clique_count = 0
        # (v1, v2) -> first edge id in adjacency order; the graph is static
        # during superread construction, so one flat build replaces the
        # per-member get_edge_idx adjacency scans in sort_vertices
        flat, v_of = graph._flat_adj_out()
        keys = (v_of * graph.n + graph.edges["v2"][flat].astype(np.int64)).tolist()
        ids = flat.tolist()
        # reversed zip => FIRST occurrence wins, matching get_edge_idx
        self._edge_map: Dict[int, int] = dict(zip(keys[::-1], ids[::-1]))

    def _edge_idx(self, a: int, b: int) -> int:
        """get_edge_idx(a, b, reverse_allowed=True) via the prebuilt map."""
        e = self._edge_map.get(a * self.g.n + b)
        if e is None:
            e = self._edge_map[b * self.g.n + a]
        return e

    # --------------------------------------------------------------- helpers
    def _oriented_end(self, read_idx: int, end: int, forward: bool):
        """Sequence codes+quals of a read end, oriented by the vertex label.

        end semantics mirror Read::get_seq with label applied by the caller:
        forward: 'l'->seq(1) 'r'->seq(2) 's'->seq(0);
        reverse: 'l'->revcomp(seq(2)) 'r'->revcomp(seq(1)) 's'->revcomp(seq(0)).
        """
        store = self.store
        u1, u2 = store.units_of(read_idx)
        if not store.is_paired[read_idx]:
            unit = u1
        elif forward:
            unit = u1 if end == 1 else u2
        else:
            unit = u2 if end == 1 else u1
        return store.unit_codes(unit, forward), store.unit_quals(unit, forward)

    # -------------------------------------------------- sort_vertices (33-286)
    def sort_vertices(self, vertices: List[int], sr_type: str, base_node: int):
        """Order clique members left-to-right relative to the base read.

        Returns (total_len, pos_list, seq_list, qual_list, sorted_vertices).
        sr_type in {'l','r','s'}.
        """
        g, store = self.g, self.store
        base_fwd = bool(g.vertex_orientations[base_node])
        if sr_type == "l":
            base_seq, base_qual = self._oriented_end(base_node, 1, base_fwd)
        elif sr_type == "r":
            base_seq, base_qual = self._oriented_end(base_node, 2, base_fwd)
        else:
            base_seq, base_qual = self._oriented_end(base_node, 0, base_fwd)

        pos_list: List[int] = [0]
        seq_list = [base_seq]
        qual_list = [base_qual]
        sorted_vertices: List[int] = [base_node]
        total_len = len(base_seq)
        l_ext = 0
        r_ext = 0
        rows = g.edges

        def insert(pos: int, seq, qual, node: int) -> None:
            i = bisect.bisect_left(pos_list, pos)
            pos_list.insert(i, pos)
            seq_list.insert(i, seq)
            qual_list.insert(i, qual)
            sorted_vertices.insert(i, node)

        for node in vertices:
            if node == base_node:
                continue
            e = self._edge_idx(base_node, node)
            cur_fwd = bool(g.vertex_orientations[node])
            v1, v2 = int(rows["v1"][e]), int(rows["v2"][e])
            base_is_first = v1 == base_node
            ordc = rows["ord"][e]
            cur_paired = store.is_paired[node]
            cur_type = ("p" if cur_paired else "s") if sr_type == "s" else sr_type

            new_pos = None
            seq = qual = None
            seq1 = qual1 = None
            new_pos1 = None
            if cur_type == "s":
                pos = int(rows["pos1"][e])
                seq, qual = self._oriented_end(node, 0, cur_fwd)
                new_pos = pos if base_is_first else -pos
            elif cur_type in ("l", "p"):
                pos = int(rows["pos1"][e])
                seq, qual = self._oriented_end(node, 1, cur_fwd)
                new_pos = pos if base_is_first else -pos
                if cur_type == "p":
                    seq1, qual1, new_pos1 = seq, qual, new_pos
            if cur_type in ("r", "p"):
                pos = int(rows["pos2"][e])
                seq, qual = self._oriented_end(node, 2, cur_fwd)
                if cur_type == "p" or (base_is_first and ordc == b"1") or \
                        (not base_is_first and ordc == b"2"):
                    new_pos = pos
                else:
                    new_pos = -pos

            if cur_type == "p":
                insert(new_pos1, seq1, qual1, node)
            insert(new_pos, seq, qual, node)

            if cur_type == "p":
                len1 = -new_pos1
                len2 = len(seq) + new_pos - len(base_seq)
                seq1_len2 = len(seq1) + new_pos1 - len(base_seq)
                len2 = max(len2, seq1_len2)
            else:
                len1 = -new_pos
                len2 = len(seq) + new_pos - len(base_seq)
            l_ext = max(l_ext, len1)
            r_ext = max(r_ext, len2)

        total_len += l_ext + r_ext
        mn = pos_list[0]
        if mn < 0:
            pos_list = [p - mn for p in pos_list]
        return total_len, pos_list, seq_list, qual_list, sorted_vertices

    # ------------------------------------------------ consensus (297-533)
    def consensus(self, total_len: int, pos_list, seq_list, qual_list,
                  error_correction: bool) -> Tuple[np.ndarray, np.ndarray, int]:
        """Single-job wrapper over batch_consensus (one code path)."""
        return self.batch_consensus(
            [(total_len, pos_list, seq_list, qual_list, error_correction)])[0]

    def batch_consensus(self, jobs) -> List[Tuple[np.ndarray, np.ndarray, int]]:
        """Consensus over MANY cliques at once via flat scatter-adds.

        Each job is (total_len, pos_list, seq_list, qual_list,
        error_correction); returns one (codes, quals, trim_pos) triple per
        job. Empty codes + trim_pos -1 = not enough support; empty + trim 0
        = degenerate failure (gap / exhausted sequence), matching the
        reference's return conventions (SRBuilder.cpp:297-533).

        The per-position Bayesian base call accumulates each member's
        log10-likelihood contribution with np.bincount, whose sequential
        accumulation order per output bin equals the member order the
        reference uses — so results are bit-identical to the per-clique
        loop it replaces.
        """
        import itertools

        min_support = self.s.min_clique_size
        nj = len(jobs)
        results: List = [None] * nj
        if nj == 0:
            return results

        FAIL_SUPPORT = (np.zeros(0, np.int8), np.zeros(0, np.uint8), -1)
        FAIL_DEGEN = (np.zeros(0, np.int8), np.zeros(0, np.uint8), 0)

        # ---- flatten every job's members ONCE (job order, positions
        # ascending — pos_list is maintained sorted by sort_vertices); all
        # pass-1 conditions below are computed with flat segment ops, no
        # per-job numpy calls (the per-job loop was the 10x-scale hotspot)
        n_members = np.fromiter((len(j[1]) for j in jobs), dtype=np.int64,
                                count=nj)
        total_len = np.fromiter((j[0] for j in jobs), dtype=np.int64, count=nj)
        ec_flags = np.fromiter((bool(j[4]) for j in jobs), dtype=bool, count=nj)
        n_mem_total = int(n_members.sum())
        m_job = np.repeat(np.arange(nj), n_members)
        m_pos = np.fromiter(
            itertools.chain.from_iterable(j[1] for j in jobs),
            dtype=np.int64, count=n_mem_total)
        seq_all: List[np.ndarray] = list(
            itertools.chain.from_iterable(j[2] for j in jobs))
        qual_all: List[np.ndarray] = list(
            itertools.chain.from_iterable(j[3] for j in jobs))
        m_len = np.fromiter((len(sq) for sq in seq_all), dtype=np.int64,
                            count=n_mem_total)
        m_end = m_pos + m_len
        job_start = np.concatenate([[0], np.cumsum(n_members)])

        # ---- trim + support failure (SRBuilder.cpp:406-533)
        fail_support = ec_flags & (n_members < min_support)
        ec_ok = ec_flags & ~fail_support
        trims_j = np.zeros(nj, dtype=np.int64)
        if np.any(ec_ok):
            idx_trim = job_start[:-1] + (min_support - 1)
            sel = np.flatnonzero(ec_ok)
            trims_j[sel] = m_pos[idx_trim[sel]]

        # ---- degenerate abort: a sequence lying fully inside the trimmed
        # prefix aborts the whole consensus — the reference hits
        # `pos >= seq->length()` and fails (SRBuilder.cpp:478-481)
        m_trim_all = trims_j[m_job]
        bad = (m_end <= m_trim_all) & (m_pos < m_trim_all) & ec_ok[m_job]
        fail_degen = np.bincount(m_job, weights=bad, minlength=nj) > 0

        # ---- stop = first position >= max(pos) with support < min_support
        # (mid-sequence dips before the last activation tolerated); computed
        # for all surviving EC jobs at once over flat coverage segments
        stops_j = total_len.copy()
        ecj = np.flatnonzero(ec_ok & ~fail_degen)
        if len(ecj):
            seg_len = total_len[ecj] + 1
            cov_base = np.concatenate([[0], np.cumsum(seg_len)])
            C = int(cov_base[-1])
            remap = np.full(nj, -1, dtype=np.int64)
            remap[ecj] = np.arange(len(ecj))
            mm = np.flatnonzero(remap[m_job] >= 0)
            base_m = cov_base[remap[m_job[mm]]]
            tl_m = total_len[m_job[mm]]
            starts = np.maximum(m_pos[mm], m_trim_all[mm])
            diff = (np.bincount(base_m + np.minimum(starts, tl_m), minlength=C)
                    - np.bincount(base_m + np.minimum(m_end[mm], tl_m),
                                  minlength=C))
            # each job's +1/-1 pairs net to zero inside its own segment, so
            # one global cumsum never leaks coverage across segments
            coverage = np.cumsum(diff)
            local = np.arange(C, dtype=np.int64) - np.repeat(cov_base[:-1],
                                                             seg_len)
            # pos_list sorted ascending -> per-job max(pos) is its last entry
            pos_max = m_pos[job_start[1:] - 1]
            scan_from = np.maximum(trims_j[ecj], pos_max[ecj])
            slot_job = np.repeat(np.arange(len(ecj)), seg_len)
            cond = ((coverage < min_support)
                    & (local >= scan_from[slot_job])
                    & (local < total_len[ecj][slot_job]))
            BIG = np.int64(1) << 62
            first_low = np.minimum.reduceat(np.where(cond, local, BIG),
                                            cov_base[:-1])
            stops_j[ecj] = np.where(first_low >= BIG, total_len[ecj],
                                    first_low)

        width_j = stops_j - trims_j
        live_mask = ~fail_support & ~fail_degen & (width_j > 0)
        # non-live results (support/degenerate/empty-width), in one sweep
        for j in np.flatnonzero(~live_mask):
            if fail_support[j]:
                results[j] = FAIL_SUPPORT
            elif fail_degen[j]:
                results[j] = FAIL_DEGEN
            else:
                results[j] = (np.zeros(0, np.int8), np.zeros(0, np.uint8),
                              int(trims_j[j]))
        live = np.flatnonzero(live_mask)
        if len(live) == 0:
            return results

        # ---- pass 2: one flat scatter over all live jobs' member windows.
        # The flat order — members in job order, positions ascending — is
        # exactly the order the per-clique loop it replaces emitted, so the
        # bincount accumulation below stays bit-identical.
        widths = width_j[live]
        out_base = np.concatenate([[0], np.cumsum(widths)])
        W_total = int(out_base[-1])
        job_out = np.zeros(nj, dtype=np.int64)
        job_out[live] = out_base[:-1]

        lm = live_mask[m_job]
        a = np.maximum(m_pos, m_trim_all)
        b = np.minimum(m_end, stops_j[m_job])
        w_len = np.where(lm, np.maximum(b - a, 0), 0)
        tot = int(w_len.sum())

        # phred -> log10 likelihood lookup tables (exact same doubles as
        # computing per element; phred 0 => p_err == 1 => log10(0) = -inf,
        # matching the reference's C++ double semantics)
        qv = np.arange(94, dtype=np.float64)
        p_err_lut = np.power(10.0, -qv / 10.0)
        with np.errstate(divide="ignore"):
            l_match_lut = np.log10(1.0 - p_err_lut)
        l_mis_lut = np.log10(p_err_lut / 3.0)

        ext = None if os.environ.get("HC_CONSENSUS") == "numpy" \
            else load_consensus_ext()
        if ext is not None:
            # ---- native pass 2: one OpenMP pass per window character, one
            # per output position (native/consensus.cpp). Jobs own disjoint
            # output ranges so the per-bin accumulation order equals the
            # sequential bincount below -> bit-identical results.
            seq_cat = (np.concatenate(seq_all) if seq_all
                       else np.zeros(0, np.int8))
            qual_cat = (np.concatenate(qual_all) if qual_all
                        else np.zeros(0, np.uint8))
            seq_start = np.cumsum(m_len) - m_len
            active = w_len > 0
            src0 = np.where(active, seq_start + (a - m_pos), 0)
            dst0 = np.where(active, job_out[m_job] + (a - m_trim_all), 0)
            codes_all, quals_all, counts = ext.consensus_scatter(
                seq_cat, qual_cat, src0, dst0, w_len, job_start, W_total,
                l_match_lut, l_mis_lut, self.s.min_qual, N_CODE, N_QUAL)
        else:
            if tot:
                seq_cat = np.concatenate(seq_all)
                qual_cat = np.concatenate(qual_all)
                seq_start = np.concatenate([[0], np.cumsum(m_len)[:-1]])
                w_start = np.cumsum(w_len) - w_len
                rep = np.repeat(np.arange(n_mem_total), w_len)
                offs = np.arange(tot, dtype=np.int64) - np.repeat(w_start, w_len)
                src = seq_start[rep] + (a - m_pos)[rep] + offs
                gpos = job_out[m_job][rep] + (a - m_trim_all)[rep] + offs
                w = seq_cat[src].astype(np.int64)
                q = qual_cat[src].astype(np.int64)
            else:
                gpos = np.zeros(0, np.int64)
                w = np.zeros(0, np.int64)
                q = np.zeros(0, np.int64)

            valid = w < N_CODE
            lm = np.where(valid, l_match_lut[np.minimum(q, 93)], 0.0)
            lx = np.where(valid, l_mis_lut[np.minimum(q, 93)], 0.0)

            scores = np.empty((W_total, 4), dtype=np.float64)
            for b_code in range(4):
                contrib = np.where(w == b_code, lm, lx)
                scores[:, b_code] = np.bincount(gpos, weights=contrib, minlength=W_total)
            counts = np.bincount(gpos, minlength=W_total)  # incl. N's (minQual rule)

            # ---- per-position base call over the whole flat buffer
            # tie-break priority A, T, C, G (consensus_pos:390-393)
            prio = np.array([0, 3, 1, 2])  # column order A,T,C,G
            reordered = scores[:, prio]
            max_score = reordered.max(axis=1)
            first_max = np.argmax(reordered == max_score[:, None], axis=1)
            call = prio[first_max]  # back to code space

            with np.errstate(over="ignore", under="ignore"):
                probs = np.power(10.0, scores)
            total_prob = probs.sum(axis=1)
            max_prob = np.power(10.0, max_score)
            p_correct = np.where(total_prob > 0, max_prob / np.maximum(total_prob, 1e-320), 0.0)
            p_incorrect = 1.0 - p_correct

            n_mask = (max_score == 0) | (total_prob == 0.0)
            n_mask |= (counts > 1) & (p_correct < self.s.min_qual)

            with np.errstate(divide="ignore"):
                # C round(): half away from zero (values are >= 0 here)
                phred = np.floor(-10.0 * np.log10(np.maximum(p_incorrect, 1e-320)) + 0.5)
            phred = np.where(p_incorrect < 10.0 ** (-9.3), 93, phred)
            phred = np.clip(phred, 0, 93).astype(np.uint8)

            codes_all = np.where(n_mask, N_CODE, call).astype(np.int8)
            quals_all = np.where(n_mask, N_QUAL, phred).astype(np.uint8)

        # ---- split back per job; a position with no active sequence
        # aborts that job's whole consensus
        min_count = np.minimum.reduceat(counts, out_base[:-1])
        for i, j in enumerate(live):
            if min_count[i] == 0:
                results[j] = FAIL_DEGEN
            else:
                lo, hi = int(out_base[i]), int(out_base[i + 1])
                results[j] = (codes_all[lo:hi].copy(), quals_all[lo:hi].copy(),
                              int(trims_j[j]))
        return results

    # -------------------------------------------- calcSubreadInfo (536-595)
    def calc_subread_info(self, trim1, trim2, pos_list1, pos_list2,
                          sorted1, sorted2) -> Dict[int, SubreadInfo]:
        sub: Dict[int, SubreadInfo] = {}
        for node, pos in zip(sorted1, pos_list1):
            if node in sub:  # second occurrence (paired member in single SR)
                si = sub[node]
                if trim1 > pos:
                    si.startpos2, si.index2 = trim1 - pos, 0
                else:
                    si.startpos2, si.index2 = 0, pos - trim1
            else:
                si = SubreadInfo()
                if trim1 > pos:
                    si.startpos1, si.index1 = trim1 - pos, 0
                else:
                    si.startpos1, si.index1 = 0, pos - trim1
                si.index2 = -1
                si.startpos2 = -1
                sub[node] = si
        if trim2 >= 0:
            for node, pos in zip(sorted2, pos_list2):
                si = sub[node]
                if trim2 > pos:
                    si.startpos2, si.index2 = trim2 - pos, 0
                else:
                    si.startpos2, si.index2 = 0, pos - trim2
        # stored-order invariant: key order == C++ map iteration order
        # (merge_self_overlap iterates subreadMap, SRBuilder.cpp:916-927)
        return reorder_map(sub) if self.s.reference_order else sub

    # ----------------------------------------- filter_subreads (597-636)
    @staticmethod
    def filter_subreads(num, base_node, sorted_vertices, pos_list, seq_list, qual_list):
        selected = set(sorted_vertices[:num // 2])
        selected.add(base_node)
        endpos = [(node, p + len(sq)) for node, p, sq in zip(sorted_vertices, pos_list, seq_list)]
        by_end = sorted(endpos, key=lambda t: t[1])
        i = len(by_end) - 1
        while len(selected) < num and i >= 0:
            selected.add(by_end[i][0])
            i -= 1
        new_pos, new_seq, new_qual = [], [], []
        for node, p, sq, ql in zip(sorted_vertices, pos_list, seq_list, qual_list):
            if node in selected:
                new_pos.append(p)
                new_seq.append(sq)
                new_qual.append(ql)
        return new_pos, new_seq, new_qual

    # --------------------------------------- constructSuperread (654-870)
    def prepare_superread(self, clique: List[int]):
        """sort_vertices + subread filtering for one clique; returns
        (prep_state, consensus_jobs) so many cliques' consensus can be
        batched (the jobs list has 1 entry for single SRs, 2 for paired)."""
        assert len(clique) > 1
        clique = sorted(clique)
        store, s = self.store, self.s
        sr_type = "p"
        base_node = clique[0]
        for node in clique:
            if sr_type == "p" and not store.is_paired[node]:
                base_node = node
                sr_type = "s"

        if sr_type == "p":
            len1, pos1, seqs1, quals1, sorted1 = self.sort_vertices(clique, "l", clique[0])
            len2, pos2, seqs2, quals2, sorted2 = self.sort_vertices(clique, "r", clique[0])
        else:
            len1, pos1, seqs1, quals1, sorted1 = self.sort_vertices(clique, "s", base_node)
            len2, pos2, seqs2, quals2, sorted2 = 0, [], [], [], []

        mcs = s.min_clique_size
        if len(clique) > 3 * mcs:
            f1 = self.filter_subreads(2 * mcs, base_node, sorted1, pos1, seqs1, quals1)
            jobs = [(len1, *f1, s.error_correction)]
            if sr_type == "p":
                f2 = self.filter_subreads(2 * mcs, base_node, sorted2, pos2, seqs2, quals2)
                jobs.append((len2, *f2, s.error_correction))
        else:
            jobs = [(len1, pos1, seqs1, quals1, s.error_correction)]
            if sr_type == "p":
                jobs.append((len2, pos2, seqs2, quals2, s.error_correction))
        prep = (clique, sr_type, len2, pos1, pos2, sorted1, sorted2)
        return prep, jobs

    def finish_superread(self, prep, results) -> Superread:
        """Build the Superread from batched consensus results."""
        clique, sr_type, len2, pos1, pos2, sorted1, sorted2 = prep
        store, g, s = self.store, self.g, self.s
        cons1, q1, trim1 = results[0]
        if sr_type == "p":
            cons2, q2, trim2 = results[1]
        else:
            cons2, q2, trim2 = np.zeros(0, np.int8), np.zeros(0, np.uint8), -1

        sub_map = self.calc_subread_info(trim1, trim2, pos1, pos2, sorted1, sorted2)

        # in reference-order mode the stored key order of every originals
        # dict equals the C++ map's iteration order; the reference ITERATES
        # original_ID_dict entries here (whose C++ iteration order is the
        # oracle permutation of our token-ordered originals_dict) and the
        # new map it builds is reordered again below (SRBuilder.cpp:751-867)
        ref_order = s.reference_order
        originals: Dict[int, OriginalIndex] = {}
        for node in clique:
            sub_id = int(store.ids[node])
            fwd = bool(g.vertex_orientations[node])
            node_subreads = self.originals_dict[sub_id]
            si = sub_map[node]
            idx1 = si.index1 - si.startpos1
            idx2 = si.index2 - si.startpos2
            sub_paired = store.is_paired[node]
            u1, u2 = store.units_of(node)
            key_order = (umap_order(node_subreads.keys()) if ref_order
                         else node_subreads.keys())
            for orig_id in key_order:
                oi = node_subreads[orig_id]
                if orig_id in originals:
                    continue
                new = OriginalIndex(
                    index1=oi.index1, index2=oi.index2, is_paired=oi.is_paired,
                    forward=(oi.forward == fwd), len1=oi.len1, len2=oi.len2)
                if s.first_it:
                    new.index1 = idx1
                    if new.is_paired:
                        new.index2 = idx2
                elif fwd:
                    new.index1 = oi.index1 + idx1
                    if new.is_paired:
                        new.index2 = oi.index2 + (idx2 if si.index2 >= 0 else idx1)
                else:
                    if new.is_paired:
                        if sub_paired:
                            l1 = store.unit_len(u1)
                            l2 = store.unit_len(u2)
                            new.index1 = l1 + idx1 - (oi.len1 + oi.index1)
                            if len2 > 0 or si.index2 >= 0:
                                new.index2 = l2 + idx2 - (oi.len2 + oi.index2)
                            else:
                                new.index2 = l2 + idx1 - (oi.len2 + oi.index2)
                        else:
                            l0 = store.unit_len(u1)
                            new.index1 = l0 + idx1 - (oi.len1 + oi.index1)
                            new.index2 = l0 + idx1 - (oi.len2 + oi.index2)
                    else:
                        l0 = store.unit_len(u1)
                        new.index1 = l0 + idx1 - (oi.len1 + oi.index1)
                originals[orig_id] = new

        if ref_order:
            originals = reorder_map(originals)
        if sr_type == "p":
            return Superread(True, cons1, q1, cons2, q2, sorted1, sorted2, sub_map, originals)
        return Superread(False, cons1, q1, np.zeros(0, np.int8), np.zeros(0, np.uint8),
                         sorted1, [], sub_map, originals)

    def construct_superread(self, clique: List[int]) -> Superread:
        prep, jobs = self.prepare_superread(clique)
        return self.finish_superread(prep, self.batch_consensus(jobs))

    # ------------------------------------------ merge_self_overlap (872-955)
    def merge_self_overlap(self, sr: Superread) -> Superread:
        from ..ops.score import score_tasks_numpy

        min_overlap = 15
        min_score = 0.99
        seq1, seq2 = sr.seq1, sr.seq2
        max_pos = len(seq1) - min_overlap
        if max_pos <= 0:
            return sr
        # batch all candidate overlap positions; pick the LARGEST
        # overlap_pos (smallest overlap) with score > min_score, matching
        # the reference's search order
        w = max(len(seq1), len(seq2))
        codes = np.full((2, w), 5, dtype=np.int8)
        quals = np.zeros((2, w), dtype=np.uint8)
        codes[0, :len(seq1)] = seq1
        quals[0, :len(seq1)] = sr.qual1
        codes[1, :len(seq2)] = seq2
        quals[1, :len(seq2)] = sr.qual2
        lens = np.array([len(seq1), len(seq2)], dtype=np.int64)
        positions = np.arange(len(seq1) - min_overlap, 0, -1, dtype=np.int64)
        ts = score_tasks_numpy(
            codes, quals, lens,
            np.zeros(len(positions), np.int64), np.ones(len(positions), np.int64),
            positions, mismatch_thresh=self.s.mismatch, min_read_len=self.s.min_read_len)
        hits = np.flatnonzero(ts.score > min_score)
        if len(hits) == 0:
            return sr
        overlap_pos = int(positions[hits[0]])
        total_len = len(seq2) + overlap_pos
        cons, cq, _ = self.consensus(
            total_len, [0, overlap_pos], [seq1, seq2], [sr.qual1, sr.qual2],
            error_correction=False)
        if len(cons) == 0:
            return sr
        new_sub: Dict[int, SubreadInfo] = {}
        pairs: List[Tuple[int, int]] = []
        for node, si in sr.subread_map.items():
            si2 = SubreadInfo(si.index1, si.index2, si.startpos1, si.startpos2)
            pairs.append((node, si2.index1))
            if si2.index2 >= 0:
                si2.index2 = si2.index2 + overlap_pos
                pairs.append((node, si2.index2))
            new_sub[node] = si2
        pairs.sort(key=lambda t: t[1])
        new_clique = [p[0] for p in pairs]
        new_orig: Dict[int, OriginalIndex] = {}
        for oid, oi in sr.originals.items():
            oi2 = OriginalIndex(oi.index1, oi.index2, oi.is_paired, oi.forward, oi.len1, oi.len2)
            if oi2.is_paired:
                oi2.index2 = oi2.index2 + overlap_pos
            new_orig[oid] = oi2
        if self.s.reference_order:
            # the reference builds fresh maps by iterating the old ones
            # (SRBuilder.cpp:916-950): one more map-order permutation each
            new_sub = reorder_map(new_sub)
            new_orig = reorder_map(new_orig)
        return Superread(False, cons, cq, np.zeros(0, np.int8), np.zeros(0, np.uint8),
                         new_clique, [], new_sub, new_orig, sr.read_id)

    # ------------------------------------------- process_cliques (958-1029)
    def process_cliques(self, cliques: List[List[int]]) -> int:
        n_before = len(self.single_SR) + len(self.paired_SR)
        # prepare every clique, run ONE batched consensus over all their
        # jobs (the reference's per-clique OpenMP loop, SRBuilder.cpp:972-
        # 1012, vectorized across cliques), then finish each superread
        preps = []
        all_jobs = []
        job_of: List[Tuple[int, int]] = []  # (start, count) per clique
        for clique in cliques:
            prep, jobs = self.prepare_superread(clique)
            preps.append(prep)
            job_of.append((len(all_jobs), len(jobs)))
            all_jobs.extend(jobs)
        all_results = self.batch_consensus(all_jobs)
        for prep, (start, count) in zip(preps, job_of):
            sr = self.finish_superread(prep, all_results[start:start + count])
            if sr.is_paired:
                if len(sr.seq1) and len(sr.seq2):
                    merged = self.merge_self_overlap(sr)
                    if not merged.n_rate_ok():
                        continue
                    (self.paired_SR if merged.is_paired else self.single_SR).append(merged)
            else:
                if len(sr.seq1) and sr.n_rate_ok():
                    self.single_SR.append(sr)
        return len(self.single_SR) + len(self.paired_SR) - n_before

    # ----------------------------------- cliquesToSuperreads (1031-1235)
    def cliques_to_superreads(self, cliques: List[List[int]]) -> None:
        s = self.s
        used_nodes = np.zeros(self.g.n, dtype=bool)
        selected: List[List[int]] = []
        for clique in cliques:
            self.clique_count += 1
            if s.remove_multi_occ:
                clique = [v for v in clique if not used_nodes[v]]
            if len(clique) == 1:
                continue
            if len(clique) >= s.min_clique_size:
                selected.append(clique)
                for v in clique:
                    used_nodes[v] = True
        self.process_cliques(selected)
        self._finalize(include_tip_branch=False)

    # -------------------------------------- mergeAlongEdges (1238-1384)
    def merge_along_edges(self) -> None:
        from ..graph.algos import get_edges_for_merging

        pairs = get_edges_for_merging(self.g)
        self.process_cliques([[a, b] for a, b in pairs])
        self._finalize(include_tip_branch=True)

    def _finalize(self, include_tip_branch: bool) -> None:
        """Mark visited nodes, assign IDs, build trivial superreads.

        ID layout matches the reference's write order: clique/merge singles
        first (0..), then trivials in vertex order, then paired superreads.
        """
        g, store, s = self.g, self.store, self.s
        for sr in self.single_SR:
            for node in sr.sorted_clique1:
                self.visited[node] = True
        for sr in self.paired_SR:
            for node in sr.sorted_clique1:
                self.visited[node] = True

        count = 0
        for sr in self.single_SR:
            sr.read_id = count
            count += 1

        for v in range(g.n):
            if self.visited[v]:
                continue
            if store.read_len(v) < s.keep_singletons:
                self.visited[v] = True
                continue
            total = np.concatenate(
                [store.unit_codes(store.unit1[v])]
                + ([store.unit_codes(store.unit2[v])] if store.is_paired[v] else []))
            if int(np.count_nonzero(total == N_CODE)) >= 0.05 * len(total):
                self.visited[v] = True
                continue
            if include_tip_branch:
                if s.ignore_inclusions and g.inclusions[v]:
                    self.visited[v] = True
                    self.tips.append(v)
                    continue
                if v in g.tip_vertices and s.store_tips_separately:
                    self.visited[v] = True
                    self.tips.append(v)
                    continue
            sub_id = int(store.ids[v])
            subreads = self.originals_dict[sub_id]
            fwd = bool(g.vertex_orientations[v])
            u1, u2 = store.units_of(v)
            paired = store.is_paired[v]
            # reference (SRBuilder.cpp:1163-1224): forward trivials copy the
            # original_ID_dict map (one map-order permutation of our
            # token-ordered dict); reverse trivials iterate that copy and
            # build a NEW map (a second permutation)
            keys = (umap_order(subreads.keys()) if s.reference_order
                    else list(subreads.keys()))
            if fwd:
                sr = Superread(
                    paired,
                    store.unit_codes(u1), store.unit_quals(u1),
                    store.unit_codes(u2) if paired else np.zeros(0, np.int8),
                    store.unit_quals(u2) if paired else np.zeros(0, np.uint8),
                    originals={k: OriginalIndex(
                        subreads[k].index1, subreads[k].index2,
                        subreads[k].is_paired, subreads[k].forward,
                        subreads[k].len1, subreads[k].len2) for k in keys},
                    read_id=count)
            else:
                upd: Dict[int, OriginalIndex] = {}
                if paired:
                    l1, l2 = store.unit_len(u1), store.unit_len(u2)
                    for k in keys:
                        o = subreads[k]
                        upd[k] = OriginalIndex(
                            index1=l1 - (o.index1 + o.len1),
                            index2=l2 - (o.index2 + o.len2),
                            is_paired=o.is_paired, forward=not o.forward,
                            len1=o.len1, len2=o.len2)
                    if s.reference_order:
                        upd = reorder_map(upd)
                    sr = Superread(True, store.unit_codes(u2, False), store.unit_quals(u2, False),
                                   store.unit_codes(u1, False), store.unit_quals(u1, False),
                                   originals=upd, read_id=count)
                else:
                    l0 = store.unit_len(u1)
                    for k in keys:
                        o = subreads[k]
                        upd[k] = OriginalIndex(
                            index1=l0 - (o.index1 + o.len1),
                            index2=(l0 - (o.index2 + o.len2)) if o.is_paired else 0,
                            is_paired=o.is_paired, forward=not o.forward,
                            len1=o.len1, len2=o.len2)
                    if s.reference_order:
                        upd = reorder_map(upd)
                    sr = Superread(False, store.unit_codes(u1, False), store.unit_quals(u1, False),
                                   np.zeros(0, np.int8), np.zeros(0, np.uint8),
                                   originals=upd, read_id=count)
            self.trivial_SR.append(sr)
            self.nodes_to_new_ids[v] = count
            count += 1
        for sr in self.paired_SR:
            sr.read_id = count
            count += 1
        self.new_read_count = count

    # ----------------------------------------------- next-iteration output
    def build_next_store(self) -> Tuple[ReadStore, SubreadDict]:
        """Assemble the next iteration's ReadStore + subread provenance,
        mirroring the singles-then-paired fastq layout the reference writes
        (writeSinglesToFile -> writeTrivialsToFile -> writePairsToFile)."""
        new_store = ReadStore()
        subdict: SubreadDict = {}
        singles = [sr for sr in self.single_SR]
        singles += [sr for sr in self.trivial_SR if not sr.is_paired]
        paired = [sr for sr in self.trivial_SR if sr.is_paired]
        paired += [sr for sr in self.paired_SR]
        for sr in singles:
            new_store.add_single_codes(sr.read_id, sr.seq1, sr.qual1)
            subdict[sr.read_id] = sr.originals
        new_store.readcount_single = len(new_store.ids)
        for sr in paired:
            new_store.add_paired_codes(sr.read_id, sr.seq1, sr.qual1, sr.seq2, sr.qual2)
            subdict[sr.read_id] = sr.originals
        return new_store, subdict
