"""The plain reference that decides `correct`. It imports numpy and torch
alone, nothing of the program, and works out again from reads, candidate
overlaps and contig layouts what the program derived from them.

Overlap scoring follows SAVAGE's EdgeCalculator (Baaijens et al. 2017;
src/EdgeCalculator.cpp:26-139 of the original): for the aligned windows
a[pos:] and b[0:], each position where neither base is N contributes the
probability p that both bases were read from one haplotype, from the phred
error probabilities p1 and p2,

    match:    p = (1 - p1)(1 - p2) + p1 p2 / 3
    mismatch: p = (p1 (1 - p2) + p2 (1 - p1)) / 3 + (2/9) p1 p2,

an overlap with some p below the hard threshold is rejected, and otherwise
score = exp(mean log p) and mismatch rate = mismatches / counted. An
overlap is an edge when score > edge threshold or mismatch rate <= the
merge threshold, a non-edge when it is not an edge and score > the
overlap threshold. Every sum is taken in the given dtype: float64 is the
reference, float32 the control (the same formulas a step lower).

Contigs are judged twice: against the reads that the program says each is
made of (a clear majority of them must carry its base, and every base must
lie under one of them), and against the haplotypes the traffic drew, which
the program never sees (each contig placed where it fits best, its
mismatches there counted, and the share of each haplotype that the
placements leave uncovered).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

N_CODE, PAD_CODE = 4, 5
_ENCODE = np.full(256, N_CODE, dtype=np.int8)
for _ch, _code in zip(b"ACGT", range(4)):
    _ENCODE[_ch] = _code
_COMPLEMENT = np.array([3, 2, 1, 0, N_CODE, PAD_CODE], dtype=np.int8)

EDGE, NONEDGE, NEITHER = 2, 1, 0


def encode(seq: str) -> np.ndarray:
    return _ENCODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def phreds(qual: str) -> np.ndarray:
    return (np.frombuffer(qual.encode(), dtype=np.uint8) - 33).astype(np.uint8)


def oriented_rows(units: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """(codes, quals, lens_by_row): row i is unit i forward, row U + i its
    reverse complement (bases complemented, qualities reversed); padding
    is PAD_CODE with quality 0."""
    u = len(units)
    lens = np.array([len(c) for c, _ in units], dtype=np.int64)
    w = int(lens.max(initial=1))
    codes = np.full((2 * u, w), PAD_CODE, dtype=np.int8)
    quals = np.zeros((2 * u, w), dtype=np.uint8)
    for i, (c, q) in enumerate(units):
        n = len(c)
        codes[i, :n] = c
        quals[i, :n] = q
        codes[u + i, :n] = _COMPLEMENT[c[::-1]]
        quals[u + i, :n] = q[::-1]
    return codes, quals, np.concatenate([lens, lens])


def single_end_tasks(ids: np.ndarray, id1, id2, ori1, ori2, pos1):
    """Rows and offsets of the one task of each single-end overlap: read
    id1 in its orientation from pos1 against read id2 in its orientation.
    `ids[i]` is the id of unit i; an id that no unit has raises."""
    ids = np.asarray(ids, dtype=np.int64)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]

    def index(of):
        of = np.asarray(of, dtype=np.int64)
        at = np.minimum(np.searchsorted(sorted_ids, of), len(ids) - 1)
        if len(of) and not np.array_equal(sorted_ids[at], of):
            raise KeyError("an overlap names a read that is not there")
        return order[at]

    ia, ib = index(id1), index(id2)
    u = len(ids)
    row_a = np.where(ori1, ia, ia + u)
    row_b = np.where(ori2, ib, ib + u)
    return ia, ib, row_a, row_b, np.asarray(pos1, dtype=np.int64)


def score_tasks(codes, quals, lens_by_row, row_a, row_b, pos, *,
                mismatch_thresh: float, min_read_len: int, dtype, device,
                elements: int = 1 << 25) -> dict:
    """Score every task in blocks on `device`; numpy results: score and
    mismatch_rate (in `dtype`, returned as float64), counted, mismatches,
    rejected."""
    n = len(row_a)
    w = codes.shape[1]
    out = {"score": np.zeros(n), "mismatch_rate": np.ones(n),
           "counted": np.zeros(n, np.int64), "mismatches": np.zeros(n, np.int64),
           "rejected": np.zeros(n, bool)}
    if n == 0:
        return out
    c_dev = torch.from_numpy(codes).to(device)
    q_dev = torch.from_numpy(quals).to(device)
    len_dev = torch.from_numpy(lens_by_row.astype(np.int64)).to(device)
    col = torch.arange(w, device=device)[None, :]
    block = max(1, elements // w)
    ten = torch.tensor(10.0, dtype=dtype, device=device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        ra = torch.from_numpy(row_a[lo:hi]).to(device)
        rb = torch.from_numpy(row_b[lo:hi]).to(device)
        ps = torch.from_numpy(pos[lo:hi]).to(device)
        idx = torch.clamp(ps[:, None] + col, max=w - 1)
        a = torch.gather(c_dev[ra], 1, idx)
        qa = torch.gather(q_dev[ra], 1, idx)
        b = c_dev[rb]
        qb = q_dev[rb]
        len_a, len_b = len_dev[ra], len_dev[rb]
        span = torch.minimum(len_a - ps, len_b)
        counted = (col < span[:, None]) & (a < N_CODE) & (b < N_CODE)
        match = a == b
        p1 = torch.pow(ten, -qa.to(dtype) / 10)
        p2 = torch.pow(ten, -qb.to(dtype) / 10)
        p = torch.where(match, (1 - p1) * (1 - p2) + p1 * p2 / 3,
                        (p1 * (1 - p2) + p2 * (1 - p1)) / 3 + (2.0 / 9.0) * p1 * p2)
        if mismatch_thresh > 0.0:
            rejected = (counted & (p < mismatch_thresh)).any(dim=1)
        else:
            rejected = torch.zeros(hi - lo, dtype=torch.bool, device=device)
        sum_log = torch.where(counted, torch.log(p), torch.zeros((), dtype=dtype,
                                                                 device=device)).sum(dim=1)
        cnt = counted.sum(dim=1)
        mism = (counted & ~match).sum(dim=1)
        degenerate = (ps >= len_a) | (len_a < min_read_len) | (len_b < min_read_len) | (cnt == 0)
        ok = ~degenerate & ~rejected
        denom = torch.clamp(cnt, min=1).to(dtype)
        score = torch.where(ok, torch.exp(sum_log / denom), torch.zeros((), dtype=dtype,
                                                                       device=device))
        rate = torch.where(ok, mism.to(dtype) / denom, torch.ones((), dtype=dtype,
                                                                  device=device))
        out["score"][lo:hi] = score.double().cpu().numpy()
        out["mismatch_rate"][lo:hi] = rate.double().cpu().numpy()
        out["counted"][lo:hi] = cnt.cpu().numpy()
        out["mismatches"][lo:hi] = mism.cpu().numpy()
        out["rejected"][lo:hi] = rejected.cpu().numpy()
    return out


def decisions(score, mismatch_rate, edge_threshold, ov_threshold, merge_contigs):
    """EDGE, NONEDGE or NEITHER for each overlap."""
    edge = (score > edge_threshold) | (mismatch_rate <= merge_contigs)
    nonedge = ~edge & (score > ov_threshold)
    return np.where(edge, EDGE, np.where(nonedge, NONEDGE, NEITHER)).astype(np.int8)


def consensus_disagreements(contigs: List[np.ndarray],
                            layouts: List[List[Tuple[np.ndarray, int, bool]]],
                            min_depth: int = 5, majority: float = 0.8):
    """Each contig against the original reads that the program says it is
    made of: each read is laid at its stated offset, reverse-complemented
    when it lies backwards. A position is judged where at least
    `min_depth` reads cover it and at least `majority` of them agree, and
    disagrees where the contig carries another base. A position that no
    read covers is unsupported (a contig whose layout is empty is
    unsupported everywhere), and a read's base laid before the contig's
    start or past its end is outside it. Returns (disagreements, judged,
    unsupported, read bases outside, read bases laid)."""
    bad = judged = unsupported = outside = laid = 0
    for contig, layout in zip(contigs, layouts):
        length = len(contig)
        counts = np.zeros((length, 4), dtype=np.int64)
        cols, bases = [], []
        for read, offset, forward in layout:
            r = read if forward else _COMPLEMENT[read[::-1]]
            at = offset + np.arange(len(r))
            inside = (at >= 0) & (at < length)
            outside += int((~inside).sum())
            laid += len(r)
            keep = inside & (r < N_CODE)
            cols.append(at[keep])
            bases.append(r[keep].astype(np.int64))
        if cols:
            np.add.at(counts, (np.concatenate(cols), np.concatenate(bases)), 1)
        depth = counts.sum(axis=1)
        top = counts.max(axis=1) if length else depth
        sure = (depth >= min_depth) & (top >= majority * depth)
        judged += int(sure.sum())
        bad += int((sure & (counts.argmax(axis=1) != contig)).sum())
        unsupported += int((depth == 0).sum())
    return bad, judged, unsupported, outside, laid


def _kmer_keys(codes: np.ndarray, k: int):
    """(keys, valid) of every k-mer of `codes`, two bits a base; a k-mer
    holding a base other than A, C, G, T is not valid."""
    if len(codes) < k:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    ok = (codes >= 0) & (codes < 4)
    c = np.where(ok, codes, 0).astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(c, k)
    keys = win @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    return keys, np.lib.stride_tricks.sliding_window_view(ok, k).all(axis=1)


class HaplotypeIndex:
    """The k-mers of every haplotype of a unit in both orientations, for
    placing contigs on them without gaps."""

    def __init__(self, haps: List[np.ndarray], k: int = 20, offsets: int = 3):
        self.haps, self.k, self.offsets = haps, k, offsets
        self.targets = []
        for h, hap in enumerate(haps):
            for forward in (True, False):
                seq = hap if forward else _COMPLEMENT[hap[::-1]]
                keys, valid = _kmer_keys(seq, k)
                pos = np.flatnonzero(valid)
                order = np.argsort(keys[pos], kind="stable")
                self.targets.append((h, forward, seq, keys[pos][order], pos[order]))

    def place(self, contig: np.ndarray):
        """(mismatches, [(haplotype, start, end), ...]) of the contig's best
        ungapped placement: the offsets most k-mers vote for on each
        haplotype and strand are tried, and those with fewest mismatches
        are kept (one a haplotype: a stretch where haplotypes agree fits
        each of them). A base hanging past a haplotype's end counts as a
        mismatch; start and end are forward coordinates of the haplotype.
        A contig with no k-mer on any haplotype is all mismatches and
        placed nowhere."""
        m = len(contig)
        best, where = m, []
        keys, valid = _kmer_keys(contig, self.k)
        q_pos = np.flatnonzero(valid)
        q_keys = keys[q_pos]
        for h, forward, seq, t_keys, t_pos in self.targets:
            if len(t_keys) == 0:
                continue
            at = np.minimum(np.searchsorted(t_keys, q_keys), len(t_keys) - 1)
            hit = t_keys[at] == q_keys
            if not hit.any():
                continue
            diag, votes = np.unique(t_pos[at[hit]] - q_pos[hit], return_counts=True)
            g = len(seq)
            for off in diag[np.argsort(-votes, kind="stable")[: self.offsets]]:
                j = np.arange(m) + int(off)
                inside = (j >= 0) & (j < g)
                mism = int((~inside).sum()) + int(
                    (seq[j[inside]] != contig[inside]).sum())
                if mism > best:
                    continue
                lo, hi = max(int(off), 0), min(int(off) + m, g)
                if not forward:
                    lo, hi = g - hi, g - lo
                if mism < best:
                    best, where = mism, []
                if all(w[0] != h for w in where):
                    where.append((h, lo, hi))
        return best, where


def haplotype_agreement(contig_sets: List[List[np.ndarray]], haps: List[np.ndarray]):
    """A unit's contigs against the haplotypes its reads were drawn from:
    (mismatches of every contig at its best placement, bases of all
    contigs, the largest share of a haplotype that no contig of any set
    covers, the largest mismatch share of one contig)."""
    index = HaplotypeIndex(haps)
    covered = [np.zeros(len(h), bool) for h in haps]
    mism = bases = 0
    worst = 0.0
    for contig in (c for cs in contig_sets for c in cs):
        mm, where = index.place(contig)
        mism += mm
        bases += len(contig)
        if len(contig):
            worst = max(worst, mm / len(contig))
        for h, lo, hi in where:
            covered[h][lo:hi] = True
    uncovered = max((1.0 - c.mean() for c in covered), default=0.0)
    return mism, bases, float(uncovered), worst
