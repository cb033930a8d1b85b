"""Built-in read-to-reference aligner (seed + banded gapped extension).

Stands in for bwa mem in reference-guided mode when no external aligner is
installed (the reference shells out to bwa at savage.py:328-336 /
polyte.py:300-303; this environment has none). Seeds each read against the
reference with exact k-mers on both strands, clusters seeds by diagonal,
and extends the best diagonal clusters with the batched banded
Needleman-Wunsch (ops/banded.py) — global in the read, free at both
reference ends — emitting M/I/D CIGARs, so reads from strains carrying
indels relative to the reference still place (bwa-like behavior; the
previous gapless version dropped ~17% of the savage/example reads).

Limitations vs bwa: no split/supplementary alignments, no soft-clipping,
no mapping-quality model (MAPQ = 60 for an accepted best alignment).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import N_CODE, PAD_CODE, ReadStore, decode_seq, revcomp_codes
from ..io.sam import SamRecord
from .kmer import _kmer_hashes


class ReferenceIndex:
    def __init__(self, names: List[str], seqs: List[np.ndarray], k: int = 18):
        self.names = names
        self.seqs = seqs
        self.k = k
        hashes = []
        rids = []
        pos = []
        for r, sq in enumerate(seqs):
            h = _kmer_hashes(sq, k)
            keep = h >= 0
            hashes.append(h[keep])
            rids.append(np.full(int(keep.sum()), r, dtype=np.int64))
            pos.append(np.flatnonzero(keep).astype(np.int64))
        self.h = np.concatenate(hashes) if hashes else np.zeros(0, np.int64)
        order = np.argsort(self.h, kind="stable")
        self.h = self.h[order]
        self.rid = np.concatenate(rids)[order] if hashes else np.zeros(0, np.int64)
        self.pos = np.concatenate(pos)[order] if hashes else np.zeros(0, np.int64)

    @classmethod
    def from_fasta(cls, path: str, k: int = 18) -> "ReferenceIndex":
        from ..io.fastq import read_fasta
        from ..core.reads import encode_seq

        ids, seqs = read_fasta(path)
        return cls(ids, [encode_seq(s) for s in seqs], k)

    def lengths(self) -> Dict[str, int]:
        return {n: len(s) for n, s in zip(self.names, self.seqs)}


def _best_diagonal(index: ReferenceIndex, codes: np.ndarray, max_candidates: int = 8):
    """Candidate (ref, diag, seed_count) list for one read orientation."""
    h = _kmer_hashes(codes, index.k)
    qpos = np.flatnonzero(h >= 0)
    h = h[h >= 0]
    if len(h) == 0:
        return []
    left = np.searchsorted(index.h, h, side="left")
    right = np.searchsorted(index.h, h, side="right")
    counts = right - left
    total = int(counts.sum())
    if total == 0:
        return []
    q_idx = np.repeat(np.arange(len(h)), counts)
    csum = np.cumsum(counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(csum - counts, counts)
    t_idx = np.repeat(left, counts) + offs
    rids = index.rid[t_idx]
    diag = index.pos[t_idx] - qpos[q_idx]
    key = rids * (1 << 32) + (diag + (1 << 30))
    uniq, cnt = np.unique(key, return_counts=True)
    order = np.argsort(-cnt)[:max_candidates]
    out = []
    for u, c in zip(uniq[order], cnt[order]):
        out.append((int(u >> 32), int((u & 0xFFFFFFFF) - (1 << 30)), int(c)))
    return out


def _gapless_mismatches(ref_seq: np.ndarray, codes: np.ndarray, diag: int) -> Tuple[int, int]:
    """(#mismatches over aligned span, aligned length) for read placed at
    ref position `diag` (may be clipped at either end)."""
    start = max(0, diag)
    end = min(len(ref_seq), diag + len(codes))
    if end <= start:
        return (1 << 30), 0
    w_ref = ref_seq[start:end]
    w_read = codes[start - diag:end - diag]
    valid = (w_ref < N_CODE) & (w_read < N_CODE)
    mism = int(np.count_nonzero(valid & (w_ref != w_read)))
    return mism, int(np.count_nonzero(valid))


def _cluster_diagonals(cands, band: int):
    """Merge candidate diagonals within +-band of a kept (higher seed
    count) one; cands arrive sorted by descending count."""
    reps = []
    for rid, diag, cnt in cands:
        if any(r == rid and abs(d - diag) <= band for r, d, _ in reps):
            continue
        reps.append((rid, diag, cnt))
    return reps


def align_store(
    store: ReadStore,
    index: ReferenceIndex,
    max_mismatch_rate: float = 0.25,
    band: int = 16,
    max_diagonals: int = 4,
) -> Tuple[List[SamRecord], List[Tuple[SamRecord, SamRecord, bool]]]:
    """Align all reads; returns (single records, paired tuples) in the
    shapes io/sam.sam_to_overlaps expects. Each read end is seeded on both
    strands, its diagonal clusters are banded-extended in one batch, and
    the best-scoring accepted alignment becomes the SAM record."""
    from .banded import banded_align, extract_windows

    # one alignment unit per read end: (name, read idx, end, codes, qual)
    units = []
    for i in range(len(store)):
        rid = int(store.ids[i])
        u1, u2 = store.units_of(i)
        if not store.is_paired[i]:
            units.append((str(rid), i, 0, store.unit_codes(u1), store.phred_str(i, 0)))
        else:
            units.append((str(rid), i, 1, store.unit_codes(u1), store.phred_str(i, 1)))
            units.append((str(rid), i, 2, store.unit_codes(u2), store.phred_str(i, 2)))
    if not units:
        return [], []

    # seed + cluster candidate diagonals
    tasks = []  # (unit idx, rev, ref id, diag)
    for uidx, (_, _, _, codes, _) in enumerate(units):
        for rev in (False, True):
            c = revcomp_codes(codes) if rev else codes
            cands = _best_diagonal(index, c, max_candidates=4 * max_diagonals)
            for ridx, diag, _ in _cluster_diagonals(cands, band)[:max_diagonals]:
                tasks.append((uidx, rev, ridx, diag))

    best: Dict[int, Tuple] = {}  # unit idx -> (key, task fields, result row)
    if tasks:
        Lmax = max(len(u[3]) for u in units)
        T = len(tasks)
        reads = np.full((T, Lmax), PAD_CODE, dtype=np.int8)
        lens = np.zeros(T, dtype=np.int64)
        for t, (uidx, rev, _, _) in enumerate(tasks):
            c = units[uidx][3]
            c = revcomp_codes(c) if rev else c
            reads[t, :len(c)] = c
            lens[t] = len(c)
        windows = np.full((T, Lmax + 2 * band), PAD_CODE, dtype=np.int8)
        win_starts = np.zeros(T, dtype=np.int64)
        by_rid: Dict[int, List[int]] = {}
        for t, (_, _, ridx, _) in enumerate(tasks):
            by_rid.setdefault(ridx, []).append(t)
        for ridx, tlist in by_rid.items():
            diags = np.array([tasks[t][3] for t in tlist], dtype=np.int64)
            win, ws = extract_windows(index.seqs[ridx], diags, Lmax, band,
                                      pad_code=PAD_CODE)
            windows[tlist] = win
            win_starts[tlist] = ws
        res = banded_align(reads, lens, windows, band)
        for t, (uidx, rev, ridx, _) in enumerate(tasks):
            cols = int(res.aligned_cols[t])
            if cols == 0 or res.nm[t] > max_mismatch_rate * cols:
                continue
            pos0 = int(win_starts[t]) + int(res.ref_start[t])
            if pos0 < 0:
                continue
            key = (-int(res.score[t]), int(res.nm[t]))
            if uidx not in best or key < best[uidx][0]:
                best[uidx] = (key, (rev, ridx, pos0, res.cigars[t]))

    recs: Dict[Tuple[int, int], SamRecord] = {}
    for uidx, (name, i, end, codes, qual_str) in enumerate(units):
        if uidx not in best:
            continue
        rev, ridx, pos0, cigar = best[uidx][1]
        c = revcomp_codes(codes) if rev else codes
        q = qual_str[::-1] if rev else qual_str
        recs[(i, end)] = SamRecord(
            qname=name, flag=16 if rev else 0, rname=index.names[ridx],
            pos=pos0 + 1, mapq=60, cigar=cigar, seq=decode_seq(c), qual=q)

    singles: List[SamRecord] = []
    paired: List[Tuple[SamRecord, SamRecord, bool]] = []
    for i in range(len(store)):
        if not store.is_paired[i]:
            rec = recs.get((i, 0))
            if rec is not None:
                singles.append(rec)
        else:
            rec1, rec2 = recs.get((i, 1)), recs.get((i, 2))
            if rec1 is None or rec2 is None:
                continue
            # pairing rules mirror read_paired_sam_to_list
            # (scripts/sam2overlaps.py:237-257)
            if rec1.pos >= rec2.pos:
                if rec1.reverse and rec2.reverse:
                    paired.append((rec2, rec1, True))
            else:
                if not rec1.reverse and not rec2.reverse:
                    paired.append((rec1, rec2, False))
    return singles, paired
