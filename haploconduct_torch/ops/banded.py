"""Batched banded alignment with traceback (gapped seed extension).

The reference delegates gapped read placement to bwa mem
(savage.py:328-336, polyte.py:300-303, polyte-split.py:256-259). The
built-in replacement seeds diagonals with exact k-mers (ops/align.py) and
extends them here with a banded Needleman-Wunsch that is global in the
read and free at both reference ends, batched over all (read, diagonal)
candidate tasks at once:

- state is kept per *band offset* d = j - i in [0, 2*band] (read position
  i, reference-window position j), so every DP row is a (tasks, 2*band+1)
  vectorized update — the same memory layout a future Pallas port tiles
  onto the VPU;
- deletions chain within a row via an exact max-plus prefix pass over the
  band (band is small, so this is 2*band vector ops per row);
- traceback runs on host from the recorded move matrix and emits
  M/I/D CIGARs that io/sam.sam_to_overlaps consumes unchanged.

Scores are classic match/mismatch/gap unit costs; N never matches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core.reads import N_CODE

NEG = -(1 << 30)


@dataclass
class BandedResult:
    score: np.ndarray  # (B,) best alignment score
    ref_start: np.ndarray  # (B,) window offset where the alignment starts
    ref_end: np.ndarray  # (B,) window offset one past the last aligned ref base
    cigars: List[str]  # per task, read-global M/I/D cigar
    nm: np.ndarray  # (B,) edit operations (mismatch + I + D)
    matches: np.ndarray  # (B,) exact base matches
    aligned_cols: np.ndarray  # (B,) alignment columns (M+I+D)


def banded_align(
    reads: np.ndarray,
    read_lens: np.ndarray,
    windows: np.ndarray,
    band: int,
    match: int = 1,
    mismatch: int = -2,
    gap: int = -3,
    chunk: int = 8192,
    want_traceback: bool = True,
) -> BandedResult:
    """Align reads[t, :read_lens[t]] against windows[t] (width
    read_len + 2*band windows, N/PAD beyond the reference) for every task t.

    Global in the read; the alignment may start at any window offset in
    [0, 2*band] and end wherever the read ends (free outer reference
    gaps). Returns per-task score/coordinates/CIGAR.

    want_traceback=False skips the host traceback (the Python-loop cost):
    score/ref_end stay exact, but ref_start/cigars/nm/matches/aligned_cols
    come back zeroed — use as a cheap score prefilter, then re-align the
    survivors with traceback on.
    """
    B = len(reads)
    out_score = np.full(B, NEG, dtype=np.int32)
    out_start = np.zeros(B, dtype=np.int32)
    out_end = np.zeros(B, dtype=np.int32)
    out_nm = np.zeros(B, dtype=np.int32)
    out_match = np.zeros(B, dtype=np.int32)
    out_cols = np.zeros(B, dtype=np.int32)
    cigars: List[str] = [""] * B
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        res = _banded_chunk(reads[lo:hi], read_lens[lo:hi], windows[lo:hi],
                            band, match, mismatch, gap, want_traceback)
        (out_score[lo:hi], out_start[lo:hi], out_end[lo:hi], cg,
         out_nm[lo:hi], out_match[lo:hi], out_cols[lo:hi]) = res
        cigars[lo:hi] = cg
    return BandedResult(out_score, out_start, out_end, cigars, out_nm,
                        out_match, out_cols)


def _banded_chunk(reads, read_lens, windows, band, match, mismatch, gap,
                  want_traceback: bool = True):
    B, L = reads.shape
    W = 2 * band + 1
    lens = read_lens.astype(np.int64)

    # S[d] = best score with read[:i] consumed, ref consumed to j = i + d
    S = np.zeros((B, W), dtype=np.int32)  # row i=0: free leading ref
    # 0 diag, 1 ins(read), 2 del(ref)
    tb = np.zeros((B, L + 1, W), dtype=np.int8) if want_traceback else None
    col = np.arange(W, dtype=np.int64)

    for i in range(L):
        ri = reads[:, i:i + 1]  # (B,1)
        # ref char at j = i + d for each d
        jidx = np.minimum(i + col[None, :], windows.shape[1] - 1)
        wch = np.take_along_axis(windows, jidx, axis=1)
        sub = np.where((ri == wch) & (ri < N_CODE), match, mismatch).astype(np.int32)

        diag_mv = S + sub  # -> row i+1, same d
        ins_mv = np.full_like(S, NEG)
        ins_mv[:, :-1] = S[:, 1:] + gap  # from (i, d+1) -> (i+1, d)
        nxt = np.where(diag_mv >= ins_mv, diag_mv, ins_mv)
        moves = np.where(diag_mv >= ins_mv, 0, 1).astype(np.int8)
        # del chain within row i+1: from (i+1, d-1) -> (i+1, d)
        for d in range(1, W):
            cand = nxt[:, d - 1] + gap
            better = cand > nxt[:, d]
            nxt[:, d] = np.where(better, cand, nxt[:, d])
            moves[:, d] = np.where(better, 2, moves[:, d])
        # rows beyond the read length hold their previous values
        active = i < lens
        S = np.where(active[:, None], nxt, S)
        if want_traceback:
            tb[:, i + 1, :] = np.where(active[:, None], moves, 0)

    best_d = np.argmax(S, axis=1).astype(np.int64)
    score = S[np.arange(B), best_d]
    ref_end = lens + best_d

    if not want_traceback:
        z = np.zeros(B, dtype=np.int32)
        return (score, z, ref_end.astype(np.int32), [""] * B,
                z.copy(), z.copy(), z.copy())

    # host traceback
    starts = np.zeros(B, dtype=np.int32)
    nms = np.zeros(B, dtype=np.int32)
    nmatch = np.zeros(B, dtype=np.int32)
    cols_out = np.zeros(B, dtype=np.int32)
    cigars: List[str] = []
    for t in range(B):
        i = int(lens[t])
        d = int(best_d[t])
        ops: List[List] = []
        nm = mt = cols = 0
        while i > 0:
            mv = tb[t, i, d]
            if mv == 0:
                j = i - 1 + d
                _push(ops, "M")
                if 0 <= j < windows.shape[1] and reads[t, i - 1] == windows[t, j] \
                        and reads[t, i - 1] < N_CODE:
                    mt += 1
                else:
                    nm += 1
                i -= 1
                cols += 1
            elif mv == 1:
                _push(ops, "I")
                i -= 1
                d += 1
                nm += 1
                cols += 1
            else:
                _push(ops, "D")
                d -= 1
                nm += 1
                cols += 1
        starts[t] = d
        nms[t] = nm
        nmatch[t] = mt
        cols_out[t] = cols
        cigars.append("".join(f"{n}{op}" for n, op in reversed(ops)) or "*")
    return score, starts, ref_end.astype(np.int32), cigars, nms, nmatch, cols_out


def _push(ops: List[List], op: str) -> None:
    if ops and ops[-1][1] == op:
        ops[-1][0] += 1
    else:
        ops.append([1, op])


def extract_windows(ref: np.ndarray, diags: np.ndarray, L: int, band: int,
                    pad_code: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather per-task reference windows ref[diag-band : diag+L+band],
    padding outside the reference with `pad_code`. Returns (windows,
    window_starts)."""
    B = len(diags)
    Wr = L + 2 * band
    ws = diags.astype(np.int64) - band
    idx = ws[:, None] + np.arange(Wr, dtype=np.int64)[None, :]
    valid = (idx >= 0) & (idx < len(ref))
    win = np.full((B, Wr), pad_code, dtype=ref.dtype)
    win[valid] = ref[np.clip(idx, 0, len(ref) - 1)[valid]]
    return win, ws
