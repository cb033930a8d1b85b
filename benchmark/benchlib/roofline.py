"""The least time the card could take for a call of the scoring kernel,
frozen from chip_smoke.py:score_bound so that the program cannot change
the yardstick. Published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, at the full 700 W): HBM3 at 3.35 TB/s, FP32 at 67 TFLOP/s outside
the tensor cores."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def score_bound(lens, row_a, row_b, pos):
    """(ms, "bytes" | "operations") for one call of score_tasks. Bytes, at
    the HBM rate: the int16 words of the matrix that some task reads, each
    once (per row the union of the a spans [pos, pos + L) and the b spans
    [0, L)), the length of each row a task names, 12 B of columns and 20 B
    of results a task. Operations, at the FP32 rate: one f32 add for each
    lane the tasks cover. L = min(len_a - pos, len_b), at least 0."""
    lens = np.asarray(lens, dtype=np.int64)
    row_a = np.asarray(row_a, dtype=np.int64)
    row_b = np.asarray(row_b, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    L = np.maximum(np.minimum(lens[row_a] - pos, lens[row_b]), 0)
    rows = np.concatenate([row_a, row_b])
    start = np.concatenate([pos, np.zeros_like(pos)])
    end = start + np.concatenate([L, L])
    keep = end > start
    rows, start, end = rows[keep], start[keep], end[keep]
    w = int(lens.max()) + 1  # every span ends within its row
    order = np.argsort(rows * w + start, kind="stable")
    rows, start, end = rows[order], start[order], end[order]
    # the furthest end that an earlier span of the same row reached
    reach = np.maximum.accumulate(rows * w + end)
    prev = np.concatenate([[-1], reach[:-1]])
    prev_end = np.where(prev // w == rows, prev % w, 0)
    words = int(np.maximum(end - np.maximum(start, prev_end), 0).sum())
    named = np.unique(np.concatenate([row_a, row_b])).size
    moved = 2 * words + 4 * named + len(row_a) * (12 + 20)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = int(L.sum()) / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")
