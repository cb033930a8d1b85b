"""Overlap scoring on a torch device — twin of haploconduct_tpu/ops/score.py
(score_tasks_jax, xla_segment_body) and of the host half of
ops/pallas_score.py (pack_for_pallas, score_tasks_pallas).

Tasks are cut into SEG=512-lane subtasks by the reference's segment_tasks,
scored per subtask (f32 sum of log p, exact int32 counts), and summed back
per task in f64 by the reference's reduce_segments_to_tasks. On a CUDA
tensor the subtasks go through the hand-written kernel
(ops/kernels.py:score_segments_cuda); on a CPU tensor through
segment_scores_torch, the kernel's plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from haploconduct_tpu.core.reads import N_CODE
from haploconduct_tpu.ops.pallas_score import SEG, segment_tasks
from haploconduct_tpu.ops.score import TaskScores, reduce_segments_to_tasks

from .kernels import score_segments_cuda

LOG10_OVER_10 = float(np.log(10.0) / 10.0)
# subtasks per step of the plain version: its (chunk, SEG) temporaries
# stay at tens of MB however long the stream is
PLAIN_CHUNK = 1 << 14


def pack_for_device(codes: np.ndarray, quals: np.ndarray, device) -> torch.Tensor:
    """(R, W) codes/quals -> (R, W) int16 code | qual << 3 words on
    `device` (the word layout of pallas_score.pack_for_pallas, without its
    TPU-only row rounding and slack columns)."""
    comb = codes.astype(np.int16) | (quals.astype(np.int16) << 3)
    return torch.from_numpy(comb).to(device)


def segment_scores_torch(comb: torch.Tensor, rowa: torch.Tensor,
                         rowb: torch.Tensor, posa: torch.Tensor,
                         bolen: torch.Tensor, mismatch_thresh: float):
    """Plain PyTorch version of the scoring kernel (twin of
    xla_segment_body): per subtask (sum_log f32, counted, mismatches,
    rejected int32). Lanes past seg_len are masked; their clamped
    gathers stay inside the row."""
    n = rowa.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.float32, device=comb.device),
                *(torch.zeros(0, dtype=torch.int32, device=comb.device)
                  for _ in range(3)))
    rw = comb.shape[1]
    flat = comb.reshape(-1)
    col = torch.arange(SEG, device=comb.device, dtype=torch.int64)[None, :]
    outs = ([], [], [], [])
    for s in range(0, n, PLAIN_CHUNK):
        e = min(s + PLAIN_CHUNK, n)
        bl = bolen[s:e].to(torch.int64)
        k, lt = bl >> 10, bl & 1023
        a_idx = torch.clamp(posa[s:e].to(torch.int64)[:, None] + col, max=rw - 1)
        b_idx = torch.clamp((k * SEG)[:, None] + col, max=rw - 1)
        a_w = flat[rowa[s:e].to(torch.int64)[:, None] * rw + a_idx].to(torch.int32)
        b_w = flat[rowb[s:e].to(torch.int64)[:, None] * rw + b_idx].to(torch.int32)
        a, b = a_w & 7, b_w & 7
        cm = (col < lt[:, None]) & (a < N_CODE) & (b < N_CODE)
        p1 = torch.exp((a_w >> 3).to(torch.float32) * (-LOG10_OVER_10))
        p2 = torch.exp((b_w >> 3).to(torch.float32) * (-LOG10_OVER_10))
        match = a == b
        p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) * (1.0 / 3.0)
        p_mis = ((p1 * (1.0 - p2) + p2 * (1.0 - p1)) * (1.0 / 3.0)
                 + (2.0 / 9.0) * (p1 * p2))
        p = torch.where(match, p_match, p_mis)
        outs[0].append(torch.where(cm, torch.log(p), 0.0).sum(dim=1))
        outs[1].append(cm.sum(dim=1, dtype=torch.int32))
        outs[2].append((cm & ~match).sum(dim=1, dtype=torch.int32))
        outs[3].append((cm & (p < mismatch_thresh)).sum(dim=1, dtype=torch.int32))
    return tuple(torch.cat(o) for o in outs)


def segment_scores(comb: torch.Tensor, rowa, rowb, posa, bolen,
                   mismatch_thresh: float):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if comb.is_cuda:
        return score_segments_cuda(comb, rowa, rowb, posa, bolen, mismatch_thresh)
    if comb.device.type != "cpu":
        raise ValueError(f"no scoring kernel for device {comb.device}")
    return segment_scores_torch(comb, rowa, rowb, posa, bolen, mismatch_thresh)


def score_tasks_torch(
    codes: np.ndarray,
    quals: np.ndarray,
    lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
    device="cpu",
) -> TaskScores:
    """Score tasks on `device`; the contract of score_tasks_jax /
    score_tasks_pallas (a TaskScores of numpy arrays). On a CUDA device
    the kernel runs or this raises; it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("score_tasks_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    b = len(row_a)
    if b == 0:
        z = np.zeros(0)
        return TaskScores(z, z, z, z.astype(np.int64), z.astype(np.int64),
                          z.astype(bool))
    lens = np.asarray(lens_by_row).astype(np.int64)
    r, w = codes.shape
    row_a = np.asarray(row_a, np.int64)
    row_b = np.asarray(row_b, np.int64)
    # the kernel gathers without bounds checks: validate what it trusts
    if len(lens) != r or int(lens.max()) > w or int(lens.min()) < 0:
        raise ValueError("lens_by_row must give one length <= width per row")
    if min(int(row_a.min()), int(row_b.min())) < 0 or \
            max(int(row_a.max()), int(row_b.max())) >= r:
        raise ValueError("task row ids out of range")
    pos64 = np.asarray(pos, dtype=np.int64)
    if int(pos64.min()) < 0:
        raise ValueError("task positions must be >= 0")
    len_a = lens[row_a]
    len_b = lens[row_b]
    L = np.minimum(len_a - pos64, len_b)
    L = np.where(pos64 >= len_a, 0, L)
    s_rowa, s_rowb, s_posa, s_bolen, bounds = segment_tasks(row_a, row_b, pos64, L)

    comb = pack_for_device(codes, quals, device)
    cols = [torch.from_numpy(c).to(device) for c in (s_rowa, s_rowb, s_posa, s_bolen)]
    sub = segment_scores(comb, *cols, float(mismatch_thresh))
    sub_cols = [c.cpu().numpy() for c in sub]
    return reduce_segments_to_tasks(sub_cols, bounds, pos64, len_a, len_b,
                                    int(min_read_len))
