"""Pairwise quality-aware overlap scoring — the assembler's hot loop, on a
torch device.

Math (reference src/EdgeCalculator.cpp:26-139): for an aligned pair of
sequence windows, each position contributes the probability that both bases
were sequenced from the same haplotype, derived from the two phred error
probabilities p1, p2:

    match:     p = (1-p1)(1-p2) + p1*p2/3
    mismatch:  p = (p1*(1-p2) + p2*(1-p1))/3 + (2/9)*p1*p2
    either N:  position skipped entirely

If any counted position has p < `mismatch_thresh` the overlap is rejected
outright. Otherwise score = exp(mean log p) over counted positions and
mismatch_rate = #mismatches / #counted.

A *task* is (row_a, row_b, pos): score row_a[pos:] against row_b[0:], with
rows taken from a PackedUnits matrix (orientation pre-resolved by row
index). Degenerate cases (pos >= len_a, read shorter than min_read_len,
zero counted positions) score 0 with mismatch_rate 1.0, exactly as the
reference's early returns leave it (src/EdgeCalculator.cpp:74-84, 129-131).

Backends:
- score_tasks_numpy (float64): the oracle.
- score_tasks_native (C++ OpenMP, float64): the host engine.
- score_tasks_torch (float32 lanes): per task on a CUDA device through the
  hand-written kernel (ops/kernels.py:score_tasks_cuda), on the CPU through
  score_tasks_plain, the kernel's plain PyTorch version, each over a mesh
  of one or more entries (parallel/mesh.py:sharded_score_tasks). Both sum
  log p in f32 over at most SEG=512 lanes and add those segment sums per
  task in f64, so callers can re-check any result within RECHECK_MARGIN
  of a decision threshold on the oracle and f32 rounding never flips an
  edge decision.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.reads import N_CODE, PAD_CODE
from ..parallel.devices import default_device
from .kernels import score_tasks_cuda

RECHECK_MARGIN = 2e-3  # |score - threshold| below this -> redo in f64
SEG = 512  # lanes per f32 partial sum (RECHECK_MARGIN is pinned on it)
ROW_ALIGN = 8  # device rows are padded to 8 int16 words: 16-byte loads
LOG10_OVER_10 = float(np.log(10.0) / 10.0)
# subtasks per step of the plain version: its (chunk, SEG) temporaries
# stay at tens of MB however long the stream is
PLAIN_CHUNK = 1 << 14


class TaskScores(NamedTuple):
    """Raw per-task scoring results (arrays of shape (B,))."""

    score: np.ndarray  # exp(mean log p), 0 for rejected/degenerate
    mismatch_rate: np.ndarray  # mismatches / counted, 1.0 for degenerate
    sum_log: np.ndarray
    counted: np.ndarray
    mismatches: np.ndarray
    rejected: np.ndarray  # hard per-position reject (p < mismatch_thresh)


@functools.lru_cache(maxsize=4)
def _phred_lut(dtype_name: str) -> np.ndarray:
    """Per-phred error probability, tabulated once (quals are uint8, so
    256 entries cover every input; each entry is the same elementwise
    expression the direct computation would evaluate -> bit-identical)."""
    q = np.arange(256, dtype=np.dtype(dtype_name))
    return np.power(10.0, -q / 10.0).astype(np.dtype(dtype_name))


def phred_probs(quals: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Phred (integer, ASCII-33 already removed) -> error probability."""
    if quals.dtype == np.uint8:
        return _phred_lut(np.dtype(dtype).name)[quals]
    return np.power(10.0, -quals.astype(dtype) / 10.0).astype(dtype)


@functools.lru_cache(maxsize=1)
def _pair_luts():
    """(p, log p) keyed by (q1, q2, match) — the same-haplotype probability
    algebra of EdgeCalculator.cpp:26-63 tabulated over all 256x256 phred
    pairs. Entries are computed with the identical elementwise float64
    expressions as the direct path, so gathered results are bit-identical;
    this removes the per-position pow/log transcendentals (the 10x-scale
    profile's top two hotspots)."""
    p1 = _phred_lut("float64")[:, None]
    p2 = _phred_lut("float64")[None, :]
    p_match = (1.0 - p1) * (1.0 - p2) + (p1 * p2) / 3.0
    p_mis = (p1 * (1.0 - p2) + p2 * (1.0 - p1)) / 3.0 + (2.0 / 9.0) * p1 * p2
    return (p_match.ravel(), p_mis.ravel(),
            np.log(p_match).ravel(), np.log(p_mis).ravel())


def _empty_scores() -> TaskScores:
    z = np.zeros(0)
    zi = np.zeros(0, dtype=np.int64)
    return TaskScores(z, z, z, zi, zi, np.zeros(0, dtype=bool))


# --------------------------------------------------------------------------
# NumPy oracle (float64)
# --------------------------------------------------------------------------

def score_tasks_numpy(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
) -> TaskScores:
    """Vectorized float64 scoring over B tasks on padded (rows, W) matrices."""
    B = len(row_a)
    W = codes.shape[1]
    if B == 0:
        return _empty_scores()
    pos = np.asarray(pos, dtype=np.int64)
    len_a = unit_lens_by_row[row_a].astype(np.int64)
    len_b = unit_lens_by_row[row_b].astype(np.int64)

    a = codes[row_a]
    b = codes[row_b]
    qa = quals[row_a]
    qb = quals[row_b]
    col = np.arange(W, dtype=np.int64)[None, :]
    idx = np.minimum(pos[:, None] + col, W - 1)
    a_shift = np.take_along_axis(a, idx, axis=1)
    qa_shift = np.take_along_axis(qa, idx, axis=1)

    L = np.minimum(len_a - pos, len_b)
    valid = col < L[:, None]
    either_n = (a_shift >= N_CODE) | (b >= N_CODE)  # N or PAD
    counted_mask = valid & ~either_n

    match = a_shift == b
    # (q1, q2) -> probability via the tabulated pair algebra (bit-identical
    # to computing pow/log per position; see _pair_luts)
    lut_match, lut_mis, lut_logm, lut_logx = _pair_luts()
    pair_idx = (qa_shift.astype(np.int32) << 8) | qb
    log_p = np.where(match, lut_logm[pair_idx], lut_logx[pair_idx])

    if mismatch_thresh > 0.0:
        p = np.where(match, lut_match[pair_idx], lut_mis[pair_idx])
        rejected = np.any(counted_mask & (p < mismatch_thresh), axis=1)
    else:
        rejected = np.zeros(B, dtype=bool)
    sum_log = np.sum(np.where(counted_mask, log_p, 0.0), axis=1)
    counted = np.sum(counted_mask, axis=1).astype(np.int64)
    mismatches = np.sum(counted_mask & ~match, axis=1).astype(np.int64)

    degenerate = (pos >= len_a) | (len_a < min_read_len) | (len_b < min_read_len) | (counted == 0)
    ok = ~degenerate & ~rejected
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(ok, np.exp(sum_log / np.maximum(counted, 1)), 0.0)
        mism_rate = np.where(ok, mismatches / np.maximum(counted, 1), 1.0)
    return TaskScores(score, mism_rate, sum_log, counted, mismatches, rejected)


# --------------------------------------------------------------------------
# Native host backend (C++ OpenMP, float64)
# --------------------------------------------------------------------------

def score_tasks_native(
    codes: np.ndarray,
    quals: np.ndarray,
    unit_lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
) -> "TaskScores | None":
    """C++ OpenMP host engine (native/baseline_score.cpp:score_tasks_exact).

    One fused pass per task instead of numpy's ~10 full-matrix passes —
    ~20x the oracle's host throughput. Per-position probabilities come from
    the same _pair_luts() tables as the oracle, so only the serial (vs
    pairwise) summation order differs; callers run the f64 re-scoring
    (ops/verify.py) so edge decisions are bit-identical to the oracle.
    Returns None when the extension cannot be built.
    """
    from ..native import load_baseline_ext

    ext = load_baseline_ext()
    if ext is None or not hasattr(ext._m, "score_tasks_exact"):
        return None
    if len(row_a) == 0:
        return _empty_scores()
    out = ext.score_tasks_exact(
        codes, quals, unit_lens_by_row, row_a, row_b, pos,
        mismatch_thresh, min_read_len, _pair_luts())
    return TaskScores(*out)


# --------------------------------------------------------------------------
# Torch device backend (float32 lanes, f64 per-task sums)
# --------------------------------------------------------------------------

def pack_host(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """(R, W) codes/quals -> (R, RW) int16 code | qual << 3 words on the
    host, RW = W rounded up to a multiple of ROW_ALIGN; the pad words are
    PAD_CODE with qual 0, so every row starts on a 16-byte boundary."""
    r, w = codes.shape
    rw = -(-w // ROW_ALIGN) * ROW_ALIGN
    comb = np.full((r, rw), PAD_CODE, dtype=np.int16)
    comb[:, :w] = codes.astype(np.int16) | (quals.astype(np.int16) << 3)
    return comb


def pack_for_device(codes: np.ndarray, quals: np.ndarray, device) -> torch.Tensor:
    """pack_host(codes, quals) uploaded whole to `device`."""
    return torch.from_numpy(pack_host(codes, quals)).to(device)


def segment_tasks(row_a, row_b, pos, L):
    """Decompose tasks into SEG-lane subtasks.

    Returns (s_rowa, s_rowb, s_posa, s_bolen, task_bounds) where
    task_bounds are np.add.reduceat boundaries mapping subtask outputs back
    to tasks. Row ids stay full int32 (no 16-bit packing), so the subtask
    stream addresses packed matrices of any height. Degenerate tasks
    (L <= 0) get one zero-length subtask so every task produces exactly one
    reduction slot.
    """
    L = np.maximum(L, 0)
    nseg = np.maximum((L + SEG - 1) // SEG, 1).astype(np.int64)
    total = int(nseg.sum())
    task_of = np.repeat(np.arange(len(L), dtype=np.int64), nseg)
    bounds = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    k = np.arange(total, dtype=np.int64) - np.repeat(bounds, nseg)
    bo = k * SEG
    seg_len = np.minimum(L[task_of] - bo, SEG)
    s_rowa = row_a[task_of].astype(np.int32)
    s_rowb = row_b[task_of].astype(np.int32)
    s_posa = (pos[task_of].astype(np.int64) + bo).astype(np.int32)
    s_bolen = ((k << 10) | seg_len).astype(np.int32)
    return s_rowa, s_rowb, s_posa, s_bolen, bounds


def lane_p(qa: np.ndarray, qb: np.ndarray, match: np.ndarray) -> np.ndarray:
    """The reference's f32 probability that both bases were read from one
    haplotype, for phred arrays qa, qb and match flags, in the operation
    order the kernels' lane_p (csrc/lane_p.cuh) pins. Each exp is taken in
    f64 and rounded to f32, so no vector math library decides a bit."""
    c = np.float32(-LOG10_OVER_10)
    one, third, two_ninths = np.float32(1.0), np.float32(1.0 / 3.0), np.float32(2.0 / 9.0)

    def err(q):
        return np.exp((np.asarray(q).astype(np.float32) * c).astype(np.float64)
                      ).astype(np.float32)

    p1, p2 = err(qa), err(qb)
    p_match = (one - p1) * (one - p2) + (p1 * p2) * third
    p_mis = (p1 * (one - p2) + p2 * (one - p1)) * third + two_ninths * (p1 * p2)
    return np.where(match, p_match, p_mis)


@functools.lru_cache(maxsize=None)
def lane_tables(device: torch.device):
    """(p, log p), f32 tensors on `device` with one entry per (qa, qb,
    match) of phreds below 256, at lane_index's index: lane_p's values,
    and their logs taken in f64 and rounded to f32. The plain versions
    gather every lane from these tables rather than take torch's exp and
    log per call: on the CPU those gave one intra-op thread's share of a
    process's first call values up to 5e-6 away from later calls'."""
    q = np.arange(256)
    qa, qb, m = np.meshgrid(q, q, np.array([False, True]), indexing="ij")
    p = lane_p(qa, qb, m).ravel()
    log_p = np.log(p.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(p).to(device), torch.from_numpy(log_p).to(device)


def lane_index(a_w: torch.Tensor, b_w: torch.Tensor):
    """Per lane of int32 words code | qual << 3: (the lane's entry of
    lane_tables, (qa << 9) | (qb << 1) | match; match, whether the codes
    agree; called, whether neither code is N or pad)."""
    a, b = a_w & 7, b_w & 7
    match = a == b
    idx = ((a_w >> 3) << 9) | ((b_w >> 3) << 1) | match.to(a_w.dtype)
    return idx, match, (a < N_CODE) & (b < N_CODE)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension by pairwise halving, zeros padded up to
    a power of two: an order of adds that no thread count or batch size
    can change."""
    w = 1 << max(x.shape[-1] - 1, 0).bit_length()
    if w != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, w - x.shape[-1]))
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w:]
    return x[..., 0]


_INV_LN2 = 1.4426950408889634
# ln 2 in two parts: k * _LN2_HI is exact for |k| < 2^11
_LN2_HI, _LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10


def fixed_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of x, rounded to f32, for x <= 0 (clamped below at -700, where
    f32 holds 0). Evaluated in f64 as 2^k * exp(r), x = k ln 2 + r with
    |r| <= ln 2 / 2, exp(r) by a degree-13 Taylor polynomial: only
    multiplies, adds and divides, each rounded once by IEEE rules, so no
    thread split or vector path of torch's exp can move a bit."""
    x = x.to(torch.float64).clamp(-700.0, 0.0)
    k = torch.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    y = torch.ones_like(r)
    for n in range(13, 0, -1):
        y = 1.0 + (r / n) * y
    scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return (y * scale).to(torch.float32)


def segment_scores_torch(comb: torch.Tensor, rowa: torch.Tensor,
                         rowb: torch.Tensor, posa: torch.Tensor,
                         bolen: torch.Tensor, mismatch_thresh: float):
    """Per SEG-lane subtask (the reference's xla_segment_body): sum_log
    f32, counted, mismatches and rejected int32. Lanes past seg_len are
    masked; their clamped gathers stay inside the row. Each lane's p and
    log p come from lane_tables, and the lanes are summed by lane_sum, so
    the bits do not depend on the thread count or the batch."""
    n = rowa.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.float32, device=comb.device),
                *(torch.zeros(0, dtype=torch.int32, device=comb.device)
                  for _ in range(3)))
    rw = comb.shape[1]
    flat = comb.reshape(-1)
    p_tab, log_tab = lane_tables(comb.device)
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
        idx, match, called = lane_index(a_w, b_w)
        cm = (col < lt[:, None]) & called
        outs[0].append(lane_sum(torch.where(cm, log_tab[idx], 0.0)))
        outs[1].append(cm.sum(dim=1, dtype=torch.int32))
        outs[2].append((cm & ~match).sum(dim=1, dtype=torch.int32))
        outs[3].append((cm & (p_tab[idx] < mismatch_thresh)).sum(dim=1, dtype=torch.int32))
    return tuple(torch.cat(o) for o in outs)


def score_tasks_plain(comb: torch.Tensor, lens: torch.Tensor,
                      row_a: torch.Tensor, row_b: torch.Tensor,
                      pos: torch.Tensor, mismatch_thresh: float):
    """Plain PyTorch version of the scoring kernel, on comb's device: per
    task (sum_log f64, counted, mismatches, rejected int32). Each task is
    cut into SEG-lane subtasks (segment_tasks), each subtask summed in f32
    (segment_scores_torch), and the subtask sums added per task in f64 in
    segment order: the first segments, then each task's k-th segment for
    k = 1, 2, ..., so the order is fixed on any device."""
    dev = comb.device
    n = row_a.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.float64, device=dev),
                *(torch.zeros(0, dtype=torch.int32, device=dev) for _ in range(3)))
    lens64 = lens.to(torch.int64)
    ra, rb, p = (c.to(torch.int64) for c in (row_a, row_b, pos))
    len_a, len_b = lens64[ra], lens64[rb]
    L = torch.where(p >= len_a, 0, torch.minimum(len_a - p, len_b))
    *cols, bounds = segment_tasks(ra.cpu().numpy(), rb.cpu().numpy(),
                                  p.cpu().numpy(), L.cpu().numpy())
    sub = segment_scores_torch(comb, *(torch.from_numpy(c).to(dev) for c in cols),
                               mismatch_thresh)
    sub = (sub[0].to(torch.float64), *sub[1:])
    nseg = np.diff(np.append(bounds, len(cols[0])))
    sums = [s[torch.from_numpy(bounds).to(dev)] for s in sub]
    for k in range(1, int(nseg.max(initial=1))):
        tasks = np.flatnonzero(nseg > k)
        at, seg = (torch.from_numpy(c).to(dev) for c in (tasks, bounds[tasks] + k))
        for whole, part in zip(sums, sub):
            whole[at] += part[seg]
    return tuple(sums)


def score_tasks(comb: torch.Tensor, lens, row_a, row_b, pos,
                mismatch_thresh: float):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if comb.is_cuda:
        return score_tasks_cuda(comb, lens, row_a, row_b, pos, mismatch_thresh)
    if comb.device.type != "cpu":
        raise ValueError(f"no scoring kernel for device {comb.device}")
    return score_tasks_plain(comb, lens, row_a, row_b, pos, mismatch_thresh)


def finish_task_scores(sum_log, counted, mism, rejected, pos64, len_a, len_b,
                       min_read_len: int) -> TaskScores:
    """Per-task sums -> TaskScores: the degenerate rules, score and the
    mismatch rate, in f64 on the host."""
    sum_log = np.asarray(sum_log, np.float64)
    counted = np.asarray(counted).astype(np.int64)
    mism = np.asarray(mism).astype(np.int64)
    rejected = np.asarray(rejected) > 0
    degenerate = ((pos64 >= len_a) | (len_a < min_read_len)
                  | (len_b < min_read_len) | (counted == 0))
    ok = ~degenerate & ~rejected
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(ok, np.exp(sum_log / np.maximum(counted, 1)), 0.0)
        mism_rate = np.where(ok, mism / np.maximum(counted, 1), 1.0)
    return TaskScores(score, mism_rate, sum_log, counted, mism, rejected)


def check_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"scoring on {device}: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    return device


def check_tasks(codes: np.ndarray, lens_by_row, row_a, row_b, pos):
    """Validate a non-empty task stream against its (R, W) matrix; the
    kernel gathers without bounds checks, so this checks what it trusts.
    Returns int64 (lens, row_a, row_b, pos)."""
    lens = np.asarray(lens_by_row).astype(np.int64)
    r, w = codes.shape
    row_a = np.asarray(row_a, np.int64)
    row_b = np.asarray(row_b, np.int64)
    if len(lens) != r or int(lens.max()) > w or int(lens.min()) < 0:
        raise ValueError("lens_by_row must give one length <= width per row")
    if min(int(row_a.min()), int(row_b.min())) < 0 or \
            max(int(row_a.max()), int(row_b.max())) >= r:
        raise ValueError("task row ids out of range")
    pos64 = np.asarray(pos, dtype=np.int64)
    if int(pos64.min()) < 0 or int(pos64.max()) >= 2**31:
        raise ValueError("task positions must lie in [0, 2^31)")
    return lens, row_a, row_b, pos64


def score_tasks_torch(
    codes: np.ndarray,
    quals: np.ndarray,
    lens_by_row: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    pos: np.ndarray,
    mismatch_thresh: float = 0.0,
    min_read_len: int = 0,
    device=None,
) -> TaskScores:
    """Score tasks on `device` (None: the torch backend's device,
    parallel/devices.py:default_device; a list: that mesh), a TaskScores
    of numpy arrays: parallel/mesh.py:sharded_score_tasks over a mesh of
    that one entry. On a CUDA device the kernel runs or this raises; it
    never falls back to the CPU."""
    from ..parallel.mesh import sharded_score_tasks  # mesh.py imports this module

    if not isinstance(device, list):
        device = [default_device() if device is None else device]
    return sharded_score_tasks(codes, quals, lens_by_row, row_a, row_b, pos,
                               mismatch_thresh, min_read_len, mesh=device)
