"""The fused k-mer join + diagonal verification of one shard of query rows
— twin of the device program of haploconduct_tpu/parallel/mesh.py:
sharded_pipeline_fn (`step`, :436-480), which parallel/mesh.py:
sharded_assembly_step drives over several devices.

Every forward k-mer of a query row (row r, position p) is looked up in the
sorted table of the forward k-mers of every row (ops/kmer_device.py:
kmer_table), and its first `expand` table entries are its slots. Slot d is
valid when d < the k-mer's count, the entry's row rb differs from r and
shift = p - (the entry's position) >= 0; it scores the diagonal
comb[r, shift + j] against comb[rb, j], j < min(len[r] - shift, len[rb]),
over the lanes where neither code is N or pad, with the reference's
per-lane probability summed as log p in f32 (ops/score.py:lane_p, its
values taken from lane_tables). score = exp(sum log p / counted) when
valid and counted >= min_overlap_len, else 0; the slots scoring above
edge_threshold are counted. No mismatch rejection and no minimum read
length, as in the reference's step.

`join_verify` launches the CUDA kernel (csrc/join_verify.cu through
ops/kernels.py:join_verify_cuda) on a CUDA tensor and runs the plain
version `join_verify_plain` on a CPU tensor; there is no fallback. The
two sum log p in other orders: scores agree within 1e-5, the zero pattern
(decided by exact integers) exactly. A slot's score depends on its
diagonal (r, rb, shift) alone (`slot_diagonals`), so the kernel scores
each distinct diagonal among a tile of TILE_SLOTS slots of a row once and
hands its score to every slot on it; the plain version scores every slot,
sums its lanes with ops/score.py:lane_sum and takes exp with fixed_exp,
so its bits do not depend on the thread count or the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import join_verify_cuda
from .kmer_device import kmer_hashes
from .score import fixed_exp, lane_index, lane_sum, lane_tables

# slots of one query row the kernel deduplicates together
# (csrc/join_verify.cu:kTileSlots)
TILE_SLOTS = 2048
# (query, slot, lane) elements per step of the plain version: its int64
# and f32 temporaries stay at a few hundred MB
PLAIN_LANES = 1 << 24


def check_join_inputs(codes: np.ndarray, lens: np.ndarray, k: int,
                      expand: int) -> int:
    """Validate a join's (R, W) matrix, its per-row lengths and k; returns
    NK = W - k + 1. The kernel gathers without bounds checks, so this
    checks what it trusts."""
    r, w = codes.shape
    lens = np.asarray(lens)
    if not 1 <= k <= 15:
        raise ValueError("k must lie in [1, 15]: hashes are int32")
    if w < k or expand < 1:
        raise ValueError("the rows must hold a k-mer and expand must be >= 1")
    if lens.shape != (r,) or (r and (int(lens.max()) > w or int(lens.min()) < 0)):
        raise ValueError("lens must give one length <= width per row")
    nk = w - k + 1
    if r * nk * expand >= 2**31:
        raise ValueError("the join needs R * NK * expand < 2^31 slots")
    return nk


def kmer_queries(comb: torch.Tensor, w: int, k: int, tkey: torch.Tensor,
                 row0: int, row1: int):
    """(left, count) int32 in the sorted table `tkey` of the forward k-mers
    of rows row0 .. row1 of comb (width w), in row-major order; count 0
    for a k-mer holding an N or pad (hash -1), as the reference's
    `ok_q` mask makes it."""
    qh = kmer_hashes(comb[row0:row1, :w] & 7, k).reshape(-1)
    left = torch.searchsorted(tkey, qh)
    count = torch.searchsorted(tkey, qh, right=True) - left
    count = torch.where(qh >= 0, count, 0)
    return left.to(torch.int32), count.to(torch.int32)


def slot_diagonals(t_rid: torch.Tensor, t_pos: torch.Tensor, left: torch.Tensor,
                   count: torch.Tensor, q: torch.Tensor, row0: int, nk: int,
                   expand: int):
    """The diagonals of the slots of query k-mers q (int64 indices into
    left and count, of rows row0 + q // nk): the query row r (len(q),)
    and, per slot (len(q), expand), the partner row rb, the shift and
    whether the slot is valid. A slot's score depends on (r, rb, shift)
    alone."""
    d = torch.arange(expand, device=q.device)
    r = row0 + torch.div(q, nk, rounding_mode="floor")
    t = torch.clamp(left[q].to(torch.int64)[:, None] + d, max=t_rid.shape[0] - 1)
    rb = t_rid[t].to(torch.int64)
    shift = (q % nk)[:, None] - t_pos[t].to(torch.int64)
    valid = (d < count[q][:, None]) & (rb != r[:, None]) & (shift >= 0)
    return r, rb, shift, valid


def join_verify_plain(comb: torch.Tensor, lens: torch.Tensor, t_rid: torch.Tensor,
                      t_pos: torch.Tensor, left: torch.Tensor, count: torch.Tensor,
                      row0: int, nk: int, expand: int, min_overlap_len: int,
                      edge_threshold: float):
    """Plain PyTorch version of the join_verify kernel, on comb's device,
    in steps of whole query k-mers: (scores (n * expand,) f32 in slot
    order, n_edges (1,) int32). Every slot is scored on its own; the lanes
    of a slot are read from its clamped diagonal and masked past its
    length, as the reference does."""
    dev = comb.device
    n = left.shape[0]
    rw = comb.shape[1]
    flat = comb.reshape(-1)
    lens64 = lens.to(torch.int64)
    col = torch.arange(rw, device=dev)
    per = max(1, PLAIN_LANES // (expand * rw))
    log_tab = lane_tables(dev)[1]
    scores = []
    n_edges = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, n, per):
        q = torch.arange(s, min(s + per, n), device=dev)
        r, rb, shift, valid = slot_diagonals(t_rid, t_pos, left, count, q, row0,
                                             nk, expand)
        L = torch.minimum(lens64[r][:, None] - shift, lens64[rb])
        a_idx = torch.clamp(shift[..., None] + col, 0, rw - 1)
        a_w = flat[r[:, None, None] * rw + a_idx].to(torch.int32)
        b_w = flat[rb[..., None] * rw + col].to(torch.int32)
        idx, _, called = lane_index(a_w, b_w)
        cm = (col < L[..., None]) & called
        sum_log = lane_sum(torch.where(cm, log_tab[idx], 0.0))
        counted = cm.sum(dim=-1)
        ok = valid & (counted >= min_overlap_len)
        sc = torch.where(ok, fixed_exp(sum_log / torch.clamp(counted, min=1)), 0.0)
        n_edges += (sc > edge_threshold).sum()
        scores.append(sc.reshape(-1))
    if not scores:
        return (torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    return torch.cat(scores), n_edges.to(torch.int32).reshape(1)


def join_verify(comb: torch.Tensor, lens: torch.Tensor, t_rid: torch.Tensor,
                t_pos: torch.Tensor, left: torch.Tensor, count: torch.Tensor,
                row0: int, nk: int, expand: int, min_overlap_len: int,
                edge_threshold: float):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    args = (comb, lens, t_rid, t_pos, left, count, row0, nk, expand,
            min_overlap_len, edge_threshold)
    if comb.is_cuda:
        return join_verify_cuda(*args)
    if comb.device.type != "cpu":
        raise ValueError(f"no join_verify kernel for device {comb.device}")
    return join_verify_plain(*args)
