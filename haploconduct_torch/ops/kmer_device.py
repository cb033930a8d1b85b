"""Overlap candidates by a k-mer sort-join in torch — twin of
haploconduct_tpu/ops/kmer_device.py:find_overlap_candidates_device.

The reference's `_build_join` (jnp) becomes torch ops on any device: the
card when there is one, the CPU in the tests. Forward k-mer hashes (k <= 15,
int32; -1 where a window holds N or pad) are sorted stably, so within a
hash group the table keeps the row-major (row, pos) order of the
reference's stable `lax.sort`. Every forward and reverse-complement query
k-mer is joined by searchsorted against that table: a group larger than
`max_group` is dropped, and only its first `expand` entries are taken, a
self entry among them using up its slot as in the reference. Unlike the
reference's fixed R * NK * expand * 2 buffer, only the slots a query
really has are expanded, in chunks of at most CHUNK_SLOTS, each chunk
reduced at once to its unique (qa, tb, shift, rev) keys (one int64 each),
so device memory stays bounded. The candidate set does not depend on
the order or chunking, and the host post-processing after the join is
the reference's, line for line.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.reads import N_CODE, PAD_CODE, revcomp_codes
from ..io.sfo import SFO_DTYPE
from ..parallel.devices import default_device
from .kmer import _pack_keys, _verify_candidates

# join calls and their wall seconds per device type ("cuda", "cpu");
# threads share them
JOIN_CALLS: Dict[str, int] = {}
JOIN_SECONDS: Dict[str, float] = {}
_calls_lock = threading.Lock()

# slots expanded at once; each holds ~80 B of int64 temporaries, so a
# chunk stays near 1.3 GB of device memory
CHUNK_SLOTS = 1 << 24
INT32_MAX = 2**31 - 1
SHIFT_BIAS = 1 << 30  # join keys hold shift + SHIFT_BIAS in 31 bits


def kmer_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(R, W) base codes -> (R, W - k + 1) int32 hashes, -1 where the
    window holds an N or pad (the reference's kmer_hashes)."""
    nk = codes.shape[1] - k + 1
    h = torch.zeros((codes.shape[0], nk), dtype=torch.int32, device=codes.device)
    bad = torch.zeros(h.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[:, j:j + nk].to(torch.int32)
        ok = c < N_CODE
        h = h * 4 + torch.where(ok, c, 0)
        bad |= ~ok
    return torch.where(bad, -1, h)


def kmer_table(h: torch.Tensor, nk: int):
    """The sorted k-mer table of flat (R * NK,) row-major hashes: (tkey,
    t_rid, t_pos) int32, invalid hashes stored as 2^31 - 1 and sorted
    stably, so a hash group keeps the row-major (row, pos) order of the
    reference's stable sort."""
    tkey, order = torch.sort(torch.where(h < 0, INT32_MAX, h), stable=True)
    t_rid = torch.div(order, nk, rounding_mode="floor").to(torch.int32)
    return tkey, t_rid, (order % nk).to(torch.int32)


def _join_keys(tkey: torch.Tensor, t_rid: torch.Tensor, t_pos: torch.Tensor,
               qh: torch.Tensor, nk: int, rev: int, expand: int,
               max_group: int) -> torch.Tensor:
    """Unique packed (qa, tb, shift, rev) keys of one query direction.
    qh: (R * NK,) query hashes in row-major (row, pos) order."""
    left = torch.searchsorted(tkey, qh, right=False)
    count = torch.searchsorted(tkey, qh, right=True) - left
    q = torch.nonzero((qh >= 0) & (count > 0) & (count <= max_group)).squeeze(1)
    n_slots = torch.clamp(count[q], max=expand)
    per_chunk = max(1, CHUNK_SLOTS // expand)
    keys = []
    for s in range(0, q.shape[0], per_chunk):
        qc, nc = q[s:s + per_chunk], n_slots[s:s + per_chunk]
        total = int(nc.sum())
        qi = torch.repeat_interleave(qc, nc, output_size=total)
        start = torch.cumsum(nc, 0) - nc
        d = (torch.arange(total, device=qh.device)
             - torch.repeat_interleave(start, nc, output_size=total))
        t_idx = left[qi] + d
        rid_b = t_rid[t_idx].to(torch.int64)
        q_rid = torch.div(qi, nk, rounding_mode="floor")
        valid = rid_b != q_rid
        shift = (qi - q_rid * nk) - t_pos[t_idx].to(torch.int64)
        key = ((q_rid << 48) | (rid_b << 32)
               | ((shift + SHIFT_BIAS) << 1) | rev)
        keys.append(torch.unique(key[valid]))
    if not keys:
        return torch.zeros(0, dtype=torch.int64, device=qh.device)
    return torch.unique(torch.cat(keys))


def join_candidates(codes_fwd: np.ndarray, codes_rev: np.ndarray, k: int,
                    expand: int, max_group: int, device):
    """The sort-join on `device`: (qa, tb, sh, rev) int64 numpy columns of
    the unique candidate diagonals, sorted by packed key."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("join_candidates: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    r, w = codes_fwd.shape
    nk = w - k + 1
    if nk <= 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    if r * nk >= 2**31:
        raise ValueError("the k-mer table needs R * NK < 2^31")
    if w >= SHIFT_BIAS:
        raise ValueError("sequences must be shorter than 2^30")
    fwd = torch.from_numpy(codes_fwd).to(device)
    th = kmer_hashes(fwd, k).reshape(-1)
    tkey, t_rid, t_pos = kmer_table(th, nk)
    keys = [_join_keys(tkey, t_rid, t_pos, th, nk, 0, expand, max_group)]
    del th
    rev = torch.from_numpy(codes_rev).to(device)
    keys.append(_join_keys(tkey, t_rid, t_pos, kmer_hashes(rev, k).reshape(-1),
                           nk, 1, expand, max_group))
    key = torch.cat(keys).cpu().numpy()
    with _calls_lock:
        JOIN_CALLS[device.type] = JOIN_CALLS.get(device.type, 0) + 1
        JOIN_SECONDS[device.type] = (JOIN_SECONDS.get(device.type, 0.0)
                                     + time.perf_counter() - t0)
    qa = (key >> 48) & 0xFFFF
    tb = (key >> 32) & 0xFFFF
    sh = ((key >> 1) & INT32_MAX) - SHIFT_BIAS
    return qa, tb, sh, key & 1


def find_overlap_candidates_device(
    seqs,
    min_overlap_len: int,
    k: int = 15,
    expand: int = 32,
    max_group: int = 512,
    error_rate: float = 0.0,
    verify: bool = True,
    device: Optional[torch.device] = None,
):
    """Candidate generation by the sort-join on `device` (None: the torch
    backend's device, parallel/devices.py:default_device); returns the SFO
    array of the reference's function on the same inputs, bit for bit."""
    n = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype=SFO_DTYPE)
    assert n < (1 << 16), "the join packs idA and idB into 16 bits each"
    w = int(lens.max())
    codes_fwd = np.full((n, w), PAD_CODE, np.int8)
    codes_rev = np.full((n, w), PAD_CODE, np.int8)
    for i, s in enumerate(seqs):
        codes_fwd[i, :len(s)] = s
        codes_rev[i, :len(s)] = revcomp_codes(s)

    if device is None:
        device = default_device()
    qa, tb, sh, rev = join_candidates(codes_fwd, codes_rev, min(k, 15), expand,
                                      max_group, device)

    # frame mapping + canonicalization (same algebra as the host engine)
    la = lens[qa]
    lb = lens[tb]
    shift = np.where(rev == 1, la - (sh + lb), sh)
    start = np.maximum(0, shift)
    end = np.minimum(la, shift + lb)
    ov = end - start
    keep = ov >= min_overlap_len
    qa, tb, shift, rev, la, lb = (x[keep] for x in (qa, tb, shift, rev, la, lb))
    swap = qa > tb
    ida = np.where(swap, tb, qa)
    idb = np.where(swap, qa, tb)
    shift = np.where(swap, np.where(rev == 1, shift + lb - la, -shift), shift)

    key = _pack_keys(ida, idb, shift, rev)
    order = np.unique(key, return_index=True)[1]
    ida, idb, shift, rev = ida[order], idb[order], shift[order], rev[order]
    la, lb = lens[ida], lens[idb]

    oha = shift
    ohb = (shift + lb) - la
    start = np.maximum(0, shift)
    end = np.minimum(la, shift + lb)
    ov = end - start
    out = np.zeros(len(ida), dtype=SFO_DTYPE)
    out["ida"] = ida
    out["idb"] = idb
    out["ori"] = np.where(rev == 1, b"I", b"N")
    out["oha"] = oha
    out["ohb"] = ohb
    out["ola"] = ov
    out["olb"] = ov
    out["k"] = np.ceil(error_rate * ov).astype(np.int64)
    if verify and len(out):
        out = _verify_candidates(seqs, lens, out, error_rate)
    return out
