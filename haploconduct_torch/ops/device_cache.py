"""Device-resident packed-matrix cache across assembly iterations — twin
of haploconduct_tpu/ops/device_cache.py.

Most units survive an iteration unchanged (trivial superreads forward the
original arrays, merge iterations only rewrite merged contigs), so most of
the packed read matrix a verify call uploads is already on the device
from the call before. This cache keeps the previous call's combined
(code | qual << 3) matrix on the device and assembles the next one there:
unchanged rows are gathered from the old device buffer, only changed rows
travel host -> device. Rows are matched by their unpadded content (codes
and quals over the row's length), which also catches orientation flips:
pack() lays out rows [0, U) forward and [U, 2U) reverse-complement, so a
unit stored reverse-complemented this iteration matches the old matrix's
reverse row and vice versa.

The decisions are the reference's, row for row:
- a row's key is its codes and quals over its length; among old rows of
  one key the last is reused;
- a reused row is gathered over the first min(old, new) row words, the
  rest of the row is PAD_CODE with qual 0;
- one full upload on a cold start, and whenever fewer than half the rows
  are reused.
The assembled matrix equals a fresh upload of `combined` bit for bit, so
the scores cannot change. HC_DEVICE_CACHE=0 turns the cache off: every
call is a full upload, and nothing is kept (no keys, no device buffer),
so turning it back on starts cold.

The reference builds one Python bytes key per row. Here a row's key is
hashed vectorised (its words up to its length, and the length), and
every hash hit is confirmed by comparing the two rows' words, so the
reused and changed sets, and TRANSFER_STATS, are exactly the reference's.
The words code | qual << 3 determine the key only while codes lie in
[0, 8), codes are int8 and quals uint8, and only while no two distinct
keys of one matrix share a hash; otherwise the call matches rows by the
reference's bytes keys.

There is one cache per thread and device: region threads (polyte-split's
pool_size > 1) each keep their own matrix, and each card of a mesh its
own. Each assembly runs on the current stream of its device, the stream
the kernel launch uses, so the old buffer is read before its memory can
be reused. TRANSFER_STATS counts, per device a matrix goes to, the bytes
a full upload would have moved and the bytes actually moved.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.reads import PAD_CODE
from ..parallel.devices import default_device
from .kernels import _lock

TRANSFER_STATS = {"full_bytes": 0, "uploaded_bytes": 0, "iterations": 0,
                  "reused_rows": 0, "changed_rows": 0}


def reset_stats() -> None:
    with _lock:
        for k in TRANSFER_STATS:
            TRANSFER_STATS[k] = 0


def _row_keys(codes: np.ndarray, quals: np.ndarray,
              lens_by_row: np.ndarray) -> list:
    """Per packed row (fwd rows then rev rows), the unpadded content key."""
    keys = []
    for r in range(len(lens_by_row)):
        n = int(lens_by_row[r])
        keys.append(codes[r, :n].tobytes() + quals[r, :n].tobytes())
    return keys


_M = np.uint64
_GOLDEN = _M(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser: a bijection of uint64."""
    x = (x ^ (x >> _M(30))) * _M(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _M(27))) * _M(0x94D049BB133111EB)
    return x ^ (x >> _M(31))


def _row_hash(words: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per row of `words` ((R, RW) int16, zero past each row's length, RW a
    multiple of 4), a uint64 hash of the words and the length: each group
    of four words, its high half folded onto its low half, times an odd
    weight of its column, summed. A zero group adds nothing, so the hash
    does not depend on RW."""
    w64 = words.view(np.uint64)
    with np.errstate(over="ignore"):
        weight = _mix(np.arange(1, w64.shape[1] + 1, dtype=np.uint64) * _GOLDEN) | _M(1)
        h = np.einsum("ij,j->i", w64 ^ (w64 >> _M(32)), weight, dtype=np.uint64)
        return _mix(h ^ _mix(lens.astype(np.uint64) + _GOLDEN))


def _same_keys(a: "_Rows", rows_a: np.ndarray, b: "_Rows", rows_b: np.ndarray) -> np.ndarray:
    """Whether row rows_a[i] of `a` holds the key of row rows_b[i] of `b`
    (both with words)."""
    w = min(a.words.shape[1], b.words.shape[1])
    return ((a.lens[rows_a] == b.lens[rows_b])
            & (a.words[rows_a, :w] == b.words[rows_b, :w]).all(axis=1))


class _Rows:
    """The keys of one matrix's rows [0, len(lens)). `words` is set where
    the words code | qual << 3 (zero past each length) determine the key;
    then `uniq` holds the sorted distinct hashes, `last` the last row of
    each, and `exact` whether rows of one hash always share their key."""

    def __init__(self, codes, quals, lens_by_row, combined):
        self.codes, self.quals = codes, quals
        self.lens = np.asarray(lens_by_row).astype(np.int64)
        self.words = None
        r = len(self.lens)
        if (codes.dtype == np.int8 and quals.dtype == np.uint8 and codes.size
                and combined.dtype == np.int16
                and int(codes.min()) >= 0 and int(codes.max()) < 8):
            rw = -(-combined.shape[1] // 4) * 4
            words = np.zeros((r, rw), np.int16)
            col = np.arange(combined.shape[1])
            np.copyto(words[:, :combined.shape[1]], combined[:r],
                      where=col[None, :] < self.lens[:, None])
            self.words = words
            self._index(_row_hash(words, self.lens))

    def _index(self, h: np.ndarray) -> None:
        order = np.argsort(h, kind="stable")
        hs = h[order]
        starts = np.flatnonzero(np.r_[True, hs[1:] != hs[:-1]])
        sizes = np.diff(np.r_[starts, len(hs)])
        self.h, self.uniq = h, hs[starts]
        # a stable sort keeps each hash's rows in row order: its last is
        # the last row of the key, the row the reference's dict keeps
        self.last = order[starts + sizes - 1]
        group = np.repeat(np.arange(len(starts)), sizes)
        shared = (sizes > 1)[group]
        self.exact = bool(_same_keys(self, order[shared], self,
                                     self.last[group[shared]]).all())

    def keys(self) -> list:
        """The reference's bytes keys of these rows."""
        if self.words is None:
            return _row_keys(self.codes, self.quals, self.lens)
        codes = (self.words & 7).astype(np.int8)
        quals = (self.words >> 3).astype(np.uint8)
        return _row_keys(codes, quals, self.lens)

    def match(self, old: "_Rows"):
        """(reuse_old, reuse_new, changed): for each row of self whose key
        is a row's of `old`, the last such old row, and the other rows."""
        if self.words is None or old.words is None or not old.exact:
            keymap = {k: r for r, k in enumerate(old.keys())}
            found = np.array([keymap.get(k, -1) for k in self.keys()], np.int64)
        else:
            at = np.minimum(np.searchsorted(old.uniq, self.h), max(len(old.uniq) - 1, 0))
            found = np.full(len(self.lens), -1, np.int64)
            if len(old.uniq):
                hit = np.flatnonzero(old.uniq[at] == self.h)
                cand = old.last[at[hit]]
                ok = _same_keys(self, hit, old, cand)
                found[hit[ok]] = cand[ok]
        reuse_new = np.flatnonzero(found >= 0)
        return found[reuse_new], reuse_new, np.flatnonzero(found < 0)


def _enabled() -> bool:
    return os.environ.get("HC_DEVICE_CACHE") != "0"


def _device(device) -> torch.device:
    """`device` (None: the torch backend's) with a card's index filled in."""
    device = torch.device(default_device() if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class CombCache:
    """One device-resident combined matrix, replaced each call."""

    def __init__(self):
        self.comb_dev: Optional[torch.Tensor] = None  # (R, RW) int16
        self.rows: Optional[_Rows] = None  # the keys of its rows

    def enabled(self) -> bool:
        return _enabled()

    def get(self, codes: np.ndarray, quals: np.ndarray, lens_by_row: np.ndarray,
            combined: np.ndarray, device=None, rows: Optional[_Rows] = None):
        """`combined` (the host pack of codes and quals) on `device` (None:
        the torch backend's device), reusing unchanged rows of the previous
        call's matrix. `rows` are the rows' keys when the caller has them."""
        device = _device(device)
        full_bytes = combined.nbytes
        n_rows = len(lens_by_row)
        r_new, rw_new = combined.shape
        enabled = self.enabled()
        if enabled and rows is None:
            rows = _Rows(codes, quals, lens_by_row, combined)
        if enabled and self.rows is not None:
            reuse_old, reuse_new, changed = rows.match(self.rows)
        else:
            reuse_old = reuse_new = np.zeros(0, np.int64)
            changed = np.arange(n_rows)

        if not len(reuse_old) or len(reuse_old) < n_rows // 2:
            # cold start or mostly changed: one full upload is cheaper than
            # a gather over a minority of rows
            comb_dev = torch.from_numpy(combined).to(device)
            uploaded, n_reused, n_changed = full_bytes, 0, n_rows
        else:
            w = min(self.comb_dev.shape[1], rw_new)
            gather = torch.from_numpy(reuse_old).to(device)
            scatter = torch.from_numpy(reuse_new).to(device)
            comb_dev = torch.full((r_new, rw_new), PAD_CODE, dtype=torch.int16,
                                  device=device)
            comb_dev[scatter, :w] = self.comb_dev[gather, :w]
            uploaded = 0
            if len(changed):
                ch_rows = combined[changed]
                comb_dev[torch.from_numpy(changed).to(device)] = \
                    torch.from_numpy(ch_rows).to(device)
                uploaded = ch_rows.nbytes
            n_reused, n_changed = len(reuse_old), len(changed)
        with _lock:
            TRANSFER_STATS["iterations"] += 1
            TRANSFER_STATS["full_bytes"] += full_bytes
            TRANSFER_STATS["uploaded_bytes"] += uploaded
            TRANSFER_STATS["reused_rows"] += n_reused
            TRANSFER_STATS["changed_rows"] += n_changed

        if enabled:
            self.comb_dev, self.rows = comb_dev, rows
        else:
            self.comb_dev = self.rows = None
        return comb_dev


_local = threading.local()


def _cache(device: torch.device) -> CombCache:
    """This thread's cache for `device`."""
    caches: Dict[torch.device, CombCache] = getattr(_local, "caches", None)
    if caches is None:
        caches = _local.caches = {}
    return caches.setdefault(device, CombCache())


def comb_for_devices(codes: np.ndarray, quals: np.ndarray, lens_by_row: np.ndarray,
                     combined: np.ndarray, devices: Sequence) -> List[torch.Tensor]:
    """`combined` (the host pack of codes and quals: ops/score.py:
    pack_host) on each entry of `devices` (None: the torch backend's
    device), one matrix per entry, assembled by this thread's cache of
    each distinct device (the rows' keys computed once)."""
    devices = [_device(d) for d in devices]
    rows = _Rows(codes, quals, lens_by_row, combined) if _enabled() else None
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in devices:
        if dev not in out:
            out[dev] = _cache(dev).get(codes, quals, lens_by_row, combined, dev, rows)
    return [out[dev] for dev in devices]


def assemble_reference_numpy(old_comb: np.ndarray, reuse_old, reuse_new,
                             changed, combined: np.ndarray) -> np.ndarray:
    """Numpy model of the device assembly (for tests): must equal
    `combined` exactly when the row mapping is correct."""
    r_new, rw_new = combined.shape
    w = min(old_comb.shape[1], rw_new)
    out = np.full((r_new, rw_new), np.int16(PAD_CODE), np.int16)
    out[np.asarray(reuse_new, np.int64), :w] = \
        old_comb[np.asarray(reuse_old, np.int64), :w]
    if len(changed):
        out[np.asarray(changed, np.int64)] = combined[np.asarray(changed, np.int64)]
    return out
