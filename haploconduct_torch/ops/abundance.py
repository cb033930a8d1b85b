"""Contig abundance estimation: pseudo-alignment + EM (kallisto replacement).

The reference shells out to kallisto for contig abundance (TPM) after
stages b/c (savage.py:780-821, freq_filtering at savage.py:719-777) and in
freq_est's kallisto mode (savage/freq_est.py:230). This module rebuilds
that model:

- *pseudo-alignment*: each read is assigned the equivalence class of
  contigs compatible with it — the intersection of the contig sets of its
  k-mers (k=31, both strands), skipping k-mers absent from the index
  (kallisto's intersection over observed k-mers);
- *EM*: classic transcript-abundance EM over equivalence-class counts with
  effective lengths eff_len = max(len - frag_len + 1, 1). Backend torch
  runs 500 f64 steps w = alpha / eff_len, alpha <- w * M^T (cnt / (M w)) in
  torch ops on the scoring device (the dense matrix products go to
  torch.matmul); native and numpy run the same f64 EM on the host. The
  reference's device EM (`_em_device`) runs in f32, where the mass of a
  contig whose reads are all shared with a stronger one decays below
  f32's range within the 500 steps and becomes 0, so the `tpm > 0` filter
  drops a contig the f64 host EM keeps; the port runs the f64 EM on the
  card instead, which also leaves no TF32 mode to the caller;
- *TPM*: (est_counts / eff_len) normalized to 1e6, matching kallisto's
  abundance.tsv column.

Host side builds the k-mer index with the same vectorized hashing as the
overlap engine (ops/kmer.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.reads import revcomp_codes
from ..parallel.devices import default_device
from .kmer import _kmer_hashes


@dataclass
class AbundanceResult:
    names: List[str]
    lengths: np.ndarray  # (T,) int64
    eff_lengths: np.ndarray  # (T,) float64
    est_counts: np.ndarray  # (T,) float64
    tpm: np.ndarray  # (T,) float64
    n_pseudoaligned: int
    n_reads: int

    def table(self) -> str:
        """kallisto abundance.tsv layout."""
        lines = ["target_id\tlength\teff_length\test_counts\ttpm"]
        for i, name in enumerate(self.names):
            lines.append(
                f"{name}\t{int(self.lengths[i])}\t{self.eff_lengths[i]:g}\t"
                f"{self.est_counts[i]:g}\t{self.tpm[i]:g}")
        return "\n".join(lines) + "\n"


class PseudoIndex:
    """k-mer -> contig-set index over a contig panel (both strands)."""

    def __init__(self, names: Sequence[str], seqs: Sequence[np.ndarray], k: int = 31):
        self.names = list(names)
        self.k = k
        self.lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        hashes, tids = [], []
        for t, sq in enumerate(seqs):
            for strand_seq in (sq, revcomp_codes(sq)):
                h = _kmer_hashes(strand_seq, k)
                h = h[h >= 0]
                hashes.append(h)
                tids.append(np.full(len(h), t, dtype=np.int32))
        h = np.concatenate(hashes) if hashes else np.zeros(0, np.int64)
        t = np.concatenate(tids) if tids else np.zeros(0, np.int32)
        # unique (hash, tid) pairs, sorted by hash
        key = np.stack([h, t.astype(np.int64)], axis=1)
        if len(key):
            order = np.lexsort((key[:, 1], key[:, 0]))
            key = key[order]
            keep = np.ones(len(key), dtype=bool)
            keep[1:] = np.any(key[1:] != key[:-1], axis=1)
            key = key[keep]
        self.h = key[:, 0] if len(key) else np.zeros(0, np.int64)
        self.tid = key[:, 1].astype(np.int32) if len(key) else np.zeros(0, np.int32)

    def n_targets(self) -> int:
        return len(self.names)

    def classify_all(self, read_seqs: Sequence[np.ndarray],
                     chunk: int = 16384):
        """Equivalence classes for ALL reads in vectorized passes —
        identical semantics to per-read classify() (intersection of the
        contig sets of the read's unique k-mers, skipping k-mers absent
        from the index; None when nothing matches or the intersection is
        empty), but ~50x faster: the per-read Python loop was 700s of the
        10,000x envelope wall (BASELINE.md round 5).

        Count formulation: contig t is in read r's class iff t appears in
        the tid-list of EVERY matched k-mer of r, i.e. its (r, t) pair
        count equals r's matched-k-mer count.

        Returns (class_counts: {key: count}, class_members: {key:
        int32 contig ids}, n_aligned); keys are the members arrays'
        bytes."""
        from scipy.sparse import csr_matrix

        from .kmer import _kmer_table

        T = self.n_targets()
        class_counts: Dict[bytes, int] = {}
        class_members: Dict[bytes, np.ndarray] = {}
        n_aligned = 0
        for start in range(0, len(read_seqs), chunk):
            batch = read_seqs[start:start + chunk]
            B = len(batch)
            lens = np.fromiter(map(len, batch), np.int64, count=B)
            h, rix, _ = _kmer_table(batch, lens, self.k, seed_step=1)
            if len(h) == 0:
                continue
            # per-read unique hashes (classify() does np.unique per read)
            order = np.lexsort((h, rix))
            h, rix = h[order], rix[order]
            first = np.ones(len(h), dtype=bool)
            first[1:] = (h[1:] != h[:-1]) | (rix[1:] != rix[:-1])
            h, rix = h[first], rix[first]
            # chunk-unique hashes: high-coverage read sets share few
            # distinct k-mers, so the index expansion happens ONCE per
            # distinct hash and the per-(read, contig) counting rides a
            # scipy CSR matmul instead of a flat expansion
            uh, inv = np.unique(h, return_inverse=True)
            lo = np.searchsorted(self.h, uh, side="left")
            hi = np.searchsorted(self.h, uh, side="right")
            hit_h = hi > lo
            sel = hit_h[inv]
            if not sel.any():
                continue
            rix_s, inv_s = rix[sel], inv[sel]
            m_r = np.bincount(rix_s, minlength=B)
            U = len(uh)
            A = csr_matrix(
                (np.ones(len(rix_s), np.int32), (rix_s, inv_s)),
                shape=(B, U))
            hcnt = (hi - lo)[hit_h]
            Eh = int(hcnt.sum())
            base = np.cumsum(hcnt) - hcnt
            flat = (np.arange(Eh, dtype=np.int64)
                    - np.repeat(base, hcnt) + np.repeat(lo[hit_h], hcnt))
            rowsB = np.repeat(np.flatnonzero(hit_h), hcnt)
            Bm = csr_matrix(
                (np.ones(Eh, np.int32), (rowsB, self.tid[flat])),
                shape=(U, T))
            cnt = A @ Bm  # (B, T) sparse: co-occurrence counts
            cnt.sort_indices()
            row_nnz = np.diff(cnt.indptr)
            keep = cnt.data == np.repeat(m_r, row_nnz)
            rows = np.repeat(np.arange(B), row_nnz)[keep]
            cols32 = cnt.indices[keep].astype(np.int32)
            row_counts = np.bincount(rows, minlength=B)
            offs = np.concatenate([[0], np.cumsum(row_counts)])
            for r in np.flatnonzero(row_counts):
                mem = cols32[offs[r]:offs[r + 1]]
                key = mem.tobytes()
                class_counts[key] = class_counts.get(key, 0) + 1
                if key not in class_members:
                    class_members[key] = mem
                n_aligned += 1
        return class_counts, class_members, n_aligned

    def classify(self, read_codes: np.ndarray) -> Optional[frozenset]:
        """Equivalence class (frozenset of contig ids) for one read, or
        None when no k-mer matches the index (not pseudoaligned)."""
        h = _kmer_hashes(read_codes, self.k)
        h = np.unique(h[h >= 0])
        if len(h) == 0:
            return None
        left = np.searchsorted(self.h, h, side="left")
        right = np.searchsorted(self.h, h, side="right")
        hit = right > left
        if not np.any(hit):
            return None
        cls: Optional[frozenset] = None
        for lo, hi in zip(left[hit], right[hit]):
            tset = frozenset(int(t) for t in self.tid[lo:hi])
            cls = tset if cls is None else (cls & tset)
            if not cls:
                return None
        return cls


def _em_torch(membership: np.ndarray, counts: np.ndarray,
              eff_len: np.ndarray, iters: int, device=None) -> np.ndarray:
    """_em_numpy's f64 EM on `device` (None: the torch backend's device,
    parallel/devices.py:default_device): membership (C, T) 0/1, counts (C,);
    returns est_counts (T,) as float64."""
    if device is None:
        device = default_device()
    f64 = torch.float64
    M = torch.as_tensor(membership, dtype=f64, device=device)
    cnt = torch.as_tensor(counts, dtype=f64, device=device)
    inv_el = torch.as_tensor(1.0 / eff_len, dtype=f64, device=device)
    T = M.shape[1]
    alpha = torch.full((T,), float(counts.sum()) / max(T, 1),
                       dtype=f64, device=device)
    for _ in range(iters):
        w = alpha * inv_el
        resp = cnt / torch.clamp(M @ w, min=1e-300)
        alpha = w * (M.T @ resp)
    return alpha.cpu().numpy()


def _em_numpy(membership: np.ndarray, counts: np.ndarray,
              eff_len: np.ndarray, iters: int) -> np.ndarray:
    M = membership.astype(np.float64)
    cnt = counts.astype(np.float64)
    inv_el = 1.0 / eff_len
    T = M.shape[1]
    alpha = np.full(T, cnt.sum() / max(T, 1))
    for _ in range(iters):
        w = alpha * inv_el
        denom = np.maximum(M @ w, 1e-300)
        alpha = w * (M.T @ (cnt / denom))
    return alpha


def merge_classes(parts):
    """One classify_all result from the results of contiguous read slices,
    given in slice order: counts summed, a class's first members array
    kept, classes in order of first appearance, n_aligned summed. classify_all
    inserts classes in read order, so the merge equals one pass over the
    slices' reads, dict order included."""
    class_counts: Dict[bytes, int] = {}
    class_members: Dict[bytes, np.ndarray] = {}
    n_aligned = 0
    for counts, members, aligned in parts:
        for key, count in counts.items():
            class_counts[key] = class_counts.get(key, 0) + count
            if key not in class_members:
                class_members[key] = members[key]
        n_aligned += aligned
    return class_counts, class_members, n_aligned


def estimate_abundance(
    names: Sequence[str],
    contig_seqs: Sequence[np.ndarray],
    read_seqs: Sequence[np.ndarray],
    fragment_len: float = 200.0,
    k: int = 31,
    em_iters: int = 500,
    backend: str = "auto",
) -> AbundanceResult:
    """Pseudo-align `read_seqs` against the contig panel and EM-estimate
    per-contig counts and TPM; backend torch runs the EM on the scoring
    device, native and numpy the reference's f64 host EM."""
    index = PseudoIndex(names, contig_seqs, k=k)
    return abundance_from_classes(index, index.classify_all(read_seqs),
                                  len(read_seqs), fragment_len, em_iters, backend)


def abundance_from_classes(index: PseudoIndex, classes, n_reads: int,
                           fragment_len: float = 200.0, em_iters: int = 500,
                           backend: str = "auto") -> AbundanceResult:
    """estimate_abundance's EM and TPM from the equivalence classes
    (classify_all's result) of `n_reads` reads against `index`."""
    class_counts, class_members, n_aligned = classes
    T = index.n_targets()

    eff_len = np.maximum(index.lengths.astype(np.float64) - fragment_len + 1.0, 1.0)
    if not class_counts or T == 0:
        z = np.zeros(T)
        return AbundanceResult(index.names, index.lengths, eff_len, z, z,
                               0, n_reads)

    keys = list(class_counts.keys())
    membership = np.zeros((len(keys), T), dtype=np.float32)
    for c, key in enumerate(keys):
        membership[c, class_members[key]] = 1.0
    counts = np.array([class_counts[c] for c in keys], dtype=np.float64)

    if backend == "auto":
        from .autoback import resolve_backend

        backend = resolve_backend()
    if backend == "torch":
        alpha = _em_torch(membership, counts, eff_len, em_iters)
    else:
        alpha = _em_numpy(membership, counts, eff_len, em_iters)

    rate = np.where(eff_len > 0, alpha / eff_len, 0.0)
    tpm = rate / max(rate.sum(), 1e-300) * 1e6
    return AbundanceResult(index.names, index.lengths, eff_len, alpha, tpm,
                           n_aligned, n_reads)


def store_unit_seqs(store) -> List[np.ndarray]:
    """All sequence units of a ReadStore (singles, then /1 then /2 ends),
    the same per-fragment view kallisto gets in --single mode
    (savage.py:799-807 passes s, p1, p2 as independent single-end files)."""
    out = []
    for u in range(store.n_units):
        out.append(store.unit_codes(u))
    return out
