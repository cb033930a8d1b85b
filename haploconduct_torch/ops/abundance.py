"""Contig abundance (pseudo-alignment + EM) — twin of
haploconduct_tpu/ops/abundance.py:estimate_abundance.

The index, the pseudo-alignment and the f64 host EM are the reference's.
`_em_torch` replaces the jax EM (`_em_device`): the same 500 f32 steps
w = alpha / eff_len, alpha <- w * M^T (cnt / (M w)), in torch ops on the
scoring device. The dense matrix products go to torch.matmul, as the
reference left them to XLA.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from haploconduct_tpu.ops.abundance import (  # noqa: F401
    AbundanceResult, PseudoIndex, _em_numpy, store_unit_seqs)


def _em_torch(membership: np.ndarray, counts: np.ndarray,
              eff_len: np.ndarray, iters: int, device="cpu") -> np.ndarray:
    """EM on `device`: membership (C, T) 0/1, counts (C,); returns
    est_counts (T,) as float64."""
    M = torch.as_tensor(membership, dtype=torch.float32, device=device)
    cnt = torch.as_tensor(counts, dtype=torch.float32, device=device)
    inv_el = torch.as_tensor(1.0 / eff_len, dtype=torch.float32, device=device)
    T = M.shape[1]
    alpha = torch.full((T,), float(counts.sum()) / max(T, 1),
                       dtype=torch.float32, device=device)
    for _ in range(iters):
        w = alpha * inv_el
        resp = cnt / torch.clamp(M @ w, min=1e-30)
        alpha = w * (M.T @ resp)
    return alpha.cpu().numpy().astype(np.float64)


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
    T = index.n_targets()
    class_counts, class_members, n_aligned = index.classify_all(read_seqs)

    eff_len = np.maximum(index.lengths.astype(np.float64) - fragment_len + 1.0, 1.0)
    if not class_counts or T == 0:
        z = np.zeros(T)
        return AbundanceResult(index.names, index.lengths, eff_len, z, z,
                               0, len(read_seqs))

    classes = list(class_counts.keys())
    membership = np.zeros((len(classes), T), dtype=np.float32)
    for c, key in enumerate(classes):
        membership[c, class_members[key]] = 1.0
    counts = np.array([class_counts[c] for c in classes], dtype=np.float64)

    if backend == "auto":
        from .autoback import resolve_backend

        backend = resolve_backend()
    if backend == "torch":
        from .verify import scoring_device

        alpha = _em_torch(membership, counts, eff_len, em_iters, scoring_device())
    else:
        alpha = _em_numpy(membership, counts, eff_len, em_iters)

    rate = np.where(eff_len > 0, alpha / eff_len, 0.0)
    tpm = rate / max(rate.sum(), 1e-300) * 1e6
    return AbundanceResult(index.names, index.lengths, eff_len, alpha, tpm,
                           n_aligned, len(read_seqs))
