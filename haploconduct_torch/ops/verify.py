"""Overlap verification — twin of haploconduct_tpu/ops/verify.py:verify_overlaps.

Planning, combining and the exactness machinery are the reference's own
functions, imported unchanged. Only the backend branch differs:
torch | native | numpy | auto. The torch backend scores on the CUDA
device when there is one (the hand-written kernel) and with the kernel's
plain PyTorch version on the CPU otherwise. Its f32 scores then go
through the same clamp, exact mismatch rates and per-task and per-overlap
f64 rechecks at RECHECK_MARGIN as the reference's device paths.
"""

from __future__ import annotations

import numpy as np
import torch

from haploconduct_tpu.core.reads import PackedUnits, ReadStore
from haploconduct_tpu.ops.score import (RECHECK_MARGIN, score_tasks_native,
                                        score_tasks_numpy)
from haploconduct_tpu.ops.verify import (  # noqa: F401
    EDGE_DTYPE, NATIVE_RECHECK_MARGIN, RECHECK_STATS, VerifyResult,
    _exact_mismatch_rates, _near_threshold, _recheck_near_threshold,
    _recheck_tasks_of, combine_scores, length_prefilter, plan_tasks)
from haploconduct_tpu.utils.config import Settings

from .score import score_tasks_torch

# cumulative tasks scored per backend; "recheck" counts the tasks the f64
# oracle re-scored near a threshold (those calls are not a backend's)
BACKEND_COUNTS = {"torch": 0, "native": 0, "numpy": 0, "recheck": 0}


def scoring_device() -> torch.device:
    """The device the torch backend scores on."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def verify_overlaps(
    store: ReadStore,
    packed: PackedUnits,
    ov: np.ndarray,
    s: Settings,
) -> VerifyResult:
    """Score a batch of (pre-filtered) overlaps into edge candidates; the
    contract and exactness guarantees of the reference's verify_overlaps."""
    if s.backend == "auto":
        from .autoback import resolve_backend

        s = s.derive(backend=resolve_backend())
    if s.backend not in ("torch", "native", "numpy"):
        raise ValueError(f"unknown backend {s.backend!r}")
    plan, meta = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens_by_row, plan.row_first, plan.row_second, plan.pos)
    kw = dict(mismatch_thresh=s.mismatch, min_read_len=s.min_read_len)
    n_tasks = len(plan.row_first)
    RECHECK_STATS["tasks"] = 0
    RECHECK_STATS["overlaps"] = 0
    margin = RECHECK_MARGIN
    ts = None
    if s.backend == "native":
        margin = NATIVE_RECHECK_MARGIN
        ts = score_tasks_native(*args, **kw)
        if ts is not None:
            BACKEND_COUNTS["native"] += n_tasks
    elif s.backend == "torch":
        BACKEND_COUNTS["torch"] += n_tasks
        ts = score_tasks_torch(*args, **kw, device=scoring_device())
    if ts is None:  # numpy, or the native extension is unavailable
        BACKEND_COUNTS["numpy"] += n_tasks
        ts = score_tasks_numpy(*args, **kw)
        exact_path = False
    else:
        exact_path = s.exact and n_tasks > 0
        # clamp: rounding must not push a score past the (unattainable)
        # 1.0 ceiling _near_threshold relies on
        ts = ts._replace(score=np.minimum(np.asarray(ts.score, np.float64), 1.0))
        ts = _exact_mismatch_rates(plan, ts, lens_by_row, kw)
        if exact_path:
            ts = _recheck_near_threshold(plan, ts, args, kw, s, margin)

    edges_all = combine_scores(ov, plan, meta, ts, s)

    if exact_path:
        borderline_ov = (_near_threshold(edges_all["score"], s.edge_threshold, margin)
                         | _near_threshold(edges_all["score"], s.ov_threshold, margin))
        if np.any(borderline_ov):
            RECHECK_STATS["overlaps"] = int(np.sum(borderline_ov))
            ts = _recheck_tasks_of(plan, ts, args, kw, borderline_ov)
            # patch only the rechecked overlaps' rows
            idx = np.flatnonzero(borderline_ov)
            edges_all[idx] = combine_scores(ov, plan, meta, ts, s, sel=idx)
    BACKEND_COUNTS["recheck"] += RECHECK_STATS["tasks"]

    score = edges_all["score"]
    mism = edges_all["mismatch_rate"]
    is_edge = (score > s.edge_threshold) | (mism <= s.merge_contigs)
    nonedge = ~is_edge & (score > s.ov_threshold)
    return VerifyResult(
        edges=edges_all[is_edge],
        nonedge_mask=nonedge,
        scored=edges_all,
        n_tasks=n_tasks,
    )
