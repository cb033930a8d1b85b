"""Overlap verification: candidate overlaps -> scored edge candidates.

Implements the type/orientation case algebra of the reference's
EdgeCalculator (src/EdgeCalculator.cpp:143-385) as a vectorized planner:
every overlap, regardless of its S-S / S-P / P-S / P-P case, reduces to one
or two aligned window-scoring *tasks* which are batched onto the device
kernel (ops/score.py); scores are then combined and thresholded on host.

Unified case analysis (derived from the reference's 16 hand-written cases):
for read X with orientation oX define the oriented *lead* and *trail* rows
  single X: lead = trail = oriented(unit, oX)
  paired X: lead  = unit/1 fwd if oX else unit/2 revcomp
            trail = unit/2 fwd if oX else unit/1 revcomp
then task1 = (leadA, leadB, pos1) always, and for paired-involved overlaps
task2 = (trailA, trailB, pos2), argument-swapped for P-S and for P-P with
ord='2'. This reproduces all 16 reference cases exactly.

Backends: torch (the hand-written kernel on the CUDA device, its plain
PyTorch version on the CPU, over parallel/mesh.py:default_mesh(): every
card of the process, or under a process group every rank's own card;
one card is a mesh of one entry), native (the C++ host engine) and numpy
(the f64 oracle). The torch and native scores go through the same clamp,
exact mismatch rates and per-task and per-overlap f64 rechecks at their
margins.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Tuple

import numpy as np

from ..core.reads import PackedUnits, ReadStore
from ..parallel import mesh
from ..utils.config import Settings
from ..utils.log import nested_phase
from .score import (RECHECK_MARGIN, TaskScores, score_tasks_native,
                    score_tasks_numpy, score_tasks_torch)

# The native C++ engine computes per-position probabilities from the SAME
# f64 LUTs as the oracle and accumulates sum_log serially in f64; the only
# drift vs the oracle is summation order (serial vs numpy pairwise), bounded
# by n*eps ~ 512*2.2e-16 ~ 1e-13 relative on sum_log (plus ~1ulp libm-exp
# divergence). 1e-6 is therefore 7 orders above the true bound — rechecking
# within it makes decisions bit-identical while avoiding the f32-calibrated
# 2e-3 margin's mass rescoring (~2% of all tasks at production thresholds).
NATIVE_RECHECK_MARGIN = 1e-6

EDGE_DTYPE = np.dtype(
    [
        ("v1", np.int64),
        ("v2", np.int64),
        ("score", np.float64),
        ("mismatch_rate", np.float64),
        ("pos1", np.int32),
        ("pos2", np.int32),
        ("pos3", np.int32),
        ("pos4", np.int32),
        ("ori1", np.bool_),
        ("ori2", np.bool_),
        ("ord", "S1"),
        ("perc", np.int32),
        ("len1", np.int32),
        ("len2", np.int32),
    ]
)


class VerifyResult(NamedTuple):
    edges: np.ndarray  # EDGE_DTYPE rows accepted as edges
    nonedge_mask: np.ndarray  # overlaps to re-write to nonedge_overlaps
    scored: np.ndarray  # all scored candidates (EDGE_DTYPE), pre-threshold
    n_tasks: int


class TaskPlan(NamedTuple):
    row_first: np.ndarray
    row_second: np.ndarray
    pos: np.ndarray
    # per-overlap indices into the task arrays (-1 when absent)
    t1_of: np.ndarray
    t2_of: np.ndarray


def length_prefilter(ov: np.ndarray, s: Settings) -> Tuple[np.ndarray, np.ndarray]:
    """construct_edges length/perc filters (src/EdgeCalculator.cpp:605-635).

    Returns (scored_mask, nonedge_mask): overlaps to score vs overlaps to
    write back to nonedge_overlaps.txt unseen. Self-overlaps are dropped
    entirely. Uses the FILE types (not the read types), as the reference
    does at this stage.
    """
    self_ov = ov["id1"] == ov["id2"]
    is_ss = (ov["type1"] == b"s") & (ov["type2"] == b"s")
    perc_ok = _perc(ov) >= s.min_overlap_perc
    ss_ok = is_ss & (ov["len1"] >= s.min_overlap_len) & perc_ok
    p_any = ~is_ss
    p_ok = (
        p_any
        & (ov["len1"] >= 0.5 * s.min_overlap_len)
        & (ov["len2"] >= 0.5 * s.min_overlap_len)
        & perc_ok
    )
    relax_ok = (
        s.relax_PE_edges
        & p_any
        & ((ov["len1"] + ov["len2"]) >= s.min_overlap_len)
        & perc_ok
    )
    scored = (ss_ok | p_ok | relax_ok) & ~self_ov
    nonedge = ~(ss_ok | p_ok | relax_ok) & ~self_ov
    return scored, nonedge


def _perc(ov: np.ndarray) -> np.ndarray:
    # int(0.5*(p1+p2)) == (p1+p2)//2 for the non-negative percent fields;
    # integer form avoids two float64 conversion passes over the stream
    p1 = ov["perc1"].astype(np.int64)
    p2 = ov["perc2"].astype(np.int64)
    return np.where(p2 > 0, (p1 + p2) >> 1, p1)


def _id_lookup(store: ReadStore, ids: np.ndarray) -> np.ndarray:
    ids = ids.astype(np.int64)
    if store.ids_identity():
        # internally-built stores have id == index: one bounds check
        if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= len(store.ids)):
            bad = ids[(ids < 0) | (ids >= len(store.ids))]
            raise KeyError(f"overlap references unknown read IDs, e.g. {bad[:5]}")
        return ids
    sorted_keys, order = store.ids_index()
    pos = np.searchsorted(sorted_keys, ids)
    if np.any(pos >= len(sorted_keys)) or np.any(sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] != ids):
        missing = ids[(pos >= len(sorted_keys)) | (sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] != ids)]
        raise KeyError(f"overlap references unknown read IDs, e.g. {missing[:5]}")
    return order[pos]


def plan_tasks(store: ReadStore, packed: PackedUnits, ov: np.ndarray) -> Tuple[TaskPlan, dict]:
    """Build the scoring-task arrays for a batch of overlaps."""
    n = len(ov)
    ia = _id_lookup(store, ov["id1"].astype(np.int64))
    ib = _id_lookup(store, ov["id2"].astype(np.int64))
    paired = np.array(store.is_paired, dtype=bool)
    unit1 = np.array(store.unit1, dtype=np.int64)
    unit2 = np.array(store.unit2, dtype=np.int64)
    ulens = packed.lens.astype(np.int64)
    U = packed.n_units

    p_a, p_b = paired[ia], paired[ib]
    ori_a = ov["ori1"] == b"+"
    ori_b = ov["ori2"] == b"+"
    pos1 = ov["pos1"].astype(np.int64)
    pos2 = ov["pos2"].astype(np.int64)

    ua1, ua2 = unit1[ia], unit2[ia]
    ub1, ub2 = unit1[ib], unit2[ib]
    any_paired = bool(p_a.any() or p_b.any())

    if not any_paired:
        # all-single fast path (the dominant case after stage-a EC: every
        # superread is single-end): lead == trail == oriented unit1, no
        # second task, S-S geometry only
        row_first = np.where(ori_a, ua1, ua1 + U)
        row_second = np.where(ori_b, ub1, ub1 + U)
        pos = pos1
        t1_of = np.arange(n, dtype=np.int64)
        t2_of = np.full(n, -1, dtype=np.int64)
        la1 = ulens[ua1]
        lb1 = ulens[ub1]
        pos3 = la1 - pos1 - lb1
        pos4 = np.zeros(n, dtype=np.int64)
        ss = np.ones(n, dtype=bool)
        meta = dict(
            ia=ia, ib=ib, ss=ss, pos3=pos3, pos4=pos4,
            ori_a=ori_a, ori_b=ori_b, perc=_perc(ov), all_single=True,
        )
        return TaskPlan(row_first, row_second, pos, t1_of, t2_of), meta

    ord1 = ov["ord"] == b"1"
    ord2 = ov["ord"] == b"2"

    def lead_trail(p, o, u1, u2):
        # single: both = oriented unit1; paired: (u1 fwd, u2 fwd) or (u2 rev, u1 rev)
        lead = np.where(p, np.where(o, u1, u2 + U), np.where(o, u1, u1 + U))
        trail = np.where(p, np.where(o, u2, u1 + U), np.where(o, u1, u1 + U))
        return lead, trail

    lead_a, trail_a = lead_trail(p_a, ori_a, ua1, ua2)
    lead_b, trail_b = lead_trail(p_b, ori_b, ub1, ub2)

    has_t2 = p_a | p_b
    swap_t2 = (p_a & ~p_b) | (p_a & p_b & ord2)

    t1_first, t1_second = lead_a, lead_b
    t2_first = np.where(swap_t2, trail_b, trail_a)
    t2_second = np.where(swap_t2, trail_a, trail_b)

    idx2 = np.flatnonzero(has_t2)
    row_first = np.concatenate([t1_first, t2_first[idx2]])
    row_second = np.concatenate([t1_second, t2_second[idx2]])
    pos = np.concatenate([pos1, pos2[idx2]])
    t1_of = np.arange(n, dtype=np.int64)
    t2_of = np.full(n, -1, dtype=np.int64)
    t2_of[idx2] = n + np.arange(len(idx2), dtype=np.int64)

    # integer geometry for the edge record
    la1 = ulens[ua1]
    la2 = np.where(p_a, ulens[np.maximum(ua2, 0)], 0)
    lb1 = ulens[ub1]
    lb2 = np.where(p_b, ulens[np.maximum(ub2, 0)], 0)

    ss = ~p_a & ~p_b
    sp = ~p_a & p_b
    ps = p_a & ~p_b
    pp = p_a & p_b
    pos3 = np.select(
        [ss, sp, ps, pp & ord1, pp & ord2],
        [
            la1 - pos1 - lb1,
            la1 - pos2 - lb2,
            la2 + pos2 - lb1,
            la2 - pos2 - lb2,
            la2 + pos2 - lb2,
        ],
    )
    pos4 = np.select(
        [ss, sp, ps, pp],
        [np.zeros(n, dtype=np.int64), la1 - pos1 - lb1, lb1 + pos1 - la1, la1 - pos1 - lb1],
    )

    meta = dict(
        ia=ia, ib=ib, ss=ss, pos3=pos3, pos4=pos4,
        ori_a=ori_a, ori_b=ori_b, perc=_perc(ov),
    )
    return TaskPlan(row_first, row_second, pos, t1_of, t2_of), meta


def combine_scores(
    ov: np.ndarray,
    plan: TaskPlan,
    meta: dict,
    ts: TaskScores,
    s: Settings,
    sel: "np.ndarray | None" = None,
) -> np.ndarray:
    """Per-overlap score/mismatch combine (src/EdgeCalculator.cpp:254-379).

    With `sel` (overlap indices), combine only that subset — used to patch
    recheck results into an existing edge array instead of recombining the
    whole multi-million-row stream."""
    all_single = meta.get("all_single", False)
    if sel is None:
        n = len(ov)
        t1, t2 = plan.t1_of, plan.t2_of
        ss = meta["ss"]
    else:
        n = len(sel)
        ov = ov[sel]
        t1, t2 = plan.t1_of[sel], plan.t2_of[sel]
        ss = meta["ss"][sel]
    if all_single and sel is None:
        # dominant post-EC case: task k IS overlap k (t1 == arange, no
        # second task) — skip the gathers and the PE combine entirely
        # (~6 full passes over the 12M-row stream per iteration)
        score = ts.score
        mism = ts.mismatch_rate
    else:
        s1 = ts.score[t1]
        m1 = ts.mismatch_rate[t1]
        has2 = t2 >= 0
        s2 = np.where(has2, ts.score[np.maximum(t2, 0)], 0.0)
        m2 = np.where(has2, ts.mismatch_rate[np.maximum(t2, 0)], 0.0)

        both_pass = (s1 > s.edge_threshold) & (s2 > s.edge_threshold)
        score_pe = np.where(both_pass, 0.5 * (s1 + s2), np.minimum(s1, s2))
        score = np.where(ss, s1, score_pe)
        mism = np.where(ss, m1, np.maximum(m1, m2))

    def sub(a):
        return a if sel is None else a[sel]

    edges = np.zeros(n, dtype=EDGE_DTYPE)
    edges["v1"] = sub(meta["ia"])
    edges["v2"] = sub(meta["ib"])
    edges["score"] = score
    edges["mismatch_rate"] = mism
    edges["pos1"] = ov["pos1"]
    edges["pos3"] = sub(meta["pos3"])
    edges["ori1"] = sub(meta["ori_a"])
    edges["ori2"] = sub(meta["ori_b"])
    edges["ord"] = ov["ord"]
    edges["perc"] = sub(meta["perc"])
    edges["len1"] = ov["len1"]
    edges["pos2"] = ov["pos2"]
    if all_single and sel is None:
        # pos4/len2 are guaranteed zero by the all-single plan — the
        # zeros() init already wrote them (2 fewer strided passes)
        return edges
    edges["pos4"] = sub(meta["pos4"])
    # S-S edges record len2=0 even if the file carried one (set_len(len1, 0))
    edges["len2"] = np.where(ss, 0, ov["len2"])
    return edges


# test/diagnostic instrumentation: the tasks/overlaps the exactness
# machinery re-scored in f64 during the last verify_overlaps call to end
# (under region threads, any thread's); BACKEND_COUNTS["recheck"] sums them
RECHECK_STATS = {"tasks": 0, "overlaps": 0}
# cumulative tasks scored per backend; "mesh" counts the torch backend's
# tasks sharded over several devices (every rank of a mesh that spans
# ranks counts the whole stream), "recheck" the tasks the f64 oracle
# re-scored near a threshold (those calls are not a backend's)
BACKEND_COUNTS = {"torch": 0, "mesh": 0, "native": 0, "numpy": 0, "recheck": 0}
_counts_lock = threading.Lock()


def _count(backend: str, n: int) -> None:
    with _counts_lock:
        BACKEND_COUNTS[backend] += n


def verify_overlaps(
    store: ReadStore,
    packed: PackedUnits,
    ov: np.ndarray,
    s: Settings,
) -> VerifyResult:
    """Score a batch of (pre-filtered) overlaps into edge candidates.

    The torch path scores in f32 but every *decision* is exact:
    - mismatch rates are recomputed on host in f64 from the exact integer
      (mismatches, counted) pair the kernel returns;
    - any per-task score within RECHECK_MARGIN of edge/ov thresholds is
      re-scored with the f64 oracle;
    - any *combined* per-overlap score (0.5*(s1+s2) or min(s1,s2),
      src/EdgeCalculator.cpp:254-379) within RECHECK_MARGIN of a threshold
      has BOTH its tasks re-scored in f64 and is re-combined.
    The native engine goes through the same steps at NATIVE_RECHECK_MARGIN.

    Its phases (verify.plan, .score, .rates, .recheck, .combine, .select;
    the torch call's score.* inside verify.score) go to the PhaseTimer
    whose phase is open on this thread (utils/log.py), else nowhere.
    """
    with nested_phase("verify.plan"):
        if s.backend == "auto":
            from .autoback import resolve_backend

            s = s.derive(backend=resolve_backend())
        if s.backend not in ("torch", "native", "numpy"):
            raise ValueError(f"unknown backend {s.backend!r}")
        plan, meta = plan_tasks(store, packed, ov)
        lens_by_row = np.concatenate([packed.lens, packed.lens])
        args = (packed.codes, packed.quals, lens_by_row, plan.row_first, plan.row_second,
                plan.pos)
        kw = dict(mismatch_thresh=s.mismatch, min_read_len=s.min_read_len)
        n_tasks = len(plan.row_first)
        # this call's rechecks, counted locally: region threads verify at once
        rechecked = {"tasks": 0, "overlaps": 0}
        margin = RECHECK_MARGIN
    with nested_phase("verify.score"):
        ts = None
        if s.backend == "native":
            margin = NATIVE_RECHECK_MARGIN
            ts = score_tasks_native(*args, **kw)
            if ts is not None:
                _count("native", n_tasks)
        elif s.backend == "torch":
            devices = mesh.default_mesh()
            _count("mesh" if len(devices) > 1 else "torch", n_tasks)
            ts = score_tasks_torch(*args, **kw, device=devices)
        oracle = ts is None  # numpy, or the native extension is unavailable
        if oracle:
            _count("numpy", n_tasks)
            ts = score_tasks_numpy(*args, **kw)
    exact_path = not oracle and s.exact and n_tasks > 0
    if not oracle:
        with nested_phase("verify.rates"):
            # clamp: rounding must not push a score past the (unattainable)
            # 1.0 ceiling _near_threshold relies on
            ts = ts._replace(score=np.minimum(np.asarray(ts.score, np.float64), 1.0))
            ts = _exact_mismatch_rates(plan, ts, lens_by_row, kw)
    if exact_path:
        with nested_phase("verify.recheck"):
            ts = _recheck_near_threshold(plan, ts, args, kw, s, rechecked, margin)

    with nested_phase("verify.combine"):
        edges_all = combine_scores(ov, plan, meta, ts, s)

    if exact_path:
        with nested_phase("verify.recheck"):
            borderline_ov = (_near_threshold(edges_all["score"], s.edge_threshold, margin)
                             | _near_threshold(edges_all["score"], s.ov_threshold, margin))
            if np.any(borderline_ov):
                rechecked["overlaps"] = int(np.sum(borderline_ov))
                ts = _recheck_tasks_of(plan, ts, args, kw, borderline_ov, rechecked)
                # patch only the rechecked overlaps' rows
                idx = np.flatnonzero(borderline_ov)
                edges_all[idx] = combine_scores(ov, plan, meta, ts, s, sel=idx)
    with nested_phase("verify.select"):
        with _counts_lock:
            BACKEND_COUNTS["recheck"] += rechecked["tasks"]
            RECHECK_STATS.update(rechecked)
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


def _exact_mismatch_rates(plan: TaskPlan, ts: TaskScores, lens_by_row, kw) -> TaskScores:
    """Replace the device's f32 mismatch rates by exact f64 ratios.

    mismatches and counted are exact integers from the kernel, and the
    degenerate/rejected conditions are exact integer/boolean comparisons
    reproducible on host — so mismatch_rate needs no margin machinery at
    all (reference comparison: mismatch_rate <= merge_contigs evaluated in
    C++ double, src/EdgeCalculator.cpp:404-409).
    """
    if len(plan.row_first) == 0:
        return ts
    min_read_len = kw["min_read_len"]
    if min_read_len == 0:
        # pos >= len_a implies zero valid positions, so with no min-length
        # constraint `counted == 0` IS the degenerate set — skip two
        # 12M-element row-length gathers on the hot savage path
        degenerate = ts.counted == 0
    else:
        len_a = lens_by_row[plan.row_first].astype(np.int64)
        len_b = lens_by_row[plan.row_second].astype(np.int64)
        degenerate = (
            (plan.pos >= len_a)
            | (len_a < min_read_len)
            | (len_b < min_read_len)
            | (ts.counted == 0)
        )
    ok = ~degenerate & ~ts.rejected
    with np.errstate(divide="ignore", invalid="ignore"):
        exact = np.where(
            ok, ts.mismatches.astype(np.float64) / np.maximum(ts.counted, 1), 1.0
        )
    return ts._replace(mismatch_rate=exact)


def _near_threshold(score: np.ndarray, thresh: float,
                    margin: float = RECHECK_MARGIN) -> np.ndarray:
    """Scores within `margin` of a threshold whose `score > thresh`
    decision backend rounding could actually flip.

    - thresh >= 1.0: unattainable. Scores are exp(mean log p) with every
      p < 1, so score < 1.0 in exact math, and device scores are clamped
      to <= 1.0 — the decision is False in every precision. This matters
      enormously for POLYTE's merge iterations (edge_threshold=1.0,
      polyte.py run_viralquasispecies), where every high-quality overlap
      scores within 2e-3 of 1.0 and the margin rule alone would re-run
      the f64 oracle on nearly the whole stream.
    - thresh <= 0.0: `score > 0` is exactly the integer-derived ok mask
      (degenerate/rejected -> literal 0.0; otherwise exp(mean log p) with
      p >= ~3e-10 per position, far above f32 underflow), so the decision
      is identical in every precision.
    Only 0 < thresh < 1 thresholds get the margin re-scoring."""
    if thresh >= 1.0 or thresh <= 0.0:
        return np.zeros(len(score), dtype=bool)
    return np.abs(score - thresh) < margin


def _recheck_near_threshold(plan: TaskPlan, ts: TaskScores, args, kw,
                            s: Settings, rechecked: dict,
                            margin: float = RECHECK_MARGIN) -> TaskScores:
    """Re-score near-threshold tasks with the f64 oracle."""
    borderline_task = (_near_threshold(ts.score, s.edge_threshold, margin)
                       | _near_threshold(ts.score, s.ov_threshold, margin))
    if not np.any(borderline_task):
        return ts
    return _recheck_task_idx(plan, ts, args, kw, np.flatnonzero(borderline_task),
                             rechecked)


def _recheck_tasks_of(plan: TaskPlan, ts: TaskScores, args, kw, ov_mask: np.ndarray,
                      rechecked: dict) -> TaskScores:
    """Re-score (in f64) every task belonging to the masked overlaps."""
    t1 = plan.t1_of[ov_mask]
    t2 = plan.t2_of[ov_mask]
    idx = np.unique(np.concatenate([t1, t2[t2 >= 0]]))
    return _recheck_task_idx(plan, ts, args, kw, idx, rechecked)


def _recheck_task_idx(plan: TaskPlan, ts: TaskScores, args, kw, idx: np.ndarray,
                      rechecked: dict) -> TaskScores:
    rechecked["tasks"] += len(idx)
    codes, quals, lens_by_row = args[0], args[1], args[2]
    redo = score_tasks_numpy(
        codes, quals, lens_by_row,
        plan.row_first[idx], plan.row_second[idx], plan.pos[idx], **kw,
    )
    out = TaskScores(*(a.copy() for a in ts))
    out.score[idx] = redo.score
    out.mismatch_rate[idx] = redo.mismatch_rate
    out.sum_log[idx] = redo.sum_log
    out.counted[idx] = redo.counted
    out.mismatches[idx] = redo.mismatches
    out.rejected[idx] = redo.rejected
    return out
