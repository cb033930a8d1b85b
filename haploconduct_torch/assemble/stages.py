"""Per-stage convergence loop — twin of haploconduct_tpu/assemble/stages.py:
run_stage, driving the twin's run_iteration. StageParams, StageResult and
the settings and snapshot helpers are the reference's; the loop is the
reference's, line for line. A trace of the stage is a torch.profiler
Chrome trace written into profile_dir.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from haploconduct_tpu.assemble.stages import (  # noqa: F401
    StageParams, StageResult, _base_settings, _dump_iteration)
from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.subreads import SubreadDict
from haploconduct_tpu.utils.config import Settings

from .iteration import overlaps_from_lines, run_iteration


def run_stage(
    p: StageParams,
    store: ReadStore,
    overlaps: np.ndarray,
    subreads: Optional[SubreadDict] = None,
) -> StageResult:
    """Run a full stage; with profile_dir set, the run is captured by
    torch.profiler (host spans per phase, CUDA kernels when on the card)
    and exported as a Chrome trace into profile_dir."""
    if not p.profile_dir:
        return _run_stage(p, store, overlaps, subreads)
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(p.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        res = _run_stage(p, store, overlaps, subreads)
    prof.export_chrome_trace(
        os.path.join(p.profile_dir, f"stage_{p.stage}_{time.time_ns()}.trace.json"))
    return res


def _run_stage(
    p: StageParams,
    store: ReadStore,
    overlaps: np.ndarray,
    subreads: Optional[SubreadDict] = None,
) -> StageResult:
    mol_ec = p.min_overlap_len_EC if p.min_overlap_len_EC else p.min_overlap_len
    keep_singletons = max(p.min_overlap_len, p.min_read_len)
    history: List[dict] = []
    iteration = 0

    cur_store, cur_sub, cur_lines = store, subreads, None
    cur_overlaps = overlaps
    read_counts: List[int] = []
    overlap_counts = [len(overlaps)]
    edge_counts: List[int] = [1]

    if p.stage == "a":
        read_counts.append(p.original_readcount or len(store))

    from ..utils.log import PhaseTimer, RunLogger

    logger = RunLogger(p.output_dir or None)
    # shared: accumulates across iterations; annotates xprof spans when tracing
    timer = PhaseTimer(verbose=p.verbose, annotate=bool(p.profile_dir))

    def step(settings: Settings) -> bool:
        """Run one iteration; returns False when the pipeline terminated."""
        nonlocal cur_store, cur_sub, cur_lines, cur_overlaps, iteration
        iteration += 1
        res = run_iteration(cur_store, cur_overlaps, settings, cur_sub,
                            logger=logger, timer=timer)
        history.append(dict(iteration=iteration, mode=_mode_name(settings), **res.stats))
        if res.terminated:
            edge_counts.append(-2)
            return False
        cur_store, cur_sub, cur_lines = res.store, res.subreads, res.overlap_lines
        cur_overlaps = overlaps_from_lines(res.overlap_lines)
        if p.dump_dir:
            _dump_iteration(p.dump_dir, iteration, cur_store, cur_sub, cur_lines)
        read_counts.append(len(cur_store))
        overlap_counts.append(len(res.overlap_lines))
        edge_counts.append(res.stats.get("n_edges_final", 0))
        return True

    def _mode_name(s: Settings) -> str:
        if s.error_correction:
            return "error_correction"
        return "cliques" if s.cliques else "merging"

    # ---- first iteration
    if p.stage == "a" and p.error_correction:
        ec = _base_settings(
            p,
            first_it=p.first_it,
            cliques=True,
            error_correction=True,
            keep_singletons=1000,
            min_clique_size=p.clique_size_EC,
            remove_branches=False,
            min_overlap_len=mol_ec,
            merge_contigs=p.merge_contigs,
            fno=3,
            remove_trans=2,
            store_tips_separately=False,
            ignore_inclusions=False,
        )
        alive = step(ec)
    else:
        # run_first_it_noEC / run_first_it_merge: edge merging from scratch
        first = _base_settings(
            p,
            first_it=p.first_it,
            cliques=False,
            min_clique_size=2,
            keep_singletons=0 if (p.stage == "a") else keep_singletons,
            remove_branches=True,
            merge_contigs=p.merge_contigs,
            fno=1,
            remove_trans=1,
            store_tips_separately=(p.stage != "a"),
            ignore_inclusions=(p.stage != "a"),
        )
        alive = step(first)

    merge_s = _base_settings(
        p,
        first_it=False,
        cliques=False,
        min_clique_size=2,
        keep_singletons=keep_singletons,
        remove_branches=True,
        merge_contigs=p.merge_contigs if p.stage == "c" else 0.0,
        fno=1,
        remove_trans=1,
        store_tips_separately=True,
        ignore_inclusions=True,
    )
    clique_s = merge_s.derive(
        cliques=True, remove_branches=False, fno=3, remove_trans=1,
    )

    const_read_its = 0
    while alive and overlap_counts[-1] > 0 and edge_counts[-1] > 0 and const_read_its < 2:
        while alive and overlap_counts[-1] > 0 and edge_counts[-1] > 0 and const_read_its < 2:
            alive = step(merge_s)
            if not alive:
                break
            if read_counts[-1] == read_counts[-2]:
                const_read_its += 1
            else:
                const_read_its = 0
        # a clique iteration always follows merge convergence (even when
        # const_read_its reached 2 — it can reset the counter); it is a
        # no-op when there are no overlaps/edges left
        if alive and not p.remove_branches and overlap_counts[-1] > 0 and edge_counts[-1] > 0:
            alive = step(clique_s)
            if alive:
                if read_counts[-1] == read_counts[-2]:
                    const_read_its += 1
                else:
                    const_read_its = 0

    return StageResult(
        store=cur_store,
        subreads=cur_sub if cur_sub is not None else {},
        overlap_lines=cur_lines or [],
        iterations=iteration,
        history=history,
        phase_times={k: round(v, 4) for k, v in timer.times.items()},
    )
