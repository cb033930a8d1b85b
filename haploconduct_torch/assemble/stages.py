"""Per-stage convergence driver — in-memory rebuild of
scripts/pipeline_per_stage.py.

Stage a: one error-correction clique iteration (FNO3, double-transitive
reduction) followed by alternating merge iterations (edge merging, FNO1)
and clique iterations until the read count is constant for two consecutive
iterations; stages b/c skip error correction and start with a merge
iteration. Loop conditions and flag sets mirror pipeline_per_stage.py
run_error_correction/run_merging_it/run_clique_it/run_first_it_merge
(pipeline_per_stage.py:138-198, 214-478).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.reads import ReadStore
from ..io.subreads import SubreadDict
from ..utils.config import Settings
from .iteration import overlaps_from_lines, run_iteration


@dataclass
class StageResult:
    store: ReadStore  # final reads (contigs)
    subreads: SubreadDict
    overlap_lines: List[str]
    iterations: int
    history: List[dict] = field(default_factory=list)
    phase_times: dict = field(default_factory=dict)  # summed over iterations


@dataclass
class StageParams:
    stage: str  # 'a', 'b' or 'c'
    min_overlap_len: int = 150
    min_overlap_len_EC: Optional[int] = None
    min_overlap_perc: int = 0
    edge_threshold: float = 0.995
    merge_contigs: float = 0.0  # error rate for mismatch-based merging
    error_correction: bool = True  # stage a only
    first_it: bool = True  # False when resuming from subreads
    remove_branches: bool = False  # pipeline-level flag gating clique its
    min_read_len: int = 0
    diploid: bool = False
    max_tip_len: int = 150
    clique_size_EC: int = 4
    original_readcount: int = 0
    backend: str = "auto"
    verbose: bool = False
    output_dir: str = ""  # when set, per-iteration logs/stats/GFA land here
    dump_dir: str = ""  # when set, snapshot itN_{fastq,overlaps,subreads} there
    # when set, capture a torch.profiler Chrome trace of the whole stage
    # here; phases appear as named host spans, CUDA kernels on the card
    profile_dir: str = ""


def _base_settings(p: StageParams, **overrides) -> Settings:
    s = Settings(
        min_overlap_perc=p.min_overlap_perc,
        min_overlap_len=p.min_overlap_len,
        edge_threshold=p.edge_threshold,
        min_read_len=p.min_read_len,
        max_tip_len=p.max_tip_len,
        diploid=p.diploid,
        original_readcount=p.original_readcount,
        backend=p.backend,
        verbose=p.verbose,
        optimize=False,
    )
    return s.derive(**overrides)


def _dump_iteration(dump_dir, iteration, store, sub, lines) -> None:
    """Per-iteration snapshots in the reference's --copyfiles layout
    (itN_singles.fastq etc.), for side-by-side parity debugging."""
    from ..utils.checkpoint import save_state

    d = os.path.join(dump_dir, "snap")
    os.makedirs(d, exist_ok=True)
    save_state(d, store, sub, None)
    for fname in ("singles.fastq", "paired1.fastq", "paired2.fastq", "subreads.txt"):
        src = os.path.join(d, fname)
        if os.path.exists(src):
            os.replace(src, os.path.join(dump_dir, f"it{iteration}_{fname}"))
    with open(os.path.join(dump_dir, f"it{iteration}_overlaps.txt"), "w") as f:
        for line in lines or []:
            f.write(line.rstrip("\n") + "\n")


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
