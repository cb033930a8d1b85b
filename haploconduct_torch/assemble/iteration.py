"""One assembly iteration — the in-memory equivalent of a full
bin/ViralQuasispecies run (src/ViralQuasispecies.cpp:40-492).

Instead of the reference's file round-trip (fastq + overlaps in, fastq +
overlaps + subreads out, per process invocation), an iteration takes and
returns in-memory structures; the driver stays resident, device buffers are
only rebuilt when the read set changes.

Phases (same order as the reference main):
  verify overlaps -> insert edges -> orientation labelling -> remove
  inclusions -> transitive reduction -> tips -> branch reduction/removal ->
  cycle removal -> cliques/merge -> superreads -> FNO -> next overlaps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.reads import ReadStore
from ..graph import algos
from ..graph.cliques import enumerate_cliques
from ..graph.overlap_graph import OverlapGraph
from ..io.overlaps import empty_overlaps
from ..io.subreads import SubreadDict, trivial_subreads
from ..ops.verify import length_prefilter, verify_overlaps
from ..utils.config import Settings
from ..utils.log import PhaseTimer
from .fno import FNO1, find_next_overlaps3
from .superreads import SuperreadBuilder


@dataclass
class IterationResult:
    store: Optional[ReadStore]  # next iteration's reads (None if terminated)
    subreads: Optional[SubreadDict]
    overlap_lines: List[str]  # next iteration's overlaps (13-col lines)
    terminated: bool  # no edges -> pipeline stops
    stats: dict = field(default_factory=dict)


def trivial_originals(store: ReadStore) -> SubreadDict:
    """First-iteration originals dict (OverlapGraph::buildOriginalsDict
    trivial branch, src/OverlapGraph.cpp:768-793)."""
    lens1 = []
    lens2 = []
    for i in range(len(store)):
        u1, u2 = store.units_of(i)
        lens1.append(store.unit_len(u1))
        lens2.append(store.unit_len(u2) if store.is_paired[i] else 0)
    return trivial_subreads(store.ids, store.is_paired, lens1, lens2)


def run_iteration(
    store: ReadStore,
    overlaps: np.ndarray,
    s: Settings,
    originals_dict: Optional[SubreadDict] = None,
    original_store: Optional[ReadStore] = None,
    threshold_table: Optional[dict] = None,
    logger=None,
    timer: Optional[PhaseTimer] = None,
) -> IterationResult:
    if originals_dict is None:
        assert s.first_it, "originals dict required unless first iteration"
        originals_dict = trivial_originals(store)
    if timer is None:
        timer = PhaseTimer(verbose=s.verbose)

    graph = OverlapGraph(len(store), store, s)
    with timer("pack"):
        packed = store.pack()

    # ---- edge construction (EdgeCalculator::construct_edges)
    with timer("verify"):
        scored_mask, nonedge_prefilter = length_prefilter(overlaps, s)
        if scored_mask.all():
            # the k-mer engine already filters by min overlap length at
            # emission and never emits self overlaps, so iteration 1
            # usually keeps everything — skip the ~45B/row subset copy
            scored_idx = None
            res = verify_overlaps(store, packed, overlaps, s)
        else:
            scored_idx = np.flatnonzero(scored_mask)
            res = verify_overlaps(store, packed, overlaps[scored_idx], s)
    with timer("insert"):
        graph.insert_candidates(res.edges)
        # nonedge overlaps = prefiltered-out + scored-but-subthreshold
        # (single gather through the index composition — the struct rows
        # are ~45B each, so avoiding intermediate copies matters at
        # 12M-candidate scale)
        sub_idx = (np.flatnonzero(res.nonedge_mask) if scored_idx is None
                   else scored_idx[res.nonedge_mask])
        nonedge = np.concatenate([overlaps[nonedge_prefilter],
                                  overlaps[sub_idx]])

    stats = dict(
        n_reads=len(store),
        n_overlaps=len(overlaps),
        n_tasks=res.n_tasks,
        n_edges_initial=graph.edge_count,
        dup_count=graph.dup_count,
        inclusion_count=graph.inclusion_count,
    )
    if graph.edge_count == 0:
        stats["phase_times"] = {k: round(v, 4) for k, v in timer.times.items()}
        return IterationResult(None, None, [], True, stats)

    # ---- orientation labelling
    with timer("labelling"):
        graph.sort_edges()
        stats["conflicts"] = algos.vertex_labelling_heuristic(graph, stats)
        graph.check_no_duplicate_edges()

    with timer("graph_cleanup"):
        if s.ignore_inclusions:
            algos.remove_inclusions(graph)
        algos.remove_transitive_edges(graph)

        if s.remove_tips:
            algos.remove_tips(graph)

    if s.branch_reduction:
        from .branch_reduction import read_based_branch_reduction

        with timer("branch_reduction"):
            read_based_branch_reduction(graph, originals_dict, original_store, threshold_table)
    elif s.remove_branches:
        with timer("graph_cleanup"):
            algos.remove_branches(graph)

    # ---- cycle removal
    with timer("graph_cleanup"):
        graph.sort_edges()
        remove_backedges = not s.error_correction
        backedges = algos.cycle_removal_heuristic(graph, remove_backedges)
    if logger is not None:
        logger.cycles(backedges)
    stats["n_edges_final"] = graph.edge_count
    stats["backedges"] = graph.backedge_count

    if s.graph_only:
        return IterationResult(None, None, [], False, stats)

    # ---- superread construction
    builder = SuperreadBuilder(store, graph, s, originals_dict)
    if s.cliques:
        with timer("cliques"):
            if s.reference_order:
                from ..graph.cliques import enumerate_cliques_ref

                u, v = graph.graph_txt_pairs()
                cliques = enumerate_cliques_ref(graph.n, u, v)
            else:
                v1, v2 = graph.edge_endpoints()
                incl = np.flatnonzero(graph.inclusions)
                keep = ~(np.isin(v1, incl) | np.isin(v2, incl)) if len(incl) else np.ones(len(v1), bool)
                cliques = enumerate_cliques(graph.n, v1[keep], v2[keep])
        with timer("superreads"):
            builder.cliques_to_superreads(cliques)
        stats["n_cliques"] = len(cliques)
    else:
        with timer("superreads"):
            graph.sort_edges()
            builder.merge_along_edges()

    stats["sr_singles"] = len(builder.single_SR)
    stats["sr_paired"] = len(builder.paired_SR)
    stats["sr_trivials"] = len(builder.trivial_SR)

    # ---- next-iteration overlaps
    with timer("fno"):
        if s.fno == 1:
            fno = FNO1(builder)
            lines = fno.run(nonedge_overlaps=None if s.optimize else nonedge)
            stats["fno_nonedges"] = fno.nonedge_rows
            stats["fno_nonedge_scalar"] = fno.nonedge_scalar
        else:
            lines = find_next_overlaps3(builder)
    stats["next_overlaps"] = len(lines)

    with timer("next_store"):
        next_store, next_subreads = builder.build_next_store()
    stats["phase_times"] = {k: round(v, 4) for k, v in timer.times.items()}
    if logger is not None:
        logger.iteration(s, stats, graph)
    return IterationResult(next_store, next_subreads, lines, False, stats)


def overlaps_from_lines(lines: List[str]) -> np.ndarray:
    """Parse in-memory overlap lines (13-col) into the structured array."""
    from ..io.overlaps import parse_overlap_lines

    if not lines:
        return empty_overlaps(0)
    return parse_overlap_lines(lines)
