"""polyte-split: large-genome (>100kb) pipeline.

Rebuild of polyte-split.py: align all reads to the reference, detect
covered regions from the depth profile, bin reads into `split_size`
windows with `split_overlap` halos, run POLYTE per region, concatenate the
per-region contigs with contig-id re-offsetting (original-read provenance
stays global), and finish with a reference-guided POLYTE pass over the
combined contigs (hap_cov=0, no EC).

Uses the built-in seed aligner (ops/align.py) in place of bwa mem -a +
samtools (absent in this environment); each read is placed at its best
diagonal, so the depth/binning behavior matches samtools' primary
alignments rather than `-a` all-alignments.

Every region runs the port's POLYTE (verification through the scoring
kernel, exact re-overlap passes through the join on the card). A region
whose assembly raises is skipped, as in the reference, and recorded in
`PolyteSplitResult.failed_regions` with its exception; a RuntimeError (the
kernel wrapper's, CUDA's, out of memory on the card) is raised, not
skipped, since the host assembly code raises none. With pool_size > 1 the
region threads score on the calling thread's card. Under a process group
the regions are round-robined over the ranks and each scores on its
rank's own card alone (parallel/mesh.py:rank_local); the final pass runs
on every rank through the mesh that spans them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore
from ..io.subreads import SubreadDict
from ..parallel import mesh
from .polyte import PolyteConfig, PolyteResult, concat_to_single_end, run_polyte


@dataclass
class PolyteSplitConfig(PolyteConfig):
    reference: str = ""
    split_size: int = 10000
    split_overlap: int = 1000
    min_region_reads: int = 100  # file_len >= 400 lines
    min_region_depth: int = 2  # maxdepth > 2 required to keep a region
    pool_size: int = 1  # parallel regions (polyte-split.py --pool_size)


@dataclass
class PolyteSplitResult:
    combined_store: Optional[ReadStore]
    combined_subreads: Optional[SubreadDict]
    final: Optional[PolyteResult]
    regions: List[Tuple[str, int, int]] = field(default_factory=list)
    region_results: List[PolyteResult] = field(default_factory=list)
    # diagnostics: the final pass's reference-coordinate candidate count
    # (>0 proves the ref-guided path ran, polyte-split.py:389-430)
    final_ref_candidates: int = 0
    # (region, repr of the exception) for every region whose assembly
    # failed and was skipped
    failed_regions: List[Tuple[Tuple[str, int, int], str]] = field(default_factory=list)


def detect_regions(alignments, ref_lengths: Dict[str, int], average_read_len: float,
                   min_depth: int = 2):
    """Covered-region detection from the depth profile
    (polyte-split.py:267-295): maximal runs of nonzero depth, kept when
    max depth > min_depth and length > average read length."""
    regions: Dict[str, List[Tuple[int, int]]] = {name: [] for name in ref_lengths}
    for name, length in ref_lengths.items():
        depth = np.zeros(length + 1, dtype=np.int64)
        for rec in alignments:
            if rec.rname != name:
                continue
            a = max(0, rec.pos - 1)
            b = min(length, rec.pos - 1 + len(rec.seq))
            depth[a] += 1
            depth[b] -= 1
        cov = np.cumsum(depth[:-1])
        covered = cov > 0
        if not covered.any():
            continue
        edges = np.flatnonzero(np.diff(np.concatenate([[0], covered.view(np.int8), [0]])))
        for s, e in zip(edges[::2], edges[1::2]):
            if cov[s:e].max() > min_depth and (e - s) > average_read_len:
                regions[name].append((int(s) + 1, int(e)))  # 1-based inclusive
    return regions


def split_windows(regions: Dict[str, List[Tuple[int, int]]],
                  ref_lengths: Dict[str, int], split_size: int,
                  split_overlap: int) -> Dict[str, List[Tuple[int, int]]]:
    """Window placement loop (polyte-split.py:300-323)."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for chrom, region_list in regions.items():
        if not region_list:
            continue
        windows = []
        length = ref_lengths[chrom]
        idx = 0
        pos = split_size + region_list[idx][0]
        while idx < len(region_list):
            if region_list[idx][0] >= pos:
                pos = region_list[idx][0] + split_size
            lb = max(0, pos - (split_size + split_overlap))
            ub = min(length, pos)
            windows.append((lb, ub))
            while idx < len(region_list) and region_list[idx][1] < pos:
                idx += 1
            pos += split_size
        out[chrom] = windows
    return out


def same_card_initializer():
    """A thread starts on card 0 (the CUDA current device is per thread):
    region threads take the calling thread's card, the rank's own."""
    import torch

    if not torch.cuda.is_available():
        return None
    card = torch.cuda.current_device()
    return lambda: torch.cuda.set_device(card)


def run_polyte_split(store: ReadStore, cfg: PolyteSplitConfig) -> PolyteSplitResult:
    from ..ops.align import ReferenceIndex, align_store

    assert cfg.reference, "polyte-split requires a reference"
    single_store = concat_to_single_end(store)
    ns = store.readcount_single
    npair2 = 2 * (len(store) - ns)
    total_len = sum(store.unit_len(u) for u in range(store.n_units))
    avg_len = cfg.average_read_len or total_len / max(ns + npair2, 1)
    max_tip_len = cfg.max_tip_len if cfg.max_tip_len is not None else int(round(avg_len))
    mol_ec = cfg.min_overlap_len_EC or int(round(2 + 0.5 * avg_len))

    index = ReferenceIndex.from_fasta(cfg.reference)
    singles, _ = align_store(single_store, index)
    ref_lengths = index.lengths()
    regions = detect_regions(singles, ref_lengths, avg_len, cfg.min_region_depth)
    windows = split_windows(regions, ref_lengths, cfg.split_size, cfg.split_overlap)

    # bin reads into windows by alignment interval overlap
    by_name: Dict[str, List] = {}
    for rec in singles:
        by_name.setdefault(rec.rname, []).append(rec)

    region_cfg = replace(
        cfg,
        original_SE_count=ns,
        original_PE_count=npair2,
        min_overlap_len_EC=mol_ec,
        average_read_len=avg_len,
        max_tip_len=max_tip_len,
    )

    result = PolyteSplitResult(None, None, None)

    # collect region jobs first, then assemble them (optionally with a
    # thread pool over regions, the reference's multiprocessing.Pool at
    # polyte-split.py:335-354)
    jobs: List[Tuple[Tuple[str, int, int], ReadStore]] = []
    for chrom, window_list in windows.items():
        recs = by_name.get(chrom, [])
        for lb, ub in window_list:
            members = [r for r in recs
                       if r.pos - 1 < ub and r.pos - 1 + len(r.seq) > lb]
            if len(members) < cfg.min_region_reads:
                continue
            rstore = ReadStore()
            for rec in sorted(members, key=lambda r: int(r.qname)):
                gid = int(rec.qname)
                u1, _ = single_store.units_of(single_store.id_to_index[gid])
                rstore.add_single_codes(gid, single_store.unit_codes(u1),
                                        single_store.unit_quals(u1))
            rstore.readcount_single = len(rstore)
            jobs.append(((chrom, lb, ub), rstore))

    failures: Dict[int, str] = {}

    def run_region(i: int) -> Optional[PolyteResult]:
        # the ranks assemble different regions, so a region scores on this
        # rank's own card alone, in whichever thread runs it; the final
        # pass, the same calls on every rank, goes through the mesh that
        # spans the ranks. The reference has no such scope: over its
        # global mesh a region's verify would block
        try:
            with mesh.rank_local():
                return run_polyte(jobs[i][1], region_cfg, preprocessing=False,
                                  original_store=single_store)
        except RuntimeError:
            raise  # the card or the kernel failed: never skipped
        except Exception as exc:
            # per-region failures are tolerated (polyte-split.py:537-540)
            failures[i] = repr(exc)
            return None

    # multi-process: regions round-robined over ranks; results allgathered
    # so the final reference-guided pass runs replicated on every rank
    from ..parallel.distributed import (
        allgather_indexed, decode_store_subreads, encode_store_subreads,
        maybe_initialize, my_work_items, process_count)

    maybe_initialize()
    mine = my_work_items(len(jobs)) if process_count() > 1 else list(range(len(jobs)))
    if cfg.pool_size > 1 and len(mine) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cfg.pool_size,
                                initializer=same_card_initializer()) as pool:
            local = list(pool.map(run_region, mine))
    else:
        local = [run_region(i) for i in mine]

    if process_count() > 1:
        def enc(rres):
            if rres is None:
                return None
            use_dip = cfg.diploid and rres.diploid_store and len(rres.diploid_store) > 0
            st = rres.diploid_store if use_dip else rres.store
            sb = rres.diploid_subreads if use_dip else rres.subreads
            blob = encode_store_subreads(st, sb)
            if blob is not None:
                blob["diploid"] = bool(use_dip)
                blob["iterations"] = rres.iterations
            return blob

        def dec(blob):
            st, sb = decode_store_subreads(blob)
            if blob.get("diploid"):
                return PolyteResult(store=st, subreads=sb, diploid_store=st,
                                    diploid_subreads=sb,
                                    iterations=int(blob["iterations"]))
            return PolyteResult(store=st, subreads=sb,
                                iterations=int(blob["iterations"]))

        outcomes = allgather_indexed(local, mine, len(jobs), enc, dec,
                                     allow_missing=True)
        fails = allgather_indexed([failures.get(i) for i in mine], mine, len(jobs),
                                  lambda f: f, lambda f: f, allow_missing=True)
        failures = {i: f for i, f in enumerate(fails) if f is not None}
    else:
        outcomes = local
    result.failed_regions = [(jobs[i][0], failures[i]) for i in sorted(failures)]

    # merge in window order regardless of completion order (determinism)
    combined = ReadStore()
    combined_sub: SubreadDict = {}
    next_contig = 0
    for (region, _), rres in zip(jobs, outcomes):
        result.regions.append(region)
        if rres is None:
            continue
        result.region_results.append(rres)
        out_store = rres.diploid_store if (cfg.diploid and rres.diploid_store
                                           and len(rres.diploid_store) > 0) else rres.store
        out_sub = rres.diploid_subreads if (cfg.diploid and rres.diploid_store
                                            and len(rres.diploid_store) > 0) else rres.subreads
        if out_store is None:
            continue
        for i in range(len(out_store)):
            u1, _ = out_store.units_of(i)
            combined.add_single_codes(next_contig, out_store.unit_codes(u1),
                                      out_store.unit_quals(u1))
            combined_sub[next_contig] = out_sub[int(out_store.ids[i])]
            next_contig += 1
    combined.readcount_single = len(combined)
    result.combined_store = combined
    result.combined_subreads = combined_sub
    if len(combined) == 0:
        return result

    # final REFERENCE-GUIDED pass over the combined contigs
    # (polyte-split.py:389-430: bwa mem -a on the combined contigs, then
    # polyte --ref_guided_mode --hap_cov=0 --no_EC with the ORIGINAL reads'
    # average_read_len/max_tip_len): the initial overlaps are induced from
    # reference coordinates at m_EC = 2+0.5*avg_len, not from de novo
    # contig self-overlaps
    final_cfg = replace(
        cfg,
        hap_cov=0.0,
        error_correction=False,
        min_clique_size=2,
        average_read_len=avg_len,
        max_tip_len=max_tip_len,
        original_SE_count=-1,
        original_PE_count=-1,
    )
    from .savage import ref_guided_candidates

    ref_ov = ref_guided_candidates(combined, index, mol_ec)
    result.final_ref_candidates = int(len(ref_ov))
    result.final = run_polyte(combined, final_cfg, preprocessing=False,
                              initial_overlaps=ref_ov)
    return result
