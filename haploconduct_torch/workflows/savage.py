"""SAVAGE de novo assembly, stages a -> b -> c — twin of
haploconduct_tpu/workflows/savage.py:run_savage.

The orchestration is the reference's, line for line, over the twins of
run_stage, the process-group helpers and estimate_abundance; the patch
split (seeded random.Random(0)), candidate generation, contig combination
and frequency tables are the reference's own functions. Reference-guided
mode (SavageConfig.reference) is not ported yet and raises.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.subreads import SubreadDict
from haploconduct_tpu.workflows.savage import (  # noqa: F401
    SavageConfig, SavageResult, _freqs, _original_readcount,
    combine_patch_contigs, contig_candidates, denovo_candidates,
    split_into_patches)

from ..assemble.stages import StageParams, StageResult, run_stage


def run_savage(
    store: ReadStore,
    config: SavageConfig = SavageConfig(),
) -> SavageResult:
    cfg = config
    if cfg.reference:
        raise NotImplementedError(
            "reference-guided SAVAGE is not ported to haploconduct_torch yet")
    result = SavageResult()

    total_len = sum(store.unit_len(u) for u in range(store.n_units))
    n_seqs = store.readcount_single + 2 * (len(store) - store.readcount_single)
    avg_len = cfg.average_read_len or (total_len / max(n_seqs, 1))
    min_overlap_len = cfg.min_overlap_len or int(round(0.6 * avg_len))
    max_tip_len = cfg.max_tip_len if cfg.max_tip_len is not None else int(round(avg_len))

    # ---- stage-granular checkpoints (reference: working-dir files +
    # --no_* skip flags, savage.py:58-63, 175-192)
    ckpt_root = os.path.join(cfg.output_dir, "checkpoints") if cfg.output_dir else None

    # checkpoints are only valid for the exact (config, input) they were
    # produced from: resuming after changing k/thresholds/reference/etc.
    # would silently return stale contigs, so each checkpoint carries a
    # fingerprint and a mismatch invalidates it (with a warning).
    import hashlib

    def _fingerprint() -> str:
        h = hashlib.sha256()
        h.update(repr(sorted(
            (k, v) for k, v in vars(cfg).items()
            if k not in ("resume", "verbose", "output_dir")
        )).encode())
        h.update(np.int64(len(store)).tobytes())
        h.update(np.int64(store.readcount_single).tobytes())
        for u in range(store.n_units):
            h.update(store.unit_codes(u).tobytes())
        return h.hexdigest()

    fingerprint = _fingerprint() if ckpt_root else ""

    def ckpt_dir(name: str) -> Optional[str]:
        return os.path.join(ckpt_root, name) if ckpt_root else None

    def ckpt_exists(name: str) -> bool:
        d = ckpt_dir(name)
        if not (d and os.path.exists(os.path.join(d, "singles.fastq"))):
            return False
        fp_file = os.path.join(d, "fingerprint.txt")
        saved = open(fp_file).read().strip() if os.path.exists(fp_file) else ""
        if saved != fingerprint:
            import warnings

            warnings.warn(
                f"checkpoint {name!r} was produced with different parameters "
                "or inputs; ignoring it and recomputing")
            return False
        return True

    def ckpt_save(name: str, cstore: ReadStore, sub: Optional[SubreadDict]):
        if ckpt_root:
            from haploconduct_tpu.utils.checkpoint import save_state

            save_state(ckpt_dir(name), cstore, sub)
            with open(os.path.join(ckpt_dir(name), "fingerprint.txt"), "w") as f:
                f.write(fingerprint + "\n")

    def ckpt_load(name: str):
        from haploconduct_tpu.utils.checkpoint import load_state

        cstore, sub, _ = load_state(ckpt_dir(name))
        return cstore, sub

    # ---- stage a per patch
    if cfg.resume and ckpt_exists("stage_a"):
        combined, combined_sub = ckpt_load("stage_a")
        result.stage_a = StageResult(store=combined, subreads=combined_sub,
                                     overlap_lines=[], iterations=0)
    else:
        patches = split_into_patches(store, cfg.split_num, cfg.revcomp)
        id_maps: List[Dict[int, int]] = [id_map for _, id_map in patches]
        # multi-process: patches round-robined over ranks; contig sets
        # allgathered so stage b/c run replicated (reference: sequential
        # per-patch stage a, savage.py:373-396)
        from ..parallel.distributed import (
            allgather_stage_results, maybe_initialize, my_work_items)

        maybe_initialize()
        mine = my_work_items(len(patches))
        local_results: List[StageResult] = []
        for pidx in mine:
            t_patch = time.time()
            pstore, _ = patches[pidx]
            overlaps = denovo_candidates(pstore, min_overlap_len, cfg.sfo_mm, cfg.kmer_k)
            t_cand = time.time() - t_patch
            params = StageParams(
                stage="a",
                min_overlap_len=min_overlap_len,
                edge_threshold=0.97,
                clique_size_EC=cfg.min_clique_size,
                remove_branches=cfg.remove_branches,
                max_tip_len=max_tip_len,
                original_readcount=len(pstore),
                backend=cfg.backend,
                verbose=cfg.verbose,
                profile_dir=cfg.profile_dir,
            )
            local_results.append(run_stage(params, pstore, overlaps))
            if cfg.progress:
                r = local_results[-1]
                print(f"[savage] patch {pidx + 1}/{len(patches)}: "
                      f"{len(pstore)} reads, {len(overlaps)} candidates "
                      f"({t_cand:.0f}s) -> {len(r.store)} contigs in "
                      f"{r.iterations} its, {time.time() - t_patch:.0f}s",
                      file=sys.stderr, flush=True)
        patch_results = allgather_stage_results(local_results, mine, len(patches))

        combined, combined_sub = combine_patch_contigs(patch_results, id_maps)
        result.stage_a = patch_results[0]
        ckpt_save("stage_a", combined, combined_sub)
    result.combined_store = combined
    result.combined_subreads = combined_sub
    result.frequencies["stage_a"] = _freqs(combined, combined_sub, min_len=1000)
    if not cfg.stage_b or len(combined) == 0:
        return result

    # ---- stage b: extend contigs
    if cfg.resume and ckpt_exists("stage_b"):
        b_store, b_sub = ckpt_load("stage_b")
        res_b = StageResult(store=b_store, subreads=b_sub,
                            overlap_lines=[], iterations=0)
    else:
        t0 = time.time()
        overlaps_b = contig_candidates(combined, min_overlap_len, 200, cfg.kmer_k)
        result.timings["stage_b_candidates_s"] = round(time.time() - t0, 2)
        params_b = StageParams(
            stage="b",
            min_overlap_len=min_overlap_len,
            edge_threshold=0.995,
            remove_branches=cfg.remove_branches,
            max_tip_len=max_tip_len,
            first_it=not cfg.use_subreads,
            original_readcount=_original_readcount(combined_sub),
            backend=cfg.backend,
            verbose=cfg.verbose,
            profile_dir=cfg.profile_dir,
        )
        t0 = time.time()
        res_b = run_stage(params_b, combined, overlaps_b,
                          combined_sub if cfg.use_subreads else None)
        result.timings["stage_b_s"] = round(time.time() - t0, 2)
        if cfg.filtering:
            t0 = time.time()
            res_b = _freq_filter(res_b, store, avg_len, cfg.backend)
            result.timings["stage_b_filter_s"] = round(time.time() - t0, 2)
        ckpt_save("stage_b", res_b.store, res_b.subreads)
    result.stage_b = res_b
    result.frequencies["stage_b"] = _freqs(res_b.store, res_b.subreads, min_len=1000)
    if not cfg.stage_c or len(res_b.store) == 0:
        return result

    # ---- stage c: master strains
    mc = cfg.merge_contigs
    sfo_mm_c = 1 + (0.99 - mc) / (mc + 0.01)
    if cfg.resume and ckpt_exists("stage_c"):
        c_store, c_sub = ckpt_load("stage_c")
        res_c = StageResult(store=c_store, subreads=c_sub,
                            overlap_lines=[], iterations=0)
    else:
        t0 = time.time()
        overlaps_c = contig_candidates(res_b.store, cfg.overlap_len_stage_c, sfo_mm_c, cfg.kmer_k)
        result.timings["stage_c_candidates_s"] = round(time.time() - t0, 2)
        params_c = StageParams(
            stage="c",
            min_overlap_len=cfg.overlap_len_stage_c,
            edge_threshold=0.995,
            merge_contigs=mc,
            remove_branches=cfg.remove_branches,
            min_read_len=cfg.contig_len_stage_c,
            max_tip_len=max_tip_len,
            first_it=not cfg.use_subreads,
            original_readcount=_original_readcount(res_b.subreads),
            backend=cfg.backend,
            verbose=cfg.verbose,
            profile_dir=cfg.profile_dir,
        )
        t0 = time.time()
        res_c = run_stage(params_c, res_b.store, overlaps_c,
                          res_b.subreads if cfg.use_subreads else None)
        result.timings["stage_c_s"] = round(time.time() - t0, 2)
        if cfg.filtering:
            t0 = time.time()
            res_c = _freq_filter(res_c, store, avg_len, cfg.backend)
            result.timings["stage_c_filter_s"] = round(time.time() - t0, 2)
        ckpt_save("stage_c", res_c.store, res_c.subreads)
    result.stage_c = res_c
    result.frequencies["stage_c"] = _freqs(res_c.store, res_c.subreads, min_len=1000)

    if cfg.diploid and len(res_c.store) > 0:
        overlaps_d = contig_candidates(res_c.store, cfg.diploid_overlap_len, sfo_mm_c, cfg.kmer_k)
        params_d = params_c.__class__(
            stage="c",
            min_overlap_len=cfg.diploid_overlap_len,
            edge_threshold=0.995,
            merge_contigs=mc,
            remove_branches=cfg.remove_branches,
            min_read_len=cfg.diploid_contig_len,
            max_tip_len=max_tip_len,
            diploid=True,
            first_it=not cfg.use_subreads,
            original_readcount=_original_readcount(res_c.subreads),
            backend=cfg.backend,
            verbose=cfg.verbose,
            profile_dir=cfg.profile_dir,
        )
        res_d = run_stage(params_d, res_c.store, overlaps_d,
                          res_c.subreads if cfg.use_subreads else None)
        result.diploid = res_d
    return result


def _freq_filter(res: StageResult, read_store: ReadStore, fragment_len: float,
                 backend: str) -> StageResult:
    """Abundance-based contig filtering (savage.py freq_filtering:719-777,
    min_TPM=0): pseudo-align the original input reads against the stage's
    contig panel and drop contigs whose estimated TPM is not > 0. No-op
    when every contig has positive abundance."""
    from dataclasses import replace

    from ..ops.abundance import estimate_abundance, store_unit_seqs

    n = len(res.store)
    if n == 0:
        return res
    ids = [int(res.store.ids[i]) for i in range(n)]
    seqs = [res.store.unit_codes(res.store.unit1[i]) for i in range(n)]
    ab = estimate_abundance([str(i) for i in ids], seqs,
                            store_unit_seqs(read_store),
                            fragment_len=fragment_len, backend=backend)
    keep = ab.tpm > 0.0
    if keep.all():
        return res
    # surviving contigs get NEW consecutive ids, subreads re-keyed — the
    # reference renames filtered contigs to consecutive ids before the
    # next stage (savage.py:456-511 via rename_fas), and downstream
    # contig_candidates emits overlaps in consecutive id space (exposed
    # by the HIV envelope run, where filtering actually dropped contigs)
    filtered = ReadStore()
    sub = {}
    new_id = 0
    for i in range(n):
        if keep[i]:
            u1, _ = res.store.units_of(i)
            filtered.add_single_codes(new_id, res.store.unit_codes(u1),
                                      res.store.unit_quals(u1))
            if ids[i] in res.subreads:
                sub[new_id] = res.subreads[ids[i]]
            new_id += 1
    filtered.readcount_single = len(filtered.ids)
    return replace(res, store=filtered, subreads=sub)
