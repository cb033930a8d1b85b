"""SAVAGE workflow: de novo viral quasispecies assembly, stages a -> b -> c.

In-memory rebuild of the reference's savage.py orchestration:
- preprocessing: random patch split (seeded like scripts/random_split_fastq)
  and /2 revcomp option (savage.py:286-342);
- candidate overlaps per patch via the k-mer engine (replacing
  rust-overlaps + sfo2overlaps, savage.py:643-677);
- stage a per patch (error correction + merging, pipeline_per_stage);
- combine patch contigs paired-to-single with global subread re-keying
  (scripts/combine_contigs.py);
- stage b on the combined contigs (contig overlaps at 0.5% error), stage c
  with mismatch-rate contig merging, optional diploid round
  (savage.py:401-566);
- quick-mode frequency estimation (workflows/freq_est.py).

Verification in every stage goes through the port's scorer (the CUDA
kernel on a card), and the b/c abundance filters through its EM.
"""

from __future__ import annotations

import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore, revcomp_codes
from ..io.sfo import sfo_to_overlaps
from ..io.subreads import OriginalIndex, SubreadDict
from ..ops.kmer import find_overlap_candidates
from ..assemble.stages import StageParams, StageResult, run_stage
from .freq_est import FreqResult, estimate_frequencies


@dataclass
class SavageConfig:
    min_overlap_len: Optional[int] = None  # default 0.6 * avg read len
    split_num: int = 1
    reference: Optional[str] = None  # fasta path -> reference-guided mode
    revcomp: bool = False
    merge_contigs: float = 0.0
    min_clique_size: int = 4
    overlap_len_stage_c: int = 100
    contig_len_stage_c: int = 100
    remove_branches: bool = True  # savage default (--keep_branches disables)
    sfo_mm: int = 50
    diploid: bool = False
    diploid_contig_len: int = 200
    diploid_overlap_len: int = 30
    average_read_len: Optional[float] = None
    max_tip_len: Optional[int] = None
    use_subreads: bool = True
    stage_a: bool = True
    stage_b: bool = True
    stage_c: bool = True
    filtering: bool = True  # abundance-based contig filtering (--no_filtering)
    output_dir: Optional[str] = None  # enables stage-granular checkpoints
    resume: bool = False  # reuse completed stage checkpoints (reference
    # savage.py --no_stage_a/--no_stage_b skip semantics, files-based)
    backend: str = "auto"
    kmer_k: int = 20
    profile_dir: str = ""  # a torch.profiler Chrome trace per stage
    verbose: bool = False
    progress: bool = False  # one stderr line per patch/stage (envelope runs)


@dataclass
class SavageResult:
    stage_a: Optional[StageResult] = None
    stage_b: Optional[StageResult] = None
    stage_c: Optional[StageResult] = None
    diploid: Optional[StageResult] = None
    combined_store: Optional[ReadStore] = None
    combined_subreads: Optional[SubreadDict] = None
    frequencies: Dict[str, FreqResult] = field(default_factory=dict)
    # per-stage wall/candidate seconds (stage b/c profile, SURVEY §5
    # tracing; per-phase splits live in each StageResult.phase_times)
    timings: Dict[str, float] = field(default_factory=dict)
    # stage a's phase seconds summed over this process's patches
    # (stage_a.phase_times holds patch 0's alone)
    stage_a_phase_times: Dict[str, float] = field(default_factory=dict)

    def contigs(self, stage: str) -> Tuple[List[int], List[str]]:
        res = getattr(self, f"stage_{stage}" if stage in "abc" else stage)
        store = res.store if stage != "a" else self.combined_store
        from ..core.reads import decode_seq

        ids, seqs = [], []
        for i in range(len(store)):
            ids.append(int(store.ids[i]))
            seqs.append(decode_seq(store.unit_codes(store.unit1[i])))
        return ids, seqs


def _py2_randint_below(rng_state: random.Random, n: int) -> int:
    """Python-2 randint(0, n-1): int(random() * n) (scripts/
    random_split_fastq.py:33-40 used py2 randrange semantics)."""
    return int(rng_state.random() * n)


def split_into_patches(store: ReadStore, split_num: int, revcomp: bool):
    """Random patch split (seed 0). Returns per patch a ReadStore with
    LOCAL ids (singles 0.., paired continuing) plus a local->global id map.

    Global ids are assigned by position: singles file order first, then
    pairs — matching combine_contigs' line-number convention
    (scripts/combine_contigs.py:93-110).
    """
    rng = random.Random()
    rng.seed(0)
    ns = store.readcount_single
    npair = len(store) - ns
    single_patch = [_py2_randint_below(rng, split_num) for _ in range(ns)]
    rng2 = random.Random()
    rng2.seed(0)
    pair_patch = [_py2_randint_below(rng2, split_num) for _ in range(npair)]

    patches = []
    for p in range(split_num):
        pstore = ReadStore()
        id_map: Dict[int, int] = {}
        local = 0
        for i in range(ns):
            if single_patch[i] != p:
                continue
            u1, _ = store.units_of(i)
            pstore.add_single_codes(local, store.unit_codes(u1), store.unit_quals(u1))
            id_map[local] = i
            local += 1
        pstore.readcount_single = local
        for j in range(npair):
            if pair_patch[j] != p:
                continue
            i = ns + j
            u1, u2 = store.units_of(i)
            c2, q2 = store.unit_codes(u2), store.unit_quals(u2)
            if revcomp:
                c2, q2 = revcomp_codes(c2), q2[::-1]
            pstore.add_paired_codes(local, store.unit_codes(u1), store.unit_quals(u1), c2, q2)
            id_map[local] = i
            local += 1
        patches.append((pstore, id_map))
    return patches


def denovo_candidates(store: ReadStore, min_overlap_len: int, sfo_mm: int, k: int = 20):
    """Per-patch candidate overlaps: concatenated s+p1+p2 sequences through
    the k-mer engine, converted by the SFO->overlaps path
    (savage.py:643-677: sfo_len halved when paired reads are present)."""
    ns = store.readcount_single
    npair = len(store) - ns
    seqs = [store.unit_codes(store.unit1[i]) for i in range(ns)]
    seqs += [store.unit_codes(store.unit1[ns + i]) for i in range(npair)]
    seqs += [store.unit_codes(store.unit2[ns + i]) for i in range(npair)]
    sfo_len = int(round(min_overlap_len / 2)) if npair > 0 else min_overlap_len
    sfo = find_overlap_candidates(seqs, min_overlap_len=sfo_len, k=k,
                                  error_rate=1.0 / sfo_mm)
    return sfo_to_overlaps(sfo, num_singles=ns, num_pairs=npair)


def ref_guided_candidates(store: ReadStore, ref_index, min_overlap_len: int):
    """Reference-guided overlap induction: align reads with the built-in
    seed aligner (or externally supplied SAM), induce overlaps through
    reference coordinates (savage.py preprocessing_ref:679-699; halved
    min length when paired reads are present)."""
    from ..io.sam import sam_to_overlaps
    from ..io.overlaps import parse_overlap_lines
    from ..ops.align import align_store

    has_paired = len(store) > store.readcount_single
    mol = int(round(min_overlap_len / 2)) if has_paired else min_overlap_len
    singles, paired = align_store(store, ref_index)
    lines = sam_to_overlaps(ref_index.lengths(), singles, paired, mol)
    return parse_overlap_lines(lines)


def contig_candidates(store: ReadStore, min_overlap_len: int, sfo_mm: float, k: int = 20):
    """Contig-overlap candidates for stages b/c (savage.py run_sfo)."""
    seqs = [store.unit_codes(store.unit1[i]) for i in range(len(store))]
    sfo = find_overlap_candidates(seqs, min_overlap_len=min_overlap_len, k=k,
                                  error_rate=1.0 / sfo_mm)
    return sfo_to_overlaps(sfo, num_singles=len(seqs), num_pairs=0)


def combine_patch_contigs(
    patch_results: List[StageResult],
    patch_id_maps: List[Dict[int, int]],
) -> Tuple[ReadStore, SubreadDict]:
    """paired-to-single combination of per-patch stage-a contigs with
    subread re-keying to global original ids (scripts/combine_contigs.py)."""
    combined = ReadStore()
    subdict: SubreadDict = {}
    next_id = 0

    def rekey(originals: Dict[int, OriginalIndex], id_map: Dict[int, int]):
        return {id_map[oid]: oi for oid, oi in originals.items()}

    for res, id_map in zip(patch_results, patch_id_maps):
        store = res.store
        ns = store.readcount_single
        npair = len(store) - ns
        # single-end contigs first
        base = next_id
        for i in range(ns):
            u1, _ = store.units_of(i)
            combined.add_single_codes(next_id, store.unit_codes(u1), store.unit_quals(u1))
            subdict[next_id] = rekey(res.subreads[int(store.ids[i])], id_map)
            next_id += 1
        # paired contigs split into two single-end contigs: all /1 parts,
        # then all /2 parts (combine_contigs cat order)
        for j in range(npair):
            i = ns + j
            u1, _ = store.units_of(i)
            combined.add_single_codes(next_id, store.unit_codes(u1), store.unit_quals(u1))
            orig = res.subreads[int(store.ids[i])]
            subdict[next_id] = {
                id_map[oid]: OriginalIndex(index1=oi.index1, is_paired=False,
                                           forward=oi.forward, len1=oi.len1)
                for oid, oi in orig.items()
            }
            next_id += 1
        for j in range(npair):
            i = ns + j
            _, u2 = store.units_of(i)
            combined.add_single_codes(next_id, store.unit_codes(u2), store.unit_quals(u2))
            orig = res.subreads[int(store.ids[i])]
            subdict[next_id] = {
                id_map[oid]: OriginalIndex(index1=oi.index2, is_paired=False,
                                           forward=oi.forward, len1=oi.len2)
                for oid, oi in orig.items()
            }
            next_id += 1
    combined.readcount_single = next_id
    return combined, subdict


def run_savage(
    store: ReadStore,
    config: SavageConfig = SavageConfig(),
) -> SavageResult:
    cfg = config
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
            from ..utils.checkpoint import save_state

            save_state(ckpt_dir(name), cstore, sub)
            with open(os.path.join(ckpt_dir(name), "fingerprint.txt"), "w") as f:
                f.write(fingerprint + "\n")

    def ckpt_load(name: str):
        from ..utils.checkpoint import load_state

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
        ref_index = None
        if cfg.reference:
            from ..ops.align import ReferenceIndex

            ref_index = ReferenceIndex.from_fasta(cfg.reference)
        # multi-process: patches round-robined over ranks; contig sets
        # allgathered so stage b/c run replicated (reference: sequential
        # per-patch stage a, savage.py:373-396). The ranks assemble
        # different patches, so each scores on its own card alone
        # (mesh.rank_local); stage b/c, the same calls on every rank, go
        # through the mesh that spans the ranks. The reference's patch
        # loop has no such scope: over its global mesh it would block
        from ..parallel import mesh
        from ..parallel.distributed import (
            allgather_stage_results, gather_stats, maybe_initialize, my_work_items,
            process_count)

        maybe_initialize()
        mine = my_work_items(len(patches))
        local_results: List[StageResult] = []
        cand_s = 0.0
        t_a = time.time()
        with mesh.rank_local():
            for pidx in mine:
                t_patch = time.time()
                pstore, _ = patches[pidx]
                if ref_index is not None:
                    overlaps = ref_guided_candidates(pstore, ref_index, min_overlap_len)
                else:
                    overlaps = denovo_candidates(pstore, min_overlap_len, cfg.sfo_mm, cfg.kmer_k)
                t_cand = time.time() - t_patch
                cand_s += t_cand
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
        # this process's patches, then the wait for and decoding of the
        # other processes' (0 in one process)
        result.timings["stage_a_candidates_s"] = round(cand_s, 2)
        result.timings["stage_a_s"] = round(time.time() - t_a, 2)
        for r in local_results:
            for name, sec in r.phase_times.items():
                result.stage_a_phase_times[name] = (
                    result.stage_a_phase_times.get(name, 0.0) + sec)
        t0 = time.time()
        before = gather_stats()
        patch_results = allgather_stage_results(local_results, mine, len(patches))
        result.timings["stage_a_gather_s"] = round(time.time() - t0, 2)
        if process_count() > 1:
            # its split: inside all_gather_object (the wait for the slowest
            # rank and the exchange), and the JSON encode and decode
            after = gather_stats()
            for key in ("wait_s", "codec_s"):
                result.timings[f"stage_a_gather_{key}"] = round(after[key] - before[key], 2)

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
            res_b = _freq_filter(res_b, store, avg_len, cfg.backend,
                                  result.timings)
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
            res_c = _freq_filter(res_c, store, avg_len, cfg.backend,
                                  result.timings)
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
                 backend: str, timings: Optional[Dict[str, float]] = None) -> StageResult:
    """Abundance-based contig filtering (savage.py freq_filtering:719-777,
    min_TPM=0): pseudo-align the original input reads against the stage's
    contig panel and drop contigs whose estimated TPM is not > 0. No-op
    when every contig has positive abundance. The reads' classification
    is dealt over the processes (_classify_dealt), which add their counts
    to `timings`."""
    from dataclasses import replace

    from ..ops.abundance import PseudoIndex, abundance_from_classes

    n = len(res.store)
    if n == 0:
        return res
    ids = [int(res.store.ids[i]) for i in range(n)]
    seqs = [res.store.unit_codes(res.store.unit1[i]) for i in range(n)]
    index = PseudoIndex([str(i) for i in ids], seqs)
    classes = _classify_dealt(index, read_store, {} if timings is None else timings)
    ab = abundance_from_classes(index, classes, read_store.n_units,
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


def _classify_dealt(index, read_store: ReadStore, timings: Dict[str, float]):
    """The equivalence classes (PseudoIndex.classify_all) of every sequence
    unit of `read_store`, in ops/abundance.py:store_unit_seqs's order. Stages
    b and c run replicated with the whole read set on every process, so of
    P processes rank i classifies units [n*i // P, n*(i+1) // P) and the
    ranks merge their classes in rank order: the classes, counts, members
    and order of one pass. One process makes that one pass. Adds to
    `timings` the units classified here (filter_reads_classified), the
    sample's units (filter_reads) and the seconds inside the gather of the
    classes (filter_gather_wait_s)."""
    from ..ops.abundance import merge_classes
    from ..parallel.distributed import (
        allgather_classes, process_count, process_index)

    n, ranks, rank = read_store.n_units, process_count(), process_index()
    lo, hi = n * rank // ranks, n * (rank + 1) // ranks
    classes = index.classify_all([read_store.unit_codes(u) for u in range(lo, hi)])
    timings["filter_reads"] = timings.get("filter_reads", 0) + n
    timings["filter_reads_classified"] = timings.get("filter_reads_classified", 0) + hi - lo
    if ranks > 1:
        t0 = time.perf_counter()
        parts = allgather_classes(*classes)
        timings["filter_gather_wait_s"] = (timings.get("filter_gather_wait_s", 0.0)
                                           + time.perf_counter() - t0)
        classes = merge_classes(parts)
    return classes


def _original_readcount(subreads: SubreadDict) -> int:
    mx = 0
    for originals in subreads.values():
        for oid in originals:
            mx = max(mx, int(oid))
    return mx + 1


def _freqs(store: ReadStore, subreads: SubreadDict, min_len: int) -> FreqResult:
    lengths = {int(store.ids[i]): store.read_len(i) for i in range(len(store))}
    return estimate_frequencies(lengths, subreads or {}, min_len=min_len)
