#!/usr/bin/env python3
"""SAVAGE, POLYTE and polyte-split at their documented operating points,
on haploconduct_torch.

    python3 torch_envelope.py [--workflow savage|polyte|polyte-split]
                              [--backend torch,native] [--genome-len N]
                              [--total-cov 10000] [--split 15]
                              [--pool-size 1] [--profile]

--workflow savage (the default) is the port's counterpart of
tools/envelope_run.py:savage_envelope: a 10 kb
random genome, 4 strains (the master and 3 at 3% substitutions), 150 bp
single-end reads at 0.2% error, 10,000x in all (666,664 reads), split
into 15 patches of 667x: the 500-1000x a patch that the SAVAGE
documentation asks for. `savage_envelope_store` draws the reads with the
port's copy of the repo's simulator (haploconduct_torch/utils/simulate.py)
in the tool's order, so both packages assemble the same reads.

Each backend named by --backend (in that order) runs
run_savage(store, SavageConfig(split_num, backend, min_clique_size=4,
progress=True)) and prints one JSON line: the wall, run_savage's timings
and each stage's phase seconds, the stage a/b/c contig counts and a
sha256 of each stage's contigs in order (so runs in different processes
or on different machines can be compared), the quality columns of
workflows/evaluate.py against the 4 strains (SNP recovery at stage c),
stage c rerun at merge_contigs=0.01, and for torch the scoring kernel's
launches, the tasks per backend, the f64-rechecked tasks, the packed
matrix's transfers (ops/device_cache.py:TRANSFER_STATS) and the peak
CUDA memory; with the card's name and power limit as nvidia-smi gives
them. The torch backend runs on the card, on the CPU only under
HC_TORCH_DEVICE=cpu (parallel/devices.py).

Under torchrun (python -m torch.distributed.run --nproc_per_node N
torch_envelope.py --backend torch) the patches are round-robined over the
ranks, each on its own card, and stages b and c run on every rank; every
rank prints its own line, with its rank.

--profile runs cProfile over patch 0's stage a (its candidates included)
and over each of the two abundance filters, in a run that assembles
patch 0 alone (stages b and c over its contigs, the filters over every
read), and prints the top 30 functions of each by cumulative time
instead of the JSON lines.

--workflow polyte is POLYTE diploid, the counterpart of
tools/br_scale_bench.py and tools/profile_polyte.py: a 50 kb random genome
(--genome-len) and a second haplotype at 1% substitutions, 20x a
haplotype of 150 bp reads at 0.2% error (13,332 reads), run_polyte with
the tools' POLYTE_CONFIG. --workflow polyte-split is the counterpart of
tools/envelope_run.py:polyte_envelope: a 120 kb genome (--genome-len
500000 gives the record's linearity row) and a haplotype at 0.5%, 15x a
haplotype of error-free 250 bp reads, aligned to the genome and binned
into 10 kb regions with 1 kb halos (polyte_split_config), with
--pool-size region threads sharing the process's card. Under torchrun
the regions are round-robined over the ranks, each on its own card, and
gathered over NCCL; every rank prints its own line.

For these two, every backend runs with each candidate engine of
ENGINES, engine by engine and the backends in turns: "host", the tools'
k-mer engine, and for polyte also "auto", which puts the exact
re-overlap passes on the card's join (workflows/polyte.py). Each run
prints one JSON line: the
wall, iterations, for polyte-split the regions, the final pass's
reference candidates and the failed regions; contig counts, longest and
total bp; the quality columns against the two haplotypes (per_haplotype:
each contig on its best haplotype; union: every contig on the first
haplotype, whose coordinates the second shares, so its genome fraction
is the share of positions some contig covers); a sha256 of the contigs in
order, and whether they equal the first engine's; the scoring kernel's
launches, the tasks per backend, the f64-rechecked tasks and the packed
matrix's transfers, the join's calls and seconds per device, the peak CUDA memory, the seconds of the
run's pieces (Breakdown) and the card. With --pool-size above 1 the
regions' pieces are summed over the threads; every count is exact. --profile also prints, before each line, cProfile's top 30
functions of the run (its calling thread) by cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ENVELOPE_METRIC = "savage 10000x-coverage patched end-to-end"


def single_end_store(seqs, quals):
    """The tools' make_store: reads 0..N-1 added in order as single ends."""
    from haploconduct_torch.core.reads import ReadStore

    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return store


def savage_envelope_store(genome_len=10000, total_cov=10000, split_num=15,
                          read_len=150, n_haps=4, divergence=0.03):
    """The envelope's reads and strains: (ReadStore, haplotype strings),
    drawn as tools/envelope_run.py:savage_envelope draws them (seed 0)."""
    from haploconduct_torch.utils.simulate import (mutate_sequence,
                                                   random_genome,
                                                   simulate_reads)

    rng = np.random.default_rng(0)
    genome = random_genome(rng, genome_len)
    haps = [genome] + [mutate_sequence(genome, rng, sub_rate=divergence)
                       for _ in range(n_haps - 1)]
    seqs, quals = simulate_reads(haps, coverage=total_cov / n_haps,
                                 read_len=read_len, rng=rng, error_rate=0.002)
    store = single_end_store(seqs, quals)
    cov_per_patch = total_cov / split_num
    assert 500 < cov_per_patch < 1000, cov_per_patch
    return store, haps


def quality_metrics(contigs, haplotypes, snps=False):
    """The tool's QUAST-style columns (workflows/evaluate.py)."""
    from haploconduct_torch.workflows.evaluate import (
        evaluate_assembly, polymorphic_position_accuracy)

    m = evaluate_assembly(contigs, haplotypes)
    out = {
        "n_contigs": m.n_contigs,
        "total_bp": m.total_length,
        "largest": m.largest,
        "n50": m.n50,
        "nga50": m.nga50,
        "genome_fraction": round(m.genome_fraction, 4),
        "mismatch_rate": round(m.mismatch_rate, 6),
        "duplication_ratio": round(m.duplication_ratio, 3),
        "misassemblies": m.misassemblies,
        "unaligned_contigs": m.unaligned_contigs,
    }
    if snps:
        out["snps_recovered"], out["snps_total"] = polymorphic_position_accuracy(
            contigs, haplotypes)
    return out


def contig_digest(seqs) -> str:
    """sha256 of a stage's contig strings in order, each ended by a newline."""
    h = hashlib.sha256()
    for s in seqs:
        h.update(s.encode())
        h.update(b"\n")
    return h.hexdigest()


def card_line():
    """nvidia-smi's name and power limit of the cards, or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def mc001_rerun(res, haps, backend):
    """Stage c again from the stage-b contigs at merge_contigs=0.01, the
    reference's master-strain knob (tools/envelope_run.py:141-173)."""
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.core.reads import decode_seq
    from haploconduct_torch.workflows.savage import (_original_readcount,
                                                     contig_candidates)

    mc = 0.01
    t0 = time.time()
    ov_c = contig_candidates(res.stage_b.store, 100, 1 + (0.99 - mc) / (mc + 0.01))
    params = StageParams(
        stage="c", min_overlap_len=100, edge_threshold=0.995,
        merge_contigs=mc, remove_branches=True, min_read_len=100,
        max_tip_len=150, first_it=False,
        original_readcount=_original_readcount(res.stage_b.subreads),
        backend=backend)
    res_mc = run_stage(params, res.stage_b.store, ov_c, res.stage_b.subreads)
    contigs = [decode_seq(res_mc.store.unit_codes(res_mc.store.unit1[i]))
               for i in range(len(res_mc.store))]
    return dict(wall_s=time.time() - t0,
                **(quality_metrics(contigs, haps, snps=True) if contigs else {}))


def run_envelope(store, haps, backend, split_num, total_cov):
    """One run_savage over the envelope and its JSON record."""
    import torch

    from haploconduct_torch.ops import device_cache, kernels
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.parallel import distributed
    from haploconduct_torch.parallel.devices import on_card as torch_on_card
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    distributed.maybe_initialize()
    on_card = backend == "torch" and torch_on_card()
    out = {"metric": ENVELOPE_METRIC, "backend": backend,
           "rank": distributed.process_index(),
           "world_size": distributed.process_count(),
           "n_reads": len(store), "total_coverage": total_cov,
           "split_num": split_num, "coverage_per_patch": total_cov / split_num}
    if on_card:
        t0 = time.time()
        kernels.build_all()
        out["build_s"] = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
    for key in BACKEND_COUNTS:
        BACKEND_COUNTS[key] = 0
    kernels.score_tasks_cuda.launches = 0
    device_cache.reset_stats()

    t0 = time.time()
    res = run_savage(store, SavageConfig(split_num=split_num, backend=backend,
                                         min_clique_size=4, progress=True))
    out["wall_s"] = time.time() - t0
    out["timings"] = res.timings
    out["stage_a_phases"] = dict(sorted(res.stage_a_phase_times.items(),
                                        key=lambda kv: -kv[1]))
    for stage in ("b", "c"):
        sres = getattr(res, f"stage_{stage}")
        if sres is not None:
            out[f"stage_{stage}_phases"] = dict(sorted(
                sres.phase_times.items(), key=lambda kv: -kv[1]))
    if backend == "torch":
        out["torch"] = {
            "score_tasks_launches": kernels.score_tasks_cuda.launches,
            "backend_counts": dict(BACKEND_COUNTS),
            "transfers": dict(device_cache.TRANSFER_STATS),
            "peak_cuda_mib": (torch.cuda.max_memory_allocated() / 2**20
                              if on_card else None)}
    contigs = {}
    for stage in ("a", "b", "c"):
        if stage != "a" and getattr(res, f"stage_{stage}") is None:
            continue
        contigs[stage] = res.contigs(stage)[1]
        out[f"stage_{stage}_contigs"] = len(contigs[stage])
    out["longest_contig"] = max((len(c) for c in contigs.get("c", [])), default=0)
    out["digests"] = {s: contig_digest(c) for s, c in contigs.items()}
    t0 = time.time()
    for stage, seqs in contigs.items():
        if seqs:
            out[f"stage_{stage}_quality"] = quality_metrics(seqs, haps,
                                                            snps=stage == "c")
    out["quality_s"] = time.time() - t0
    if res.stage_b is not None and len(res.stage_b.store):
        out["stage_c_mc001"] = mc001_rerun(res, haps, backend)
    out["card"] = card_line()
    return out


def _top(prof, n=30) -> str:
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(n)
    return buf.getvalue()


def profile_envelope(store, split_num, backend):
    """cProfile of patch 0's stage a (with its candidates) and of the two
    abundance filters: run_savage over patch 0 alone, the filters over
    every read of `store`."""
    from haploconduct_torch.workflows import savage

    profs = {}
    split, denovo, run_stage, freq_filter = (
        savage.split_into_patches, savage.denovo_candidates, savage.run_stage,
        savage._freq_filter)

    def profiled(name, fn):
        def call(*args, **kwargs):
            prof = profs.setdefault(name, cProfile.Profile())
            prof.enable()
            try:
                return fn(*args, **kwargs)
            finally:
                prof.disable()
        return call

    filters = iter(("stage_b_filter", "stage_c_filter"))

    def run_stage_a_profiled(params, *args, **kwargs):
        if params.stage == "a":
            return profiled("patch0_stage_a", run_stage)(params, *args, **kwargs)
        return run_stage(params, *args, **kwargs)

    savage.split_into_patches = lambda *a, **k: split(*a, **k)[:1]
    savage.denovo_candidates = profiled("patch0_stage_a", denovo)
    savage.run_stage = run_stage_a_profiled
    savage._freq_filter = lambda *a, **k: profiled(next(filters), freq_filter)(*a, **k)
    try:
        t0 = time.time()
        res = savage.run_savage(store, savage.SavageConfig(
            split_num=split_num, backend=backend, min_clique_size=4, progress=True))
        wall = time.time() - t0
    finally:
        savage.split_into_patches, savage.denovo_candidates = split, denovo
        savage.run_stage, savage._freq_filter = run_stage, freq_filter
    print(f"[profile] patch 0 of {split_num}, backend {backend}: run_savage "
          f"{wall:.2f}s, timings {res.timings}, stage a phases "
          f"{res.stage_a_phase_times}", flush=True)
    for name, prof in profs.items():
        print(f"[profile] {name}: top 30 by cumulative time\n{_top(prof)}", flush=True)
    return profs


POLYTE_METRIC = "polyte {kb}kb diploid end-to-end"
SPLIT_METRIC = "polyte-split >100kb genome end-to-end"
# tools/br_scale_bench.py:57-59's run_polyte configuration, but for the
# backend and the candidate engine
POLYTE_CONFIG = dict(hap_cov=20, insert_size=150, stddev=15, min_overlap_len=60,
                     min_overlap_len_EC=77, diploid=True)


def polyte_diploid_store(genome_len=50_000):
    """POLYTE diploid's reads and haplotypes: (ReadStore, [hap1, hap2]),
    drawn as tools/br_scale_bench.py:32-41 draws them (seed 0)."""
    from haploconduct_torch.utils.simulate import (mutate_sequence,
                                                   random_genome,
                                                   simulate_reads)

    rng = np.random.default_rng(0)
    hap1 = random_genome(rng, genome_len)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    seqs, quals = simulate_reads([hap1, hap2], coverage=20, read_len=150,
                                 rng=rng, error_rate=0.002)
    return single_end_store(seqs, quals), [hap1, hap2]


def polyte_envelope_store(genome_len=120_000, hap_cov=15, read_len=250):
    """polyte-split's reads and haplotypes: (ReadStore, [genome, hap2]),
    drawn as tools/envelope_run.py:polyte_envelope draws them (seed 1);
    the genome is the reference the reads are binned against."""
    from haploconduct_torch.utils.simulate import (mutate_sequence,
                                                   random_genome,
                                                   simulate_reads)

    rng = np.random.default_rng(1)
    genome = random_genome(rng, genome_len)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    seqs, quals = simulate_reads([genome, hap2], coverage=hap_cov,
                                 read_len=read_len, rng=rng, error_rate=0.0)
    return single_end_store(seqs, quals), [genome, hap2]


def polyte_split_config(reference, hap_cov=15, read_len=250, **kw):
    """tools/envelope_run.py:216-222's PolyteSplitConfig; `kw` sets the
    backend, the candidate engine, pool_size."""
    from haploconduct_torch.workflows.polyte_split import PolyteSplitConfig

    return PolyteSplitConfig(
        hap_cov=hap_cov, insert_size=read_len, stddev=25, reference=reference,
        split_size=10000, split_overlap=1000, min_overlap_len=100,
        min_overlap_len_EC=2 + read_len // 2, **kw)


def polyte_quality(contigs, haps):
    """The quality columns against each contig's best haplotype, and
    against the first haplotype alone, whose coordinates the second shares
    (substitutions only): there the genome fraction is the union's."""
    return {"per_haplotype": quality_metrics(contigs, haps),
            "union": quality_metrics(contigs, haps[:1])}


class Breakdown:
    """Seconds of the named pieces of a POLYTE or polyte-split run, taken
    by wrappers around the package's functions for the length of a `with`
    block; the package's result classes stay as they are.

    `top`, polyte-split's steps in their order (host clock): concat_reads,
    reference_index, alignment (ops/align.py:align_store), detect_regions,
    split_windows, binning (the windows' end to the first region's start),
    regions (the first region's start to the last one's end: a wall, also
    over threads), gather (allgather_indexed, under ranks), merge (to the
    final pass's candidates), final_ref_candidates and final_pass. For
    each scope of run_polyte ("regions", "final", "polyte"), summed over
    its calls and threads: the calls' total, first_pass_candidates,
    iterations (run_iteration) with their phases, branch_reduction_run
    (BranchReduction.run, inside a phase), reoverlap_candidates (after an
    iteration) and diploid_candidates."""

    def __init__(self):
        self.top: dict = {}
        self.scopes: dict = {}
        self._marks: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._saved: list = []

    def _add(self, table, key, dt):
        with self._lock:
            table[key] = table.get(key, 0.0) + dt

    def _mark(self, name, t):
        with self._lock:
            self._marks.setdefault(name, []).append(t)

    def _scope(self, key, dt):
        with self._lock:
            table = self.scopes.setdefault(getattr(self._local, "scope", "polyte"), {})
        self._add(table, key, dt)

    def _patch(self, owner, attr, make):
        self._saved.append((owner, attr, vars(owner)[attr]))
        setattr(owner, attr, make(getattr(owner, attr)))

    def _timed(self, name, fn, mark=None):
        """fn timed into `top` (skipped inside the final pass's candidates,
        which align the contigs), with its end marked."""
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                if not getattr(self._local, "in_ref_candidates", False):
                    self._add(self.top, name, t1 - t0)
                    self._mark(mark or name, t1)
        return call

    def __enter__(self):
        from haploconduct_torch.assemble import branch_reduction
        from haploconduct_torch.ops import align
        from haploconduct_torch.parallel import distributed
        from haploconduct_torch.workflows import polyte, polyte_split, savage

        local = self._local

        def run_polyte(fn):
            def call(store, cfg, preprocessing=True, original_store=None,
                     initial_overlaps=None):
                scope = ("final" if initial_overlaps is not None else
                         "regions" if original_store is not None else "polyte")
                local.scope, local.first = scope, initial_overlaps is None
                t0 = time.perf_counter()
                if scope == "regions":
                    self._mark("region_start", t0)
                try:
                    return fn(store, cfg, preprocessing, original_store,
                              initial_overlaps)
                finally:
                    t1 = time.perf_counter()
                    self._scope("total", t1 - t0)
                    self._scope("calls", 1)
                    if scope == "regions":
                        self._mark("region_end", t1)
                    elif scope == "final":
                        self._add(self.top, "final_pass", t1 - t0)
            return call

        def candidates(fn):
            def call(*args, **kwargs):
                if getattr(local, "in_loop", False):
                    piece = "reoverlap_candidates"
                elif getattr(local, "first", False):
                    piece, local.first = "first_pass_candidates", False
                else:
                    piece = "diploid_candidates"
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._scope(piece, time.perf_counter() - t0)
            return call

        def loop_run(fn):
            def call(*args, **kwargs):
                local.in_loop = True
                try:
                    return fn(*args, **kwargs)
                finally:
                    local.in_loop = False
            return call

        def iteration(fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                self._scope("iterations", time.perf_counter() - t0)
                for phase, s in res.stats.get("phase_times", {}).items():
                    self._scope(f"phase.{phase}", s)
                return res
            return call

        def scoped(name):
            def make(fn):
                def call(*args, **kwargs):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        self._scope(name, time.perf_counter() - t0)
                return call
            return make

        def ref_candidates(fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                self._mark("final_candidates_start", t0)
                local.in_ref_candidates = True
                try:
                    return fn(*args, **kwargs)
                finally:
                    local.in_ref_candidates = False
                    self._add(self.top, "final_ref_candidates", time.perf_counter() - t0)
            return call

        self._patch(polyte, "run_polyte", run_polyte)
        self._patch(polyte_split, "run_polyte", run_polyte)
        self._patch(polyte, "single_end_candidates", candidates)
        self._patch(polyte._AssemblyLoop, "run", loop_run)
        self._patch(polyte, "run_iteration", iteration)
        self._patch(polyte, "concat_to_single_end", scoped("concat_reads"))
        self._patch(branch_reduction.BranchReduction, "run",
                    scoped("branch_reduction_run"))
        self._patch(polyte_split, "concat_to_single_end",
                    lambda fn: self._timed("concat_reads", fn))
        self._patch(align.ReferenceIndex, "from_fasta",
                    lambda fn: self._timed("reference_index", fn))
        self._patch(align, "align_store", lambda fn: self._timed("alignment", fn))
        self._patch(polyte_split, "detect_regions",
                    lambda fn: self._timed("detect_regions", fn))
        self._patch(polyte_split, "split_windows",
                    lambda fn: self._timed("split_windows", fn))
        self._patch(distributed, "allgather_indexed",
                    lambda fn: self._timed("gather", fn))
        self._patch(savage, "ref_guided_candidates", ref_candidates)
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
        return False

    def record(self, wall):
        """The pieces as a JSON record: polyte-split's `top` steps with the
        gaps between the wrapped ones (binning, merge), their share of
        `wall`, and each run_polyte scope's pieces and phases."""
        top, marks = dict(self.top), self._marks
        if "region_start" in marks:
            top["regions"] = max(marks["region_end"]) - min(marks["region_start"])
        if "split_windows" in marks:
            after = [min(marks[k]) for k in ("region_start", "gather",
                                               "final_candidates_start") if k in marks]
            if after:
                top["binning"] = min(after) - max(marks["split_windows"])
        if "final_candidates_start" in marks:
            before = [max(marks[k]) for k in ("region_end", "gather") if k in marks]
            if before:
                top["merge"] = min(marks["final_candidates_start"]) - max(before)
        out = {}
        if top:
            out["top"] = top
            out["named_share"] = sum(top.values()) / wall
        for scope, table in self.scopes.items():
            rec = {k: v for k, v in table.items() if not k.startswith("phase.")}
            rec["calls"] = int(rec.get("calls", 0))
            rec["phases"] = dict(sorted(
                ((k[6:], v) for k, v in table.items() if k.startswith("phase.")),
                key=lambda kv: -kv[1]))
            out[scope] = rec
        if "polyte" in out:
            p = out["polyte"]
            out["named_share"] = sum(p.get(k, 0.0) for k in (
                "concat_reads", "first_pass_candidates", "iterations",
                "reoverlap_candidates", "diploid_candidates")) / wall
        return out


def _reset_counts():
    from haploconduct_torch.ops import device_cache, kernels
    from haploconduct_torch.ops.kmer_device import JOIN_CALLS, JOIN_SECONDS
    from haploconduct_torch.ops.verify import BACKEND_COUNTS

    for key in BACKEND_COUNTS:
        BACKEND_COUNTS[key] = 0
    kernels.score_tasks_cuda.launches = 0
    device_cache.reset_stats()
    JOIN_CALLS.clear()
    JOIN_SECONDS.clear()


def _device_record(on_card):
    """The scoring kernel's launches, the tasks per backend, the packed
    matrix's transfers, the join's calls and seconds, the peak CUDA
    memory."""
    import torch

    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.device_cache import TRANSFER_STATS
    from haploconduct_torch.ops.kmer_device import JOIN_CALLS, JOIN_SECONDS
    from haploconduct_torch.ops.verify import BACKEND_COUNTS

    return {
        "score_tasks_launches": kernels.score_tasks_cuda.launches,
        "backend_counts": dict(BACKEND_COUNTS),
        "transfers": dict(TRANSFER_STATS),
        "join_calls": dict(JOIN_CALLS),
        "join_seconds": dict(JOIN_SECONDS),
        "peak_cuda_mib": (torch.cuda.max_memory_allocated() / 2**20
                          if on_card else None)}


def _contig_strings(store):
    return [] if store is None else [store.seq_str(i) for i in range(len(store))]


def _size_record(seqs, prefix=""):
    lens = [len(s) for s in seqs]
    return {f"{prefix}contigs": len(seqs),
            f"{prefix}longest_contig": max(lens, default=0),
            f"{prefix}sum_bp": int(sum(lens))}


def run_polyte_workflow(workflow, store, haps, backend, candidates, reference=None,
                        pool_size=1, profile=False):
    """One POLYTE diploid or polyte-split run and its JSON record."""
    import torch

    from haploconduct_torch.ops import kernels
    from haploconduct_torch.parallel import distributed
    from haploconduct_torch.parallel.devices import on_card as torch_on_card
    from haploconduct_torch.workflows import polyte
    from haploconduct_torch.workflows.polyte_split import run_polyte_split

    distributed.maybe_initialize()
    on_card = torch_on_card()
    genome_len = len(haps[0])
    metric = (SPLIT_METRIC if workflow == "polyte-split"
              else POLYTE_METRIC.format(kb=genome_len // 1000))
    out = {"metric": metric, "workflow": workflow, "backend": backend,
           "candidates": candidates, "rank": distributed.process_index(),
           "world_size": distributed.process_count(), "genome_len": genome_len,
           "n_reads": len(store)}
    if workflow == "polyte-split":
        out["pool_size"] = pool_size
    if on_card:
        t0 = time.time()
        kernels.build_all()
        out["build_s"] = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    prof = cProfile.Profile() if profile else None
    with Breakdown() as pieces:
        t0 = time.time()
        if prof:
            prof.enable()
        try:
            if workflow == "polyte-split":
                res = run_polyte_split(store, polyte_split_config(
                    reference, backend=backend, candidates=candidates,
                    pool_size=pool_size))
            else:
                # through the module: Breakdown wraps polyte.run_polyte
                res = polyte.run_polyte(store, polyte.PolyteConfig(
                    backend=backend, candidates=candidates, **POLYTE_CONFIG))
        finally:
            if prof:
                prof.disable()
        out["wall_s"] = time.time() - t0
    out["breakdown"] = pieces.record(out["wall_s"])
    out["device"] = _device_record(on_card)
    if workflow == "polyte-split":
        final = _contig_strings(res.final.store if res.final else None)
        out.update({
            "n_regions": len(res.regions),
            "iterations": {"final": res.final.iterations if res.final else 0,
                           "regions": sum(r.iterations for r in res.region_results)},
            "final_ref_candidates": res.final_ref_candidates,
            "failed_regions": [[list(r), e] for r, e in res.failed_regions]})
        sizes = _size_record(final)
        out.update(final_contigs=sizes["contigs"],
                   longest_contig=sizes["longest_contig"],
                   sum_final_bp=sizes["sum_bp"])
        out["digest"] = contig_digest(final)
        t0 = time.time()
        out["quality"] = polyte_quality(final, haps) if final else None
    else:
        contigs = _contig_strings(res.store)
        diploid = _contig_strings(res.diploid_store)
        out["iterations"] = res.iterations
        out.update(_size_record(contigs))
        out.update(_size_record(diploid, "diploid_"))
        out["digest"] = contig_digest(contigs)
        out["diploid_digest"] = contig_digest(diploid)
        t0 = time.time()
        out["quality"] = polyte_quality(contigs, haps) if contigs else None
        out["diploid_quality"] = polyte_quality(diploid, haps) if diploid else None
    out["quality_s"] = time.time() - t0
    out["card"] = card_line()
    if prof:
        print(f"[profile] {workflow}, backend {backend}, candidates {candidates}: "
              f"top 30 by cumulative time\n{_top(prof)}", flush=True)
    return out


DEFAULT_GENOME = {"savage": 10000, "polyte": 50_000, "polyte-split": 120_000}
# the candidate engines each POLYTE workflow runs, the tools' first
ENGINES = {"polyte": ("host", "auto"), "polyte-split": ("host",)}


def polyte_main(args, backends) -> int:
    """--workflow polyte or polyte-split: every candidate engine, every
    backend in turns, one JSON line a run."""
    engines = ENGINES[args.workflow]
    t0 = time.time()
    if args.workflow == "polyte":
        store, haps = polyte_diploid_store(args.genome_len)
        what = "2 haplotypes at 1%, 20x each"
    else:
        store, haps = polyte_envelope_store(args.genome_len)
        what = "2 haplotypes at 0.5%, 15x each"
    print(f"[{args.workflow}] {len(store)} reads over {args.genome_len / 1000:g} kb "
          f"({what}), built in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    digests = {}
    with tempfile.TemporaryDirectory() as workdir:
        reference = os.path.join(workdir, "ref.fasta")
        with open(reference, "w") as f:
            f.write(f">chr\n{haps[0]}\n")
        for engine in engines:
            for b in backends:
                line = run_polyte_workflow(args.workflow, store, haps, b, engine,
                                           reference, args.pool_size, args.profile)
                digests[b, engine] = line["digest"]
                if engine != engines[0]:
                    line[f"identical_to_{engines[0]}"] = (
                        line["digest"] == digests[b, engines[0]])
                print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workflow", default="savage", choices=sorted(DEFAULT_GENOME))
    ap.add_argument("--backend", default="torch,native",
                    help="comma-separated backends, run in this order")
    ap.add_argument("--genome-len", type=int, default=None,
                    help="default: 10,000 (savage), 50,000 (polyte), "
                         "120,000 (polyte-split)")
    ap.add_argument("--total-cov", type=float, default=10000)
    ap.add_argument("--split", type=int, default=15)
    ap.add_argument("--pool-size", type=int, default=1,
                    help="polyte-split: region threads (PolyteSplitConfig.pool_size)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    backends = args.backend.split(",")
    for b in backends:
        if b not in ("torch", "native", "numpy"):
            ap.error(f"unknown backend {b!r}")
    if args.genome_len is None:
        args.genome_len = DEFAULT_GENOME[args.workflow]
    if args.workflow != "polyte-split" and args.pool_size != 1:
        ap.error("--pool-size is for --workflow polyte-split")

    from haploconduct_torch.parallel import distributed

    if args.workflow != "savage":
        try:
            return polyte_main(args, backends)
        finally:
            distributed.shutdown()
    t0 = time.time()
    store, haps = savage_envelope_store(args.genome_len, args.total_cov, args.split)
    print(f"[envelope] {len(store)} reads = {args.total_cov:g}x over "
          f"{args.genome_len / 1000:g} kb (4 strains), {args.split} patches @ "
          f"{args.total_cov / args.split:.0f}x, built in {time.time() - t0:.1f}s",
          file=sys.stderr, flush=True)
    try:
        if args.profile:
            for b in backends:
                profile_envelope(store, args.split, b)
            return 0
        for b in backends:
            print(json.dumps(run_envelope(store, haps, b, args.split,
                                          args.total_cov)), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
