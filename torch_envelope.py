#!/usr/bin/env python3
"""SAVAGE at its documented operating point, on haploconduct_torch.

    python3 torch_envelope.py [--backend torch,native] [--genome-len 10000]
                              [--total-cov 10000] [--split 15] [--profile]

The port's counterpart of tools/envelope_run.py:savage_envelope: a 10 kb
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
launches, the tasks per backend, the f64-rechecked tasks and the peak
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
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import io
import json
import pstats
import subprocess
import sys
import time

import numpy as np

ENVELOPE_METRIC = "savage 10000x-coverage patched end-to-end"


def savage_envelope_store(genome_len=10000, total_cov=10000, split_num=15,
                          read_len=150, n_haps=4, divergence=0.03):
    """The envelope's reads and strains: (ReadStore, haplotype strings),
    drawn as tools/envelope_run.py:savage_envelope draws them (seed 0)."""
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.utils.simulate import (mutate_sequence,
                                                   random_genome,
                                                   simulate_reads)

    rng = np.random.default_rng(0)
    genome = random_genome(rng, genome_len)
    haps = [genome] + [mutate_sequence(genome, rng, sub_rate=divergence)
                       for _ in range(n_haps - 1)]
    seqs, quals = simulate_reads(haps, coverage=total_cov / n_haps,
                                 read_len=read_len, rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
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

    from haploconduct_torch.ops import kernels
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="torch,native",
                    help="comma-separated backends, run in this order")
    ap.add_argument("--genome-len", type=int, default=10000)
    ap.add_argument("--total-cov", type=float, default=10000)
    ap.add_argument("--split", type=int, default=15)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    backends = args.backend.split(",")
    for b in backends:
        if b not in ("torch", "native", "numpy"):
            ap.error(f"unknown backend {b!r}")

    from haploconduct_torch.parallel import distributed

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
