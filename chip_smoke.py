#!/usr/bin/env python3
"""Smoke run of haploconduct_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernel from csrc/;
  2. the scoring kernel (score_tasks_cuda) against its plain PyTorch
     version (score_tasks_plain) on the card, on the same tasks at the
     shapes of phase_kernel (SAVAGE iteration 1 of one envelope patch,
     kb-wide contigs, more than 2^16 rows, a 9 kb wide matrix, an EC
     iteration of a polyte-split region, POLYTE diploid's first and a
     late iteration, a 500 kb polyte-split region's first iteration and
     its final pass, and torch_bench.py's example shape, which phase 13
     loops over) and thresholds 0 and far_threshold(): integer
     columns equal, sum_log within rtol 1e-4 / atol 1e-3; each shape's
     kernel, plain and bound times;
  3. stage a on a 160-read store (150 bp reads of a 2 kb genome, k=16
     candidates) with the torch backend against the f64 numpy oracle
     backend: byte-identical contigs;
  4. SAVAGE stages a -> b -> c on one envelope patch (10 kb genome, 4
     strains at 3% divergence, 150 bp reads at 0.2% error, 667x coverage,
     about 44k reads) with the torch backend, which must go through the
     kernel on card 0 (mesh.default_mesh pinned to it, whatever the card
     count: savage_patch_run), against the native host engine:
     byte-identical contigs; every matrix the cache of the packed read
     matrix (ops/device_cache.py) hands a scoring call torch.equal to a
     fresh upload (checked_cache), and its TRANSFER_STATS printed;
  5. the k-mer sort-join on the card: an exact pass (min overlap 100) over
     1,000 contig-like sequences of 300-3,000 bp from two haplotypes of a
     150 kb genome; the same SFO array as the join on the CPU, and the same
     verified overlaps as the host k-mer engine;
  6. POLYTE diploid on the 3 kb, 20x input of the repo's POLYTE test, the
     torch backend (join on the card) against the native engine with the
     host join: byte-identical contigs and diploid contigs;
  7. reference-guided SAVAGE stage a on a 1.5 kb genome, 2 strains at 2%,
     torch against native: byte-identical contigs;
  8. polyte-split at its documented envelope (120 kb genome, one haplotype
     at 0.5%, 15x per haplotype of error-free 250 bp reads = 14,400 reads):
     (a) torch with the join on the card, (b) native with the join on the
     card, (c) native with the host join, each scoring on card 0. (a) and
     (b) byte-identical, (c) equal to the JAX package's pinned result (435
     contigs, 296,804 bp, longest 2,686, 12 regions), (a) through the
     kernel and the join on the card, no task on a host backend, no region
     failed; (a)'s sha256 and quality columns against the two haplotypes
     (torch_envelope.polyte_quality). With two cards or more, the same
     reads also go through the CLI as two ranks (python -m
     torch.distributed.run --nproc_per_node 2 -m haploconduct_torch
     polyte-split), the regions round-robined over the ranks and gathered
     over NCCL: every rank's contigs equal (a)'s; with one card that part
     is logged as not run;
  9. multi-device verification (parallel/mesh.py): (a) phase 2's
     iteration-1 stream scored by sharded_score_tasks over two shards on
     card 0, and over every visible card when there are several, against
     one score_tasks_torch call: all four per-task columns bit-equal, every
     cached matrix equal to a fresh upload; (b) phase 4's SAVAGE run with
     default_mesh() naming card 0 twice and the cache off
     (HC_DEVICE_CACHE=0), so every verify call goes through the mesh and
     uploads its whole matrix: contigs byte-identical to phase 4's (the
     cache on), every task counted under "mesh", more launches than phase 4;
 10. the JAX package's last device paths (parallel/mesh.py): (a) the
     multi-device dry run's steps 2-4 at their own sizes (its tiny
     workload: 64 reads of 96 bp at width 128) over card 0 twice, and over
     every card when there are several: sharded_score_tasks and
     sharded_verify against one call, sharded_assembly_step (k=13, expand
     8, threshold 0.9, min overlap 24) against the same step on the CPU
     (its plain version), and the per-shard count of scores above 0.97;
     (b) the fused k-mer join + verify step at full size, over phase 4's
     envelope patch (88,928 rows of 150; k=13, expand 8, threshold 0.97,
     min overlap 30): one device against two shards on card 0 (and every
     card, when there are several) bit-equal,
     the join_verify kernel against its plain version on every query row
     (zero pattern equal, scores within 1e-5, slot counts equal but for
     slots within 1e-5 of the threshold), then the kernel's and the plain
     version's times and the bound, and the valid slots beside the distinct
     diagonals the kernel scored (a row's tiles) and their lanes.

 11. SAVAGE over several patches (torch_envelope.py, the documented
     operating point at reduced depth): the envelope at its full width
     (10 kb, 4 strains at 3%, 150 bp reads, 667x a patch) cut to 2 patches,
     1,334x in all (savage_envelope_store(total_cov=1334, split_num=2)),
     a -> b -> c with the torch backend on card 0, which must launch the
     scoring kernel, against the native engine: byte-identical contigs in
     every stage. With two cards or more, the same reads also go through the
     CLI as two ranks (python -m torch.distributed.run --nproc_per_node 2
     -m haploconduct_torch savage --split 2), patches round-robined over
     the ranks and gathered over NCCL: every rank's stage a/b/c contigs
     equal the one-process torch run's. With one card that part is
     logged as not run.
 12. POLYTE diploid at the JAX package's recorded operating point
     (tools/br_scale_bench.py: a 50 kb genome and a haplotype at 1%, 20x
     each of 150 bp reads at 0.2% error, 13,332 reads; not cut), the
     torch backend on card 0, which must launch the scoring kernel,
     against the native engine, both with the host candidate engine:
     contigs, diploid contigs and iterations byte-identical, and the
     record's 570 contigs in 37 iterations.
 13. torch_bench.py, the twin of bench.py, with few repeats, on card 0:
     its default mode at the example shape and at the iteration-1 stream
     of phase 2, both held to the plain version there (the kernel's
     repeat loop through ops/kernels.py:launch_score_tasks, the scoring
     call's rate and the live OpenMP baseline), then its --mesh mode over
     every card count the host has at both shapes. Every launch of the
     loop counted in score_tasks_cuda.launches, the loop's f64 checksum
     within 1e-9 relative of repeats x one call's sum and its integer
     totals exact, every sharding bit-equal to one call, every rate
     positive and finite.
 14. torch_cands.py's synthetic10x and polyte_reads_exact, one timed run
     an engine: the join must run on the card, every recall in [0, 1].
 15. two ranks over the mesh that spans them (parallel/mesh.py, the twin
     of the JAX package's global mesh), each a process of its own that
     starts its group itself: NCCL on cards 0 and 1 where there are two,
     else two gloo ranks sharing card 0 (NCCL takes one rank a card).
     (a) phase 2's iteration-1 stream through sharded_score_tasks on the
     default mesh, every call's four columns on every rank bit-equal to
     one score_tasks_torch call on card 0 (thresholds 0 and
     far_threshold()) with one launch a rank a call, then phase 10 (b)'s
     join + verify step, every rank's slot scores bit-equal to one
     device's and the count summed over the ranks, one launch a rank;
     (b) SAVAGE on phase 11's two patches as the two ranks: each rank's
     stage a (its patch) inside mesh.rank_local with no collective and no
     task under "mesh", stages b and c through the mesh, and every rank's
     stage a/b/c contigs equal phase 11's one-process torch run. Each
     rank's launches, counts and walls are printed.

Phases 4, 8, 11 and 12, and phase 13's default mode, score on card 0
alone whatever the number of visible cards (pinned_mesh, or card 0 named),
so their counts hold on a host with several; phases 9, 10, 13's --mesh
and 15 cover several devices (or ranks) on purpose.

Phase 4 also prints the stage c contigs' genome fraction and mismatch rate
against the four strains (workflows/evaluate.py); no check reads them. The
inputs of phases 6-8 come from the port's copy of the repo's simulator
(utils/simulate.py). Before the summary the script checks that no module
of the JAX package and no jax was loaded.
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits 1. The run is
on the card: it sets HC_TORCH_DEVICE=cuda for its own process.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
RTOL, ATOL = 1e-4, 1e-3
# the H100's published peaks (SXM, 700 W): HBM bytes/s and FP32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def far_threshold() -> float:
    """A mismatch threshold in the middle of the widest gap between the
    per-lane probabilities phreds 2-40 can give, so f32 rounding cannot
    move a lane across it."""
    q = np.arange(2, 41, dtype=np.float32)
    p1 = np.exp(q * np.float32(-np.log(10.0) / 10.0))[:, None]
    p2 = p1.T
    pm = (1 - p1) * (1 - p2) + p1 * p2 / 3
    px = (p1 * (1 - p2) + p2 * (1 - p1)) / 3 + (2 / 9) * p1 * p2
    ps = np.unique(np.concatenate([pm.ravel(), px.ravel()]))
    ps = ps[(ps > 0.01) & (ps < 0.9)]
    i = int(np.argmax(np.diff(ps)))
    return float((ps[i] + ps[i + 1]) / 2)


def score_bound(lens, row_a, row_b, pos, L):
    """The least time the card could take for one scoring call on these
    tasks, in ms, and what bounds it. Bytes, at the HBM rate: the words of
    the matrix that some task reads, each once (per row the union of the
    a spans [pos, pos + L) and the b spans [0, L)), the length of each row
    a task names, 12 B of columns and 20 B of results a task. Operations,
    at the FP32 rate: one f32 add for each lane the tasks cover."""
    rows = np.concatenate([row_a, row_b]).astype(np.int64)
    start = np.concatenate([pos, np.zeros_like(pos)]).astype(np.int64)
    end = start + np.concatenate([L, L])
    keep = end > start
    rows, start, end = rows[keep], start[keep], end[keep]
    w = int(lens.max()) + 1  # every span ends within its row
    order = np.argsort(rows * w + start, kind="stable")
    rows, start, end = rows[order], start[order], end[order]
    # the furthest end that an earlier span of the same row reached
    reach = np.maximum.accumulate(rows * w + end)
    prev = np.concatenate([[-1], reach[:-1]])
    prev_end = np.where(prev // w == rows, prev % w, 0)
    words = int(np.maximum(end - np.maximum(start, prev_end), 0).sum())
    named = np.unique(np.concatenate([row_a, row_b])).size
    moved = 2 * words + 4 * named + len(row_a) * (12 + 20)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = int(L.sum()) / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_kernel(torch, rng):
    """Phase 2: kernel vs plain version on the card."""
    import torch_bench
    from haploconduct_torch.ops.kernels import score_tasks_cuda
    from haploconduct_torch.ops.score import pack_for_device, score_tasks_plain

    cases = [
        # iteration 1 of an envelope patch: 2 x 44k oriented reads of
        # 150 bp, overlaps of at least 90 bp
        torch_bench.kernel_case("envelope_it1", rng, 88_932, 150, 150, 10_500_000, 90),
        torch_bench.kernel_case("kb_contigs", rng, 64, 6200, 4000, 4096, 2000),
        torch_bench.kernel_case("rows_over_2^16", rng, (1 << 16) + 512, 64, 40, 4096, 34,
                    row_a_lo=(1 << 16) + 512 - 4096),
        torch_bench.kernel_case("wide_9kb", rng, 1600, 9000, 800, 1024, 100),
        # an EC iteration of a polyte-split envelope region: 2 x 1,320
        # oriented reads of 250 bp, overlaps of at least 127 bp
        torch_bench.kernel_case("polyte_region", rng, 2640, 250, 250, 120_000, 127),
        # POLYTE diploid at 50 kb (torch_envelope.py --workflow polyte):
        # its first (EC) iteration, 2 x 13,332 reads of 150 bp, overlaps of
        # at least 77 bp, and a late diploid iteration over contigs
        torch_bench.kernel_case("polyte_diploid_it1", rng, 26_664, 150, 150, 248_268, 77),
        torch_bench.kernel_case("polyte_diploid_late", rng, 1042, 1347, 150, 1177, 60),
        # polyte-split at 500 kb: the largest region's first iteration, and
        # the final pass's first, over every region's contigs (the one step
        # whose size grows with the genome)
        torch_bench.kernel_case("split500_region_it1", rng, 2826, 250, 250, 22_022, 127),
        torch_bench.kernel_case("split500_final", rng, 4890, 2928, 250, 5973, 127),
        # torch_bench.py's example shape (phase 13's loop): 65,536 tasks of
        # 100-400 bp overlaps over the synthetic example reads at width 512
        torch_bench.build_workload(65_536, SEED),
    ]
    thresh = far_threshold()
    report = []
    for name, codes, quals, lens, row_a, row_b, pos in cases:
        L = np.minimum(lens[row_a] - pos, lens[row_b])
        L = np.where(pos >= lens[row_a], 0, L)
        comb = pack_for_device(codes, quals, "cuda")
        cols = [torch.from_numpy(c.astype(np.int32)).cuda()
                for c in (lens, row_a, row_b, pos)]
        n_tasks = len(row_a)
        bound_ms, bound_by = score_bound(lens, row_a, row_b, pos, L)
        max_err = 0.0
        for th in (0.0, thresh):
            kern = score_tasks_cuda(comb, *cols, th)
            plain = score_tasks_plain(comb, *cols, th)
            torch.cuda.synchronize()
            for j, col in enumerate(("counted", "mismatches", "rejected"), 1):
                if not torch.equal(kern[j], plain[j]):
                    raise AssertionError(f"{name}: kernel {col} differs from plain")
            if not torch.allclose(kern[0], plain[0], rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{name}: kernel sum_log differs from plain")
            max_err = max(max_err, float((kern[0] - plain[0]).abs().max()))
            if th > 0 and name == "envelope_it1" and int(kern[3].sum()) == 0:
                raise AssertionError("threshold test rejected no lane")
        ms = cuda_ms(lambda: score_tasks_cuda(comb, *cols, 0.0), 10)
        plain_ms = cuda_ms(lambda: score_tasks_plain(comb, *cols, 0.0), 3)
        log(f"[kernel] {name}: R={codes.shape[0]} W={codes.shape[1]} "
            f"tasks={n_tasks} lanes={int(L.sum())} max_abs_err={max_err:.3g} "
            f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; thresholds 0 and {thresh:.4f})")
        report.append(dict(name=name, tasks=n_tasks, max_abs_err=max_err,
                           ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by))
        del comb, cols
    torch.cuda.empty_cache()
    return report


def dryrun_store():
    """160 reads of 150 bp from a 2 kb genome, phreds 20-40."""
    from haploconduct_torch.workflows.savage import ReadStore

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 2000).astype(np.int8)
    store = ReadStore()
    for i in range(160):
        start = int(rng.integers(0, len(genome) - 150 + 1))
        store.add_single_codes(i, genome[start:start + 150].copy(),
                               rng.integers(20, 41, 150).astype(np.uint8))
    store.readcount_single = 160
    return store


def envelope_strains(rng, genome_len=10_000, n_haps=4, divergence=0.03):
    """The envelope patch's strains (code arrays): a random master genome
    and n_haps - 1 strains, each `divergence` from it."""
    master = rng.integers(0, 4, genome_len).astype(np.int8)
    haps = [master]
    for _ in range(n_haps - 1):
        h = master.copy()
        at = rng.choice(genome_len, int(round(genome_len * divergence)), replace=False)
        h[at] = (h[at] + rng.integers(1, 4, len(at))) % 4
        haps.append(h)
    return haps


def envelope_patch(seed=SEED, genome_len=10_000, n_haps=4, divergence=0.03,
                   coverage=667, read_len=150, error_rate=0.002):
    """One SAVAGE envelope patch: uniform single-end reads of the
    envelope_strains at constant phred 40."""
    from haploconduct_torch.workflows.savage import ReadStore

    rng = np.random.default_rng(seed)
    haps = envelope_strains(rng, genome_len, n_haps, divergence)
    per_hap = int(coverage / n_haps * genome_len / read_len)
    reads = []
    for h in haps:
        starts = rng.integers(0, genome_len - read_len, per_hap)
        r = h[starts[:, None] + np.arange(read_len)]
        err = rng.random(r.shape) < error_rate
        r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads.append(r)
    reads = np.concatenate(reads)[rng.permutation(per_hap * n_haps)]
    qual = np.full(read_len, 40, np.uint8)
    store = ReadStore()
    for i, r in enumerate(reads):
        store.add_single_codes(i, r.astype(np.int8), qual.copy())
    store.readcount_single = len(reads)
    return store


def sim_store(haps, coverage, read_len, rng):
    """A single-end store of the repo simulator's error-free reads of
    `haps` (utils/simulate.py:simulate_reads; phred 40)."""
    import torch_envelope
    from haploconduct_torch.utils.simulate import simulate_reads

    seqs, quals = simulate_reads(haps, coverage=coverage, read_len=read_len,
                                 rng=rng, error_rate=0.0)
    return torch_envelope.single_end_store(seqs, quals)


def codes_store(seqs):
    """Single-end store of code arrays at phred 40 (the simulator's 'I')."""
    from haploconduct_torch.workflows.savage import ReadStore

    store = ReadStore()
    for i, r in enumerate(seqs):
        store.add_single_codes(i, np.asarray(r, np.int8), np.full(len(r), 40, np.uint8))
    store.readcount_single = len(seqs)
    return store


def write_fasta(path, name, seq):
    with open(path, "w") as f:
        f.write(f">{name}\n{seq}\n")


def contig_like_seqs(n=1000, genome_len=150_000, seed=SEED):
    """n sequences of 300-3,000 bp, alternately from two haplotypes at 0.5%,
    half of them reverse-complemented."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    hap2 = genome.copy()
    at = rng.choice(genome_len, genome_len // 200, replace=False)
    hap2[at] = (hap2[at] + rng.integers(1, 4, len(at))) % 4
    seqs = []
    for i in range(n):
        length = int(rng.integers(300, 3001))
        start = int(rng.integers(0, genome_len - length + 1))
        s = (genome, hap2)[i % 2][start:start + length].copy()
        seqs.append((3 - s[::-1]).copy() if rng.random() < 0.5 else s)
    return seqs


def store_seqs(store):
    return None if store is None else [store.seq_str(i) for i in range(len(store))]


@contextlib.contextmanager
def pinned_mesh(devices):
    """mesh.default_mesh() names `devices` inside the block, whatever cards
    are visible, and is restored after: every verify call scores over
    `devices`, counted under "torch" with one device and under "mesh" with
    more (ops/verify.py)."""
    from haploconduct_torch.parallel import mesh

    saved = mesh.default_mesh
    mesh.default_mesh = lambda: list(devices)
    try:
        yield
    finally:
        mesh.default_mesh = saved


@contextlib.contextmanager
def checked_cache(torch):
    """Inside the block every matrix the cache of the packed read matrix
    (ops/device_cache.py) hands a scoring call is held to a fresh upload of
    the same reads (score.pack_for_device): torch.equal, or the call
    raises. Yields the number of matrices checked so far ({"matrices": n})."""
    from haploconduct_torch.ops import device_cache
    from haploconduct_torch.ops.score import pack_for_device

    checked = {"matrices": 0}
    cached = device_cache.comb_for_devices

    def comb_for_devices(codes, quals, lens_by_row, combined, devices):
        combs = cached(codes, quals, lens_by_row, combined, devices)
        for comb in combs:
            if not torch.equal(comb, pack_for_device(codes, quals, comb.device)):
                raise AssertionError("the cached matrix differs from a fresh upload "
                                     f"on {comb.device} ({codes.shape[0]} rows)")
            checked["matrices"] += 1
        return combs

    device_cache.comb_for_devices = comb_for_devices
    try:
        yield checked
    finally:
        device_cache.comb_for_devices = cached


@contextlib.contextmanager
def cache_off():
    """HC_DEVICE_CACHE=0 inside the block: every scoring call uploads its
    whole matrix."""
    saved = os.environ.get("HC_DEVICE_CACHE")
    os.environ["HC_DEVICE_CACHE"] = "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["HC_DEVICE_CACHE"]
        else:
            os.environ["HC_DEVICE_CACHE"] = saved


def transfers_line(stats) -> str:
    return (f"full={stats['full_bytes'] / 2**20:.2f}MiB uploaded="
            f"{stats['uploaded_bytes'] / 2**20:.2f}MiB over {stats['iterations']} "
            f"matrices, rows reused={stats['reused_rows']} "
            f"changed={stats['changed_rows']}")


def savage_patch_run(torch, patch, backend, devices):
    """SAVAGE a -> b -> c on `patch` with split_num=1, the torch backend
    scoring on the list `devices` whatever cards are visible: phase 4 names
    one, phase 9 (b) card 0 twice. Returns the result, its wall, and the
    scoring kernel's launches, the tasks per backend, the packed matrix's
    transfers (device_cache.TRANSFER_STATS) and the peak CUDA memory of
    the run."""
    from haploconduct_torch.ops import device_cache, kernels
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    on_card = devices[0].type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for key in BACKEND_COUNTS:
        BACKEND_COUNTS[key] = 0
    kernels.score_tasks_cuda.launches = 0
    device_cache.reset_stats()
    with pinned_mesh(devices):
        t0 = time.perf_counter()
        res = run_savage(patch, SavageConfig(split_num=1, backend=backend))
        wall = time.perf_counter() - t0
    return dict(res=res, wall=wall, launches=kernels.score_tasks_cuda.launches,
                counts=dict(BACKEND_COUNTS), transfers=dict(device_cache.TRANSFER_STATS),
                peak=torch.cuda.max_memory_allocated() if on_card else 0)


def reset_counts(kernels, backend_counts, join_calls, join_seconds):
    kernels.score_tasks_cuda.launches = 0
    kernels.join_verify_cuda.launches = 0
    for key in backend_counts:
        backend_counts[key] = 0
    join_calls.clear()
    join_seconds.clear()


def phase_join(torch):
    """Phase 5: the join on the card against the join on the CPU and
    against the host k-mer engine."""
    from haploconduct_torch.ops.kmer_device import (JOIN_SECONDS,
                                                    find_overlap_candidates_device)
    from haploconduct_torch.workflows.polyte import single_end_candidates

    seqs = contig_like_seqs()
    lens = [len(s) for s in seqs]
    find_overlap_candidates_device(seqs[:50], 100, device=torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    JOIN_SECONDS.clear()
    t0 = time.perf_counter()
    card = find_overlap_candidates_device(seqs, 100, device=torch.device("cuda"))
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    cpu = find_overlap_candidates_device(seqs, 100, device=torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    join_s = dict(JOIN_SECONDS)  # the join alone, per device
    if len(card) == 0 or card.dtype != cpu.dtype or any(
            not np.array_equal(card[f], cpu[f]) for f in card.dtype.names):
        raise AssertionError("join: the card's SFO array differs from the CPU's")
    store = codes_store(seqs)
    t0 = time.perf_counter()
    host = single_end_candidates(store, 100, 0.0, engine="host")
    host_s = time.perf_counter() - t0
    dev = single_end_candidates(store, 100, 0.0, engine="device")
    if len(host) != len(dev) or any(not np.array_equal(host[f], dev[f])
                                    for f in host.dtype.names):
        raise AssertionError("join: verified overlaps differ from the host engine's")
    log(f"[join] {len(seqs)} seqs of {min(lens)}-{max(lens)} bp, min overlap 100: "
        f"{len(card)} verified candidates; join alone card {join_s['cuda']:.3f}s "
        f"vs cpu {join_s['cpu']:.3f}s; with verify card {card_s:.3f}s "
        f"(peak_cuda_mem={peak / 2**20:.1f}MiB) vs cpu {cpu_s:.3f}s; "
        f"host engine {host_s:.3f}s; SFO equal card=cpu, overlaps equal join=host")


def phase_polyte_small():
    """Phase 6: POLYTE diploid, torch + join on the card vs native + host join."""
    from haploconduct_torch.utils.simulate import mutate_sequence, random_genome
    from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte

    rng = np.random.default_rng(42)
    hap1 = random_genome(rng, 3000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    store = sim_store([hap1, hap2], 20, 150, rng)
    kw = dict(hap_cov=20, insert_size=150, stddev=15, min_overlap_len=60,
              min_overlap_len_EC=77, diploid=True)
    got = run_polyte(store, PolyteConfig(backend="torch", candidates="auto", **kw))
    want = run_polyte(store, PolyteConfig(backend="native", candidates="host", **kw))
    if not store_seqs(got.store) or store_seqs(got.store) != store_seqs(want.store) \
            or store_seqs(got.diploid_store) != store_seqs(want.diploid_store):
        raise AssertionError("POLYTE (small): torch contigs differ from native's")
    log(f"[polyte_small] {len(store)} reads -> {len(got.store)} contigs, "
        f"{len(got.diploid_store or [])} diploid contigs in {got.iterations} "
        f"iterations, byte-identical torch (join on the card) vs native (host join)")


def phase_savage_ref(workdir):
    """Phase 7: reference-guided SAVAGE stage a, torch vs native."""
    from haploconduct_torch.utils.simulate import mutate_sequence, random_genome
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(7)
    hap = random_genome(rng, 1500)
    store = sim_store([hap, mutate_sequence(hap, rng, sub_rate=0.02)], 40, 120, rng)
    ref = os.path.join(workdir, "savage_ref.fasta")
    write_fasta(ref, "chr", hap)
    out = {b: run_savage(store, SavageConfig(split_num=1, backend=b, reference=ref,
                                             stage_b=False)).contigs("a")
           for b in ("torch", "native")}
    if not out["torch"][0] or out["torch"] != out["native"]:
        raise AssertionError("reference-guided stage a: torch contigs differ from native's")
    log(f"[savage_ref] {len(store)} reads -> {len(out['torch'][0])} stage a contigs, "
        f"byte-identical torch vs native")


def phase_polyte_split(torch, workdir):
    """Phase 8: polyte-split at its envelope, three runs on card 0, the
    quality columns and sha256 of (a)'s contigs, and with two cards or more
    the CLI as two NCCL ranks."""
    import torch_envelope
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.kmer_device import JOIN_CALLS, JOIN_SECONDS
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.workflows.polyte_split import run_polyte_split

    store, haps = torch_envelope.polyte_envelope_store()
    ref = os.path.join(workdir, "envelope_ref.fasta")
    write_fasta(ref, "chr", haps[0])
    card0 = torch.device("cuda", 0)
    runs = {}
    for name, backend, cand in (("a", "torch", "auto"), ("b", "native", "auto"),
                                ("c", "native", "host")):
        cfg = torch_envelope.polyte_split_config(ref, backend=backend, candidates=cand)
        reset_counts(kernels, BACKEND_COUNTS, JOIN_CALLS, JOIN_SECONDS)
        torch.cuda.reset_peak_memory_stats()
        with pinned_mesh([card0]):
            t0 = time.perf_counter()
            res = run_polyte_split(store, cfg)
            wall = time.perf_counter() - t0
        final = res.final.store
        lens = sorted((final.read_len(i) for i in range(len(final))), reverse=True)
        phases: dict = {}
        for r in res.region_results + [res.final]:
            for h in r.history:
                for k, v in h["phase_times"].items():
                    phases[k] = phases.get(k, 0.0) + v
        verify_s = phases.get("verify", 0.0)
        run = dict(wall=wall, verify_s=verify_s, regions=res.regions,
                   failed=res.failed_regions, contigs=store_seqs(final),
                   n=len(final), bp=int(sum(lens)), longest=lens[0] if lens else 0,
                   launches=kernels.score_tasks_cuda.launches,
                   counts=dict(BACKEND_COUNTS), join_calls=dict(JOIN_CALLS),
                   join_s=dict(JOIN_SECONDS), peak=torch.cuda.max_memory_allocated())
        runs[name] = run
        log(f"[polyte_split_{name}] backend={backend} candidates={cand}: "
            f"wall={wall:.2f}s verify_phase={verify_s:.2f}s "
            f"join_s={ {k: round(v, 3) for k, v in run['join_s'].items()} } "
            f"join_calls={run['join_calls']} regions={len(res.regions)} "
            f"failed={len(res.failed_regions)} contigs={run['n']} bp={run['bp']} "
            f"longest={run['longest']} kernel_launches={run['launches']} "
            f"tasks={run['counts']} peak_cuda_mem={run['peak'] / 2**20:.1f}MiB "
            f"iteration_phases_s={ {k: round(v, 2) for k, v in sorted(phases.items())} }")
    a, b, c = runs["a"], runs["b"], runs["c"]
    if a["launches"] == 0:
        raise AssertionError("polyte-split never launched the scoring kernel")
    if a["counts"]["numpy"] or a["counts"]["native"]:
        raise AssertionError("the torch polyte-split scored tasks on a host backend")
    if not a["join_calls"].get("cuda"):
        raise AssertionError("the torch polyte-split never ran the join on the card")
    if any(r["failed"] for r in runs.values()):
        raise AssertionError(f"regions failed: {[r['failed'] for r in runs.values()]}")
    if a["contigs"] != b["contigs"] or a["regions"] != b["regions"]:
        raise AssertionError("polyte-split: torch contigs differ from native's")
    pinned = (435, 296_804, 2_686, 12)
    if (c["n"], c["bp"], c["longest"], len(c["regions"])) != pinned:
        raise AssertionError(f"polyte-split (native, host join) is not the JAX "
                             f"package's pinned result {pinned}")
    same = a["contigs"] == c["contigs"]
    log(f"[polyte_split] torch == native (join on the card); native + host join "
        f"== the JAX package's pin {pinned}; torch vs host join: "
        + ("identical" if same else
           f"differ ({a['n']} vs {c['n']} contigs): above 1,500 sequences the host "
           "engine subsamples seeds while the join is complete"))
    t0 = time.perf_counter()
    quality = torch_envelope.polyte_quality(a["contigs"], haps)
    log(f"[polyte_split_a] sha256 {torch_envelope.contig_digest(a['contigs'])}; "
        f"quality ({time.perf_counter() - t0:.1f}s) per haplotype "
        f"{json.dumps(quality['per_haplotype'])}; union {json.dumps(quality['union'])}")
    if torch.cuda.device_count() < 2:
        log("[polyte_split] the two-rank CLI run needs two cards and this host "
            "has one: not run")
        return a
    ranks, wall = two_rank_polyte_split(store, ref, workdir)
    for rank, got in enumerate(ranks):
        if got != a["contigs"]:
            raise AssertionError(f"polyte-split, two-rank CLI run: rank {rank}'s "
                                 "contigs differ from (a)'s")
    log(f"[polyte_split] two ranks on two cards through the CLI: {wall:.2f}s, "
        "every rank's contigs equal (a)'s")
    return a


def tiny_workload(n_reads=64, read_len=96, n_tasks=256, seed=0):
    """__graft_entry__._tiny_workload's draws, with the port's store: the
    (2 * n_reads, 128) packed codes and quals, one length per row, and a
    random task stream."""
    from haploconduct_torch.workflows.savage import ReadStore

    rng = np.random.default_rng(seed)
    store = ReadStore()
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 6 * read_len))
    for i in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len + 1))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(20, 41, read_len))
        store.add_single(i, genome[start:start + read_len], qual)
    store.readcount_single = n_reads
    packed = store.pack(width=128)
    row_a = rng.integers(0, n_reads, n_tasks).astype(np.int32)
    row_b = rng.integers(0, n_reads, n_tasks).astype(np.int32)
    pos = rng.integers(0, read_len // 2, n_tasks).astype(np.int32)
    lens = np.concatenate([packed.lens, packed.lens]).astype(np.int32)
    return packed.codes, packed.quals, lens, row_a, row_b, pos


def check_step(got, want, threshold, what):
    """Slot scores and counts of two runs of the join + verify step: zero
    pattern equal, scores within 1e-5, counts equal but for slots within
    1e-5 of the threshold. Returns the largest score difference."""
    (gs, gn), (ws, wn) = got, want
    if gs.shape != ws.shape or not np.array_equal(gs == 0, ws == 0):
        raise AssertionError(f"{what}: the zero pattern of the slot scores differs")
    err = float(np.abs(gs - ws).max()) if gs.size else 0.0
    if err > 1e-5:
        raise AssertionError(f"{what}: slot scores differ by {err}")
    if abs(gn - wn) > int(np.sum(np.abs(ws - threshold) < 1e-5)):
        raise AssertionError(f"{what}: slot counts {gn} and {wn} differ")
    return err


def phase_dryrun_steps(torch, device_lists):
    """Phase 10 (a): the dry run's steps 2-4 over each list of devices."""
    from haploconduct_torch.ops.score import score_tasks_torch
    from haploconduct_torch.parallel import mesh

    cpu = torch.device("cpu")
    step_kw = dict(k=13, expand=8, edge_threshold=0.9, min_overlap_len=24)
    for devices in device_lists:
        codes, quals, lens, row_a, row_b, pos = tiny_workload(n_tasks=32 * len(devices))
        tasks = (codes, quals, lens, row_a, row_b, pos)
        # step 2: the sharded scorer on an explicit task stream
        ts = mesh.sharded_score_tasks(*tasks, mesh=devices)
        one = score_tasks_torch(*tasks, device=devices[0])
        if ts.score.shape != row_a.shape or any(
                not np.array_equal(getattr(ts, c), getattr(one, c)) for c in one._fields):
            raise AssertionError(f"dry run step 2 over {devices}: not one call's scores")
        cols = mesh.sharded_verify(devices, *tasks)
        want = (ts.score, ts.mismatch_rate, ts.counted, ts.mismatches)
        if any(not np.array_equal(c, w.astype(c.dtype)) for c, w in zip(cols, want)):
            raise AssertionError(f"dry run step 2 over {devices}: sharded_verify "
                                 "differs from sharded_score_tasks")
        # step 3: the join + verify step, against its plain version on the CPU
        step = mesh.sharded_assembly_step(devices, codes, quals, lens, **step_kw)
        plain = mesh.sharded_assembly_step([cpu], codes, quals, lens, **step_kw)
        err = check_step(step, plain, 0.9, f"dry run step 3 over {devices}")
        if step[0].ndim != 2 or step[1] <= 0:
            raise AssertionError("dry run step 3: no slot above the threshold")
        # step 4: a count over the verified scores, shard by shard
        per = -(-len(ts.score) // len(devices))
        n2 = sum(int((torch.from_numpy(ts.score[i * per:(i + 1) * per]).to(dev) > 0.97)
                     .sum()) for i, dev in enumerate(devices))
        if n2 != int(np.sum(ts.score > 0.97)):
            raise AssertionError("dry run step 4: the shards' counts do not add up")
        log(f"[mesh_dryrun] over {[str(d) for d in devices]}: step 2 {len(row_a)} "
            f"tasks = one call, sharded_verify the same; step 3 {step[0].shape} slot "
            f"scores, {step[1]} slots above 0.9 (max |diff| to the CPU {err:.3g}); "
            f"step 4 {n2} tasks above 0.97")


def envelope_join_inputs(patch):
    """Phase 4's envelope patch as the join's input: the packed matrix
    (forward and reverse-complement rows) and one length per row."""
    packed = patch.pack()
    lens = np.concatenate([packed.lens, packed.lens]).astype(np.int32)
    return packed.codes, packed.quals, lens


JOIN_KW = dict(k=13, expand=8, edge_threshold=0.97, min_overlap_len=30)


def phase_join_verify(torch, inputs, card0):
    """Phase 10 (b), the main path: sharded_assembly_step at full size on
    one device, over two shards on card 0 and over every card when there
    are several, bit-equal."""
    from haploconduct_torch.parallel import mesh

    runs = {"one device": [card0], "two shards on card 0": [card0, card0]}
    if torch.cuda.device_count() > 1:
        runs[f"{torch.cuda.device_count()} cards"] = mesh.default_mesh()
    seconds = {}
    for name, devices in runs.items():
        t0 = time.perf_counter()
        got = mesh.sharded_assembly_step(devices, *inputs, **JOIN_KW)
        seconds[name] = time.perf_counter() - t0
        if name == "one device":
            one = got
        elif not np.array_equal(one[0], got[0]) or one[1] != got[1]:
            raise AssertionError(f"join_verify: {name} differs from one device")
    if one[1] <= 0:
        raise AssertionError("join_verify: no slot above the threshold")
    scores, n_edges = one
    log(f"[join_verify] envelope patch {inputs[0].shape}, k={JOIN_KW['k']} expand="
        f"{JOIN_KW['expand']}: {scores.size} slots, {int(np.sum(scores > 0))} "
        f"verified, {n_edges} above {JOIN_KW['edge_threshold']}; sharded_assembly_step "
        "(host clock) " + ", ".join(f"{k} {v:.3f}s" for k, v in seconds.items())
        + ", bit-equal")
    return one


def step_bound(torch, comb, lens, t_rid, t_pos, left, count, nk, expand):
    """The least time the card could take for one join_verify call on
    these inputs, in ms, what bounds it, and the lanes scored. Bytes, at
    the HBM rate: the matrix, the row lengths, the table's row and
    position columns, left and count, and 4 B of score a slot. Operations,
    at the FP32 rate: one f32 add for each lane of each valid slot's
    diagonal (this run's data)."""
    n = left.shape[0]
    moved = (comb.numel() * 2 + lens.numel() * 4 + t_rid.numel() * 8
             + n * 8 + n * expand * 4)
    d = torch.arange(expand, device=left.device)
    lens64 = lens.long()
    lanes = 0
    for s in range(0, n, 1 << 22):
        q = torch.arange(s, min(s + (1 << 22), n), device=left.device)
        t = torch.clamp(left[q].long()[:, None] + d, max=t_rid.numel() - 1)
        rb = t_rid[t].long()
        r = torch.div(q, nk, rounding_mode="floor")[:, None]
        shift = (q % nk)[:, None] - t_pos[t].long()
        valid = (d < count[q][:, None]) & (rb != r) & (shift >= 0)
        L = torch.minimum(lens64[r] - shift, lens64[rb]).clamp(min=0)
        lanes += int(torch.where(valid, L, 0).sum())
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = lanes / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), lanes


def diagonal_counts(torch, lens, t_rid, t_pos, left, count, nk, expand, tile=None):
    """The valid slots of a join over every row (row0 = 0), and the
    distinct diagonals (r, rb, shift) among them with their lanes
    (min(len[r] - shift, len[rb]) each), counted within each tile of
    `tile` consecutive slots of a row (None: the whole row), as the
    join_verify kernel scores them."""
    from haploconduct_torch.ops.join_verify import slot_diagonals

    n, R = left.shape[0], lens.numel()
    per_row = nk * expand
    n_tiles = 1 if tile is None else -(-per_row // tile)
    rows_per = max(1, (1 << 22) // nk)
    lens64 = lens.long()
    slot = (torch.arange(nk, device=left.device)[:, None] * expand
            + torch.arange(expand, device=left.device))
    tile_of = torch.zeros_like(slot) if tile is None else torch.div(
        slot, tile, rounding_mode="floor")
    valid_n = diags = lanes = 0
    for r0 in range(0, n // nk, rows_per):
        q = torch.arange(r0 * nk, min((r0 + rows_per) * nk, n), device=left.device)
        r, rb, shift, valid = slot_diagonals(t_rid, t_pos, left, count, q, 0, nk, expand)
        tiles = r[:, None] * n_tiles + tile_of.repeat(len(q) // nk, 1)
        key = torch.unique(((tiles * R + rb) * nk + shift)[valid])
        shift, rest = key % nk, torch.div(key, nk, rounding_mode="floor")
        rb, r = rest % R, torch.div(rest, R * n_tiles, rounding_mode="floor")
        valid_n += int(valid.sum())
        diags += key.numel()
        lanes += int(torch.minimum(lens64[r] - shift, lens64[rb]).clamp(min=0).sum())
    return valid_n, diags, lanes


def join_inputs_on_card(torch, inputs, card0):
    """The join_verify kernel's arguments for a join of every row of
    `inputs` (codes, quals, lens) on card0, with JOIN_KW."""
    from haploconduct_torch.ops.join_verify import kmer_queries
    from haploconduct_torch.ops.kmer_device import kmer_hashes, kmer_table
    from haploconduct_torch.ops.score import pack_for_device

    codes, quals, lens = inputs
    R, W = codes.shape
    k = JOIN_KW["k"]
    nk = W - k + 1
    comb = pack_for_device(codes, quals, card0)
    tkey, t_rid, t_pos = kmer_table(kmer_hashes(comb[:, :W] & 7, k).reshape(-1), nk)
    left, count = kmer_queries(comb, W, k, tkey, 0, R)
    return (comb, torch.from_numpy(lens).to(card0), t_rid, t_pos, left, count, 0, nk,
            JOIN_KW["expand"], JOIN_KW["min_overlap_len"], JOIN_KW["edge_threshold"])


def measure_join_verify(torch, inputs, one, card0):
    """Phase 10 (b), after the main path's launches are read: the kernel
    against its plain version on every query row of the patch, then both
    timed, beside the bound, and the slots and distinct diagonals the
    kernel scored. `one` is the main path's one-device result, which the
    kernel's output must equal bit for bit."""
    from haploconduct_torch.ops.join_verify import TILE_SLOTS, join_verify_plain
    from haploconduct_torch.ops.kernels import join_verify_cuda

    R = inputs[0].shape[0]
    full = join_inputs_on_card(torch, inputs, card0)
    comb, lens_d, t_rid, t_pos, left, count, _, nk, expand = full[:9]
    got = [t.cpu().numpy() for t in join_verify_cuda(*full)]
    want = [t.cpu().numpy() for t in join_verify_plain(*full)]
    err = check_step((got[0], int(got[1][0])), (want[0], int(want[1][0])),
                     JOIN_KW["edge_threshold"],
                     f"join_verify kernel vs plain on all {R} query rows")
    if not np.array_equal(got[0], one[0].reshape(-1)):
        raise AssertionError("join_verify: the timed launch differs from the main path's")
    del got, want
    ms = cuda_ms(lambda: join_verify_cuda(*full), 5)
    plain_ms = cuda_ms(lambda: join_verify_plain(*full), 1)
    bound_ms, bound_by, lanes = step_bound(torch, comb, lens_d, t_rid, t_pos,
                                           left, count, nk, expand)
    log(f"[join_verify] kernel vs plain on all {R} query rows ({R * nk} queries, "
        f"{lanes} lanes): zero pattern equal, max_abs_err={err:.3g}; "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by})")
    counts = (torch, lens_d, t_rid, t_pos, left, count, nk, expand)
    valid, diags, diag_lanes = diagonal_counts(*counts, tile=TILE_SLOTS)
    _, row_diags, _ = diagonal_counts(*counts)
    log(f"[join_verify] {valid} valid slots of {R * nk * expand}: the kernel scored "
        f"{diags} distinct diagonals ({diag_lanes} lanes, against the {lanes} lanes of "
        f"the valid slots) in tiles of {TILE_SLOTS} slots of a row; {row_diags} "
        f"distinct a row, so the tiles left {diags - row_diags} repeats")
    del comb, t_rid, t_pos, left, count, full
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def contig_sets(res):
    return {s: res.contigs(s) for s in "abc"
            if (res.combined_store if s == "a" else getattr(res, f"stage_{s}")) is not None}


def phase_mesh_stream(torch, reps=3):
    """Phase 9 (a): the iteration-1 stream scored by sharded_score_tasks
    (parallel/mesh.py) over two shards on card 0, and over every visible
    card when there are several, against one score_tasks_torch call."""
    import torch_bench
    from haploconduct_torch.ops.score import score_tasks_torch
    from haploconduct_torch.parallel import mesh

    card0 = torch.device("cuda", 0)
    # phase 2's first draw
    _, *args = torch_bench.envelope_workload(seed=SEED)
    calls = {"one call": lambda th: score_tasks_torch(*args, mismatch_thresh=th,
                                                      device=card0),
             "2 shards on card 0": lambda th: mesh.sharded_score_tasks(
                 *args, mismatch_thresh=th, mesh=[card0, card0])}
    if torch.cuda.device_count() > 1:
        cards = mesh.default_mesh()
        calls[f"{len(cards)} cards"] = lambda th: mesh.sharded_score_tasks(
            *args, mismatch_thresh=th, mesh=cards)
    with checked_cache(torch) as checked:
        for th in (0.0, far_threshold()):
            one = calls["one call"](th)
            for name, call in calls.items():
                got = call(th)
                for col in ("sum_log", "counted", "mismatches", "rejected"):
                    if not np.array_equal(getattr(got, col), getattr(one, col)):
                        raise AssertionError(f"mesh ({name}, threshold {th}): {col} "
                                             "differs from one score_tasks_torch call")
    seconds = {name: [] for name in calls}
    for _ in range(reps):
        for name, call in calls.items():
            t0 = time.perf_counter()
            call(0.0)
            seconds[name].append(time.perf_counter() - t0)
    log(f"[mesh_a] iteration-1 stream, {len(args[3])} tasks: every sharding "
        f"bit-equal to one call on all four columns (thresholds 0 and "
        f"{far_threshold():.4f}), {checked['matrices']} cached matrices equal "
        f"to a fresh upload; call seconds (host clock, {reps} each): "
        + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)}"
                    for k, vs in seconds.items()))


def phase_mesh_savage(torch, patch, want, tasks, launches):
    """Phase 9 (b): SAVAGE on the envelope patch with default_mesh()
    naming card 0 twice, so every verify call goes through the mesh.
    `want`, `tasks` and `launches` are phase 4's torch contigs, tasks and
    kernel launches."""
    card0 = torch.device("cuda", 0)
    with cache_off():
        run = savage_patch_run(torch, patch, "torch", [card0, card0])
    res, wall = run["res"], run["wall"]
    mesh_launches, counts = run["launches"], run["counts"]
    log(f"[mesh_b] HC_DEVICE_CACHE=0: {transfers_line(run['transfers'])}")
    if run["transfers"]["reused_rows"] or \
            run["transfers"]["uploaded_bytes"] != run["transfers"]["full_bytes"]:
        raise AssertionError("HC_DEVICE_CACHE=0 did not upload every matrix whole")
    verify_s = sum(r.phase_times.get("verify", 0.0)
                   for r in (res.stage_a, res.stage_b, res.stage_c) if r is not None)
    log(f"[mesh_b] SAVAGE a->b->c, default_mesh() = [cuda:0, cuda:0]: "
        f"wall={wall:.2f}s verify_phase={verify_s:.2f}s kernel launches="
        f"{mesh_launches} (phase 4: {launches}) tasks={counts}")
    if contig_sets(res) != want:
        raise AssertionError("SAVAGE contigs through the mesh differ from phase 4's")
    if counts["mesh"] != tasks or counts["torch"] or counts["numpy"] or counts["native"]:
        raise AssertionError(f"the mesh run did not score all {tasks} tasks "
                             f"through the mesh: {counts}")
    if mesh_launches <= launches:
        raise AssertionError("the mesh run launched the kernel no more often "
                             "than phase 4")
    log("[mesh] contigs byte-identical to phase 4 (cache on) with the cache off, "
        "every task through the mesh")
    return mesh_launches


# phase 13's repeats of the kernel loop and of each mesh size
PHASE13_REPEATS, PHASE13_MESH_REPEATS = 5, 2


def phase_bench(torch):
    """Phase 13: torch_bench.py's default mode and --mesh at the example
    shape and the iteration-1 stream, with few repeats. Returns the
    scoring kernel's launches."""
    import math

    import torch_bench
    from haploconduct_torch.ops import kernels

    card0 = torch.device("cuda", 0)
    r = PHASE13_REPEATS
    store = torch_bench.example_store(SEED)
    example = torch_bench.build_workload(65_536, SEED, store)
    envelope = torch_bench.envelope_workload(seed=SEED)
    baseline = torch_bench.build_workload(torch_bench.BASELINE_TASKS, SEED, store)
    printed = io.StringIO()  # the twin's JSON lines, logged below
    kernels.score_tasks_cuda.launches = 0
    with contextlib.redirect_stdout(printed):
        lines = [torch_bench.bench_rates(example, card0, r, baseline_workload=baseline),
                 torch_bench.bench_rates(envelope, card0, r)]
    loop_launches = kernels.score_tasks_cuda.launches
    # a line: the loop's warm-up, one wrapper call, a warm-up replay and
    # three timed loops, then four scoring calls
    if loop_launches != len(lines) * (5 * r + 1 + 4):
        raise AssertionError(f"the repeat loops counted {loop_launches} launches, "
                             f"not {len(lines) * (5 * r + 5)}")
    with contextlib.redirect_stdout(printed):
        lines += [torch_bench.bench_mesh(card0, w, [1, 2, 4, 8], PHASE13_MESH_REPEATS)
                  for w in (example, envelope)]
    launches = kernels.score_tasks_cuda.launches
    for text in printed.getvalue().splitlines():
        log(f"[bench] line {text}")
    for line in lines[:2]:
        want_f, got_f = line["checksum_expected"], line["checksum"]
        if abs(got_f - want_f) > 1e-9 * abs(want_f) or \
                line["checksum_ints"] != line["checksum_ints_expected"]:
            raise AssertionError(f"{line['shape']}: the loop's checksum {got_f} "
                                 f"{line['checksum_ints']} against {want_f} "
                                 f"{line['checksum_ints_expected']}")
        rates = [line["value"], line["median"], *line["samples"], line["call_rate"],
                 line["baseline_live"], line["vs_baseline"], line["host_launches_per_s"]]
        if not all(math.isfinite(v) and v > 0 for v in rates):
            raise AssertionError(f"{line['shape']}: a rate is not positive: {rates}")
        log(f"[bench] {line['shape']}: {line['n_tasks']} tasks ({line['n_sub']} "
            f"subtasks), kernel {line['value']:.4g} tasks/s (median "
            f"{line['median']:.4g}, {line['launch_path']}, host enqueues "
            f"{line['host_launches_per_s']:.4g} launches/s), call "
            f"{line['call_rate']:.4g}/s, live baseline {line['baseline_live']:.4g}/s "
            f"on {line['host_cores']} cores, checksum {line['checksum']:.17g}")
    for line in lines[2:]:
        if not all(math.isfinite(v) and v > 0 for v in line["per_device_count"].values()):
            raise AssertionError(f"{line['shape']}: a mesh rate is not positive")
        log(f"[bench] mesh {line['shape']}: per device count "
            f"{ {k: round(v) for k, v in line['per_device_count'].items()} }, "
            "every sharding bit-equal to one call")
    return launches


def phase_cands(torch):
    """Phase 14: torch_cands.py's synthetic10x and polyte_reads_exact on
    card 0, one timed run an engine."""
    import torch_cands
    from haploconduct_torch.ops.kmer_device import JOIN_CALLS

    JOIN_CALLS.clear()
    printed = io.StringIO()  # the twin's JSON lines, logged below
    with contextlib.redirect_stdout(printed):
        lines = torch_cands.run(["synthetic10x", "polyte_reads_exact"],
                                torch.device("cuda", 0), runs=1)
    for text in printed.getvalue().splitlines():
        log(f"[cands] line {text}")
    if not JOIN_CALLS.get("cuda"):
        raise AssertionError(f"the join did not run on the card: {JOIN_CALLS}")
    for line in lines:
        recalls = [line[k] for k in ("device_recall_vs_host", "host_recall_vs_full",
                                     "device_recall_vs_full")]
        if not all(0.0 <= r <= 1.0 for r in recalls):
            raise AssertionError(f"{line['workload']}: a recall outside [0, 1]: {recalls}")
        if line["checks_failed"]:
            raise AssertionError(f"{line['workload']}: {line['checks_failed']}")
        log(f"[cands] {line['workload']}: {line['n_seqs']} seqs, host "
            f"{line['host_candidates']} in {line['host_s']:.3f}s, join "
            f"{line['device_candidates']} in {line['device_s']:.3f}s, complete "
            f"{line['full_candidates']}; recall join/host {recalls[0]:.6f}, "
            f"host/complete {recalls[1]:.6f}, join/complete {recalls[2]:.6f}; "
            f"groups over expand {line['groups_over_expand']}, over max_group "
            f"{line['groups_over_max_group']}")
    log(f"[cands] join calls on the card {JOIN_CALLS['cuda']}; every set "
        "deterministic, every recall in [0, 1]")


PHASE11_ENVELOPE = dict(total_cov=1334, split_num=2)


def phase11_store():
    """Phase 11's input: (ReadStore, strains) of the SAVAGE envelope at 2
    patches (torch_envelope.py:savage_envelope_store)."""
    import torch_envelope

    return torch_envelope.savage_envelope_store(**PHASE11_ENVELOPE)


def write_reads(store, path):
    from haploconduct_torch.io.fastq import write_fastq

    write_fastq(path, list(range(len(store))),
                [store.seq_str(i) for i in range(len(store))],
                [store.phred_str(i) for i in range(len(store))])
    return path


def two_rank_run(cli_args, device="cuda", timeout=600):
    """The CLI, python -m haploconduct_torch <cli_args> --backend torch
    --device <device>, as two ranks under torchrun (a card a rank);
    returns its wall seconds and raises with the end of its output when
    it fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "haploconduct_torch", *cli_args,
           "--backend", "torch", "--device", device]
    env = dict(os.environ, HC_TORCH_DEVICE=device,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"two-rank CLI run failed ({proc.returncode}):\n"
                             + text[-4000:])
    return wall


def two_rank_cli(store, workdir, split_num, device="cuda", timeout=600):
    """SAVAGE through the CLI as two ranks, the torch backend on `device`;
    returns each rank's {stage: (ids, contigs)} as its output directory
    holds them (rank 0's in -o, rank 1's in <-o>/rank1) and the run's wall
    seconds."""
    from haploconduct_torch.io.fastq import read_fasta

    reads = write_reads(store, os.path.join(workdir, "envelope_reads.fastq"))
    outdir = os.path.join(workdir, "two_ranks")
    wall = two_rank_run(["savage", "-s", reads, "--split", str(split_num),
                         "-o", outdir], device, timeout)
    ranks = []
    for rank_dir in (outdir, os.path.join(outdir, "rank1")):
        got = {}
        for stage in "abc":
            ids, seqs = read_fasta(os.path.join(rank_dir, f"contigs_stage_{stage}.fasta"))
            got[stage] = ([int(i) for i in ids], seqs)
        ranks.append(got)
    return ranks, wall


def two_rank_polyte_split(store, reference, workdir, device="cuda", timeout=900):
    """polyte-split at torch_envelope.polyte_split_config's settings through
    the CLI as two ranks, the torch backend on `device` (the regions
    round-robined over the ranks and gathered); returns each rank's final
    contigs (rank 0's -o/contigs.fasta, rank 1's <-o>/rank1/contigs.fasta)
    and the run's wall seconds. The CLI takes the configuration's
    min_overlap_len_EC, 2 + read_len // 2, from the reads' mean length."""
    import torch_envelope
    from haploconduct_torch.io.fastq import read_fasta

    cfg = torch_envelope.polyte_split_config(reference)
    reads = write_reads(store, os.path.join(workdir, "split_reads.fastq"))
    outdir = os.path.join(workdir, "two_rank_split")
    wall = two_rank_run([
        "polyte-split", "-s", reads, "--ref", reference, "--hap_cov", str(cfg.hap_cov),
        "--insert_size", str(cfg.insert_size), "--stddev", str(cfg.stddev),
        "-m", str(cfg.min_overlap_len), "--split_size", str(cfg.split_size),
        "--split_overlap", str(cfg.split_overlap), "-o", outdir], device, timeout)
    return [read_fasta(os.path.join(d, "contigs.fasta"))[1]
            for d in (outdir, os.path.join(outdir, "rank1"))], wall


def phase_savage_envelope(torch, workdir):
    """Phase 11: SAVAGE over 2 envelope patches, torch against native, and
    as two ranks of the CLI when there are two cards. Returns the torch
    run's launches of the scoring kernel and its contig_sets."""
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    t0 = time.perf_counter()
    store, _ = phase11_store()
    split = PHASE11_ENVELOPE["split_num"]
    log(f"[savage_envelope] {len(store)} reads, {split} patches of 667x, built "
        f"in {time.perf_counter() - t0:.1f}s")
    runs = {}
    for backend in ("torch", "native"):
        for key in BACKEND_COUNTS:
            BACKEND_COUNTS[key] = 0
        kernels.score_tasks_cuda.launches = 0
        with pinned_mesh([torch.device("cuda", 0)]):
            t0 = time.perf_counter()
            res = run_savage(store, SavageConfig(split_num=split, backend=backend,
                                                 min_clique_size=4))
            wall = time.perf_counter() - t0
        if backend == "torch":
            launches = kernels.score_tasks_cuda.launches
            counts = dict(BACKEND_COUNTS)
        runs[backend] = contig_sets(res)
        t = res.timings
        log(f"[savage_envelope_{backend}] wall={wall:.2f}s stage_a={t.get('stage_a_s')}s "
            f"(cand {t.get('stage_a_candidates_s')}s) stage_b={t.get('stage_b_s')}s "
            f"(filter {t.get('stage_b_filter_s')}s) stage_c={t.get('stage_c_s')}s "
            f"(filter {t.get('stage_c_filter_s')}s) contigs a/b/c="
            f"{[len(runs[backend][s][0]) for s in sorted(runs[backend])]}")
    log(f"[savage_envelope_torch] kernel launches={launches} tasks={counts['torch']} "
        f"rechecked_tasks={counts['recheck']}")
    if launches == 0:
        raise AssertionError("the envelope run never launched the scoring kernel")
    if counts["numpy"] or counts["native"]:
        raise AssertionError("the torch envelope run scored tasks on a host backend")
    if set(runs["torch"]) != set("abc") or runs["torch"] != runs["native"]:
        raise AssertionError("envelope contigs (torch) differ from the native engine's")
    log("[savage_envelope] stage a/b/c contigs byte-identical, torch vs native")
    if torch.cuda.device_count() < 2:
        log("[savage_envelope] the two-rank CLI run needs two cards and this "
            "host has one: not run")
        return launches, runs["torch"]
    ranks, wall = two_rank_cli(store, workdir, split)
    for rank, got in enumerate(ranks):
        if got != runs["torch"]:
            raise AssertionError(f"two-rank CLI run: rank {rank}'s contigs differ "
                                 "from the one-process torch run's")
    log(f"[savage_envelope] two ranks on two cards through the CLI: {wall:.2f}s, "
        "every rank's stage a/b/c contigs equal the one-process run's")
    return launches, runs["torch"]


# POLYTE diploid's genome in phase 12: the JAX record's 50 kb
# (tools/br_scale_bench.py), not cut, since both runs together take about
# a minute on the card's host; and the record's contigs and iterations
# there (BASELINE.md:106-117), which phase 12 holds the native run to
PHASE12_GENOME = 50_000
PHASE12_PIN = (570, 37)


def phase_polyte_diploid(torch):
    """Phase 12: POLYTE diploid at the JAX record's operating point (150 bp
    reads at 0.2% error, 20x a haplotype, two haplotypes at 1% over
    PHASE12_GENOME bp; torch_envelope.polyte_diploid_store), the torch
    backend on card 0 against the native engine, both with the host
    candidate engine (the record's): contigs, diploid contigs and
    iterations identical, and the record's PHASE12_PIN. Returns the torch
    run's launches of the scoring kernel."""
    import torch_envelope
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte

    store, _ = torch_envelope.polyte_diploid_store(PHASE12_GENOME)
    card0 = torch.device("cuda", 0)
    out = {}
    for backend in ("torch", "native"):
        for key in BACKEND_COUNTS:
            BACKEND_COUNTS[key] = 0
        kernels.score_tasks_cuda.launches = 0
        with pinned_mesh([card0]):
            t0 = time.perf_counter()
            res = run_polyte(store, PolyteConfig(backend=backend, candidates="host",
                                                 **torch_envelope.POLYTE_CONFIG))
            wall = time.perf_counter() - t0
        if backend == "torch":
            launches, counts = kernels.score_tasks_cuda.launches, dict(BACKEND_COUNTS)
        out[backend] = (store_seqs(res.store), store_seqs(res.diploid_store),
                        res.iterations)
        log(f"[polyte_diploid_{backend}] {len(store)} reads over "
            f"{PHASE12_GENOME // 1000} kb: wall={wall:.2f}s iterations={res.iterations} "
            f"contigs={len(out[backend][0] or [])} diploid="
            f"{len(out[backend][1] or [])} sha256 "
            f"{torch_envelope.contig_digest(out[backend][0] or [])[:16]}")
    log(f"[polyte_diploid_torch] kernel launches={launches} tasks={counts['torch']} "
        f"rechecked_tasks={counts['recheck']}")
    if launches == 0:
        raise AssertionError("POLYTE diploid never launched the scoring kernel")
    if counts["numpy"] or counts["native"] or counts["mesh"]:
        raise AssertionError(f"POLYTE diploid (torch) scored tasks off the kernel: {counts}")
    if not out["torch"][0] or not out["torch"][1] or out["torch"] != out["native"]:
        raise AssertionError("POLYTE diploid: torch contigs differ from native's")
    got = (len(out["native"][0]), out["native"][2])
    if got != PHASE12_PIN:
        raise AssertionError(f"POLYTE diploid (native): {got} contigs and iterations, "
                             f"not the JAX package's record {PHASE12_PIN}")
    log("[polyte_diploid] contigs, diploid contigs and iterations byte-identical, "
        f"torch vs native; {got[0]} contigs in {got[1]} iterations as the JAX "
        "package's record")
    return launches


# phase 15: two ranks over the mesh that spans them, each rank in a
# process of its own, bounded by this timeout (and its collectives too)
PHASE15_TIMEOUT = 600
PHASE15_REPS = 3
PHASE15_ENV = ("PHASE15_BACKEND", "PHASE15_DEVICE", "PHASE15_PORT", "PHASE15_OUT")


def phase15_thresholds():
    """The mismatch thresholds of phase 15 (a)'s calls: a checked call at 0
    and at far_threshold(), then PHASE15_REPS timed calls at 0, each
    checked too."""
    return [0.0, far_threshold()] + [0.0] * PHASE15_REPS


def count_collectives(dist):
    """Wrap torch.distributed's collectives so that each call is recorded
    by name in the returned list."""
    called = []
    for name in ("all_gather_object", "all_gather", "all_gather_into_tensor",
                 "all_reduce", "broadcast", "broadcast_object_list", "barrier",
                 "gather", "scatter", "reduce", "all_to_all", "send", "recv"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **k):
            called.append(_name)
            return _fn(*a, **k)
        setattr(dist, name, counted)
    return called


def sha256_of(array) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def column_digests(ts) -> dict:
    return {col: sha256_of(getattr(ts, col))
            for col in ("sum_log", "counted", "mismatches", "rejected")}


def contig_digests(sets) -> dict:
    """A sha256 of each stage's (ids, contigs) of contig_sets()."""
    import hashlib

    return {s: hashlib.sha256(json.dumps([list(ids), list(seqs)]).encode()).hexdigest()
            for s, (ids, seqs) in sorted(sets.items())}


def global_mesh_rank() -> None:
    """One rank of phase 15, in a process of its own (run_two_ranks starts
    two): RANK, PHASE15_BACKEND (nccl or gloo), PHASE15_DEVICE (its card,
    or cpu), PHASE15_PORT and PHASE15_OUT in the environment. It joins the
    group itself, then (a) scores the iteration-1 stream and runs the
    join + verify step over the mesh that spans the ranks, and (b) runs
    SAVAGE on phase 11's two patches, and writes its digests, counts and
    walls as JSON to PHASE15_OUT."""
    import datetime

    import torch
    import torch.distributed as dist

    import torch_bench
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.parallel import mesh
    from haploconduct_torch.workflows import savage

    rank = int(os.environ["RANK"])
    backend, device, port, out_path = (os.environ[k] for k in PHASE15_ENV)
    own = torch.device(device)
    os.environ["HC_TORCH_DEVICE"] = own.type
    if own.type == "cuda":
        torch.cuda.set_device(own)
        for src in (kernels.SCORE_SRC, kernels.JOIN_SRC):
            kernels.load(src)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=PHASE15_TIMEOUT))
    called = count_collectives(dist)
    entries = [mesh.RankDevice(r, own if r == rank else torch.device(own.type))
               for r in range(2)]
    if mesh.default_mesh() != entries:
        raise AssertionError(f"rank {rank}: default_mesh() {mesh.default_mesh()}")
    out = {"rank": rank, "backend": backend, "device": str(own)}

    # (a) the iteration-1 stream through the mesh, then the join step
    _, *args = torch_bench.envelope_workload(seed=SEED)
    stream = out["stream"] = {"tasks": len(args[3]), "digests": [], "launches": [],
                              "seconds": []}
    for th in phase15_thresholds():
        kernels.score_tasks_cuda.launches = 0
        t0 = time.perf_counter()
        ts = mesh.sharded_score_tasks(*args, mismatch_thresh=th)
        stream["seconds"].append(time.perf_counter() - t0)
        stream["launches"].append(kernels.score_tasks_cuda.launches)
        stream["digests"].append(column_digests(ts))
    del ts, args
    inputs = envelope_join_inputs(envelope_patch())
    kernels.join_verify_cuda.launches = 0
    before = len(called)
    t0 = time.perf_counter()
    scores, n_edges = mesh.sharded_assembly_step(None, *inputs, **JOIN_KW)
    out["join"] = {"seconds": time.perf_counter() - t0, "digest": sha256_of(scores),
                   "n_edges": n_edges, "launches": kernels.join_verify_cuda.launches,
                   "collectives": called[before:]}
    del scores, inputs

    # (b) SAVAGE on phase 11's two patches, a patch a rank in stage a
    store, _ = phase11_store()
    for key in BACKEND_COUNTS:
        BACKEND_COUNTS[key] = 0
    kernels.score_tasks_cuda.launches = 0
    stages = []
    run_stage = savage.run_stage

    def recorded(params, *a, **k):
        c0, l0 = len(called), kernels.score_tasks_cuda.launches
        m0, t0 = BACKEND_COUNTS["mesh"], BACKEND_COUNTS["torch"]
        res = run_stage(params, *a, **k)
        stages.append([params.stage, len(called) - c0,
                       BACKEND_COUNTS["mesh"] - m0, BACKEND_COUNTS["torch"] - t0,
                       kernels.score_tasks_cuda.launches - l0])
        return res

    savage.run_stage = recorded
    t0 = time.perf_counter()
    res = savage.run_savage(store, savage.SavageConfig(
        split_num=PHASE11_ENVELOPE["split_num"], backend="torch", min_clique_size=4))
    sets = contig_sets(res)
    out["savage"] = {"seconds": time.perf_counter() - t0, "timings": res.timings,
                     "digests": contig_digests(sets),
                     "contigs": {s: len(c[0]) for s, c in sets.items()},
                     "launches": kernels.score_tasks_cuda.launches,
                     "counts": dict(BACKEND_COUNTS), "stages": stages}
    savage.run_stage = run_stage
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_two_ranks(torch, workdir, device="cuda", prelude=""):
    """Start phase 15's two ranks (global_mesh_rank, after the Python
    statements `prelude`) and wait for both: on the card, NCCL on cards 0
    and 1 where there are two, else two gloo ranks on card 0 (NCCL takes
    one rank a card); with device "cpu", two gloo ranks on the CPU.
    Returns the backend, the ranks' devices and each rank's JSON record;
    raises with the end of each rank's output when a rank fails or both
    have not ended within PHASE15_TIMEOUT."""
    import socket

    if device == "cpu":
        backend, cards = "gloo", ["cpu", "cpu"]
    elif torch.cuda.device_count() > 1:
        backend, cards = "nccl", ["cuda:0", "cuda:1"]
    else:
        backend, cards = "gloo", ["cuda:0", "cuda:0"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs, outs = [], [], []
    try:
        for rank, card in enumerate(cards):
            outs.append(os.path.join(workdir, f"global_mesh_rank{rank}.json"))
            logs.append(open(os.path.join(workdir, f"global_mesh_rank{rank}.log"), "w+"))
            env = dict(os.environ, RANK=str(rank), PYTHONPATH=here,
                       **dict(zip(PHASE15_ENV, (backend, str(card), str(port),
                                                outs[-1]))))
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 prelude + "\nimport chip_smoke; chip_smoke.global_mesh_rank()"],
                cwd=here, env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                start_new_session=True))
        deadline = time.monotonic() + PHASE15_TIMEOUT
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        tails = []
        for log_file in logs:
            log_file.seek(0)
            tails.append(log_file.read()[-3000:])
            log_file.close()
    codes = [proc.returncode for proc in procs]
    if codes != [0, 0]:
        raise AssertionError(f"phase 15 ranks exited {codes} ({backend} on cards "
                             f"{cards}):\n" + "\n".join(tails))
    records = []
    for path in outs:
        with open(path) as f:
            records.append(json.load(f))
    return backend, cards, records


def phase_global_mesh(torch, join_want, savage_want, device="cuda", prelude=""):
    """Phase 15: two ranks over the mesh that spans them (parallel/mesh.py,
    the twin of the JAX package's global mesh). (a) the iteration-1 stream
    through sharded_score_tasks, every rank's four columns bit-equal to
    one score_tasks_torch call on card 0 (thresholds 0 and
    far_threshold()) with one launch a rank a call, and the join + verify
    step on phase 10 (b)'s patch, bit-equal to one device (`join_want`:
    its sha256 and count) with one launch a rank; (b) SAVAGE on phase 11's
    two patches as the two ranks: stage a rank-local (no collective, no
    task under "mesh"), stages b and c through the mesh, stage a/b/c
    contigs equal phase 11's one-process torch run (`savage_want`, its
    contig_sets). With device "cpu" the same as two gloo ranks on the CPU
    (the kernels' plain versions, no launch), after `prelude` in each rank
    (run_two_ranks). Returns the launches of both kernels over both
    ranks."""
    import torch_bench
    import torch_envelope
    from haploconduct_torch.ops.score import score_tasks_torch

    one = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    launch = 1 if one.type == "cuda" else 0  # a rank's launches a call
    _, *args = torch_bench.envelope_workload(seed=SEED)
    want, one_s = [], []
    for th in phase15_thresholds():
        t0 = time.perf_counter()
        ts = score_tasks_torch(*args, mismatch_thresh=th, device=one)
        one_s.append(time.perf_counter() - t0)
        want.append(column_digests(ts))
    del ts, args
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        backend, cards, ranks = run_two_ranks(torch, workdir, device, prelude)
        wall = time.perf_counter() - t0
    log(f"[global_mesh] two {backend} ranks on {cards} ({wall:.1f}s with "
        f"their start); card: {torch_envelope.card_line()}")
    savage_digests = contig_digests(savage_want)
    for r in ranks:
        a, j, b = r["stream"], r["join"], r["savage"]
        tag = f"rank {r['rank']} ({r['device']})"
        if a["digests"] != want:
            raise AssertionError(f"global mesh, {tag}: the stream's columns differ "
                                 "from one score_tasks_torch call")
        if a["launches"] != [launch] * len(want):
            raise AssertionError(f"global mesh, {tag}: launches a call {a['launches']}")
        log(f"[global_mesh_a] {tag}: {a['tasks']} tasks, all four columns bit-equal "
            f"to one call at thresholds 0 and {far_threshold():.4f}; launches a call "
            f"{a['launches']}; call seconds (host clock) "
            + ", ".join(f"{v:.3f}" for v in a["seconds"]))
        if (j["digest"], j["n_edges"]) != tuple(join_want) or j["launches"] != launch:
            raise AssertionError(f"global mesh, {tag}: the join step differs from one "
                                 f"device or launched {j['launches']} times")
        log(f"[global_mesh_a] {tag}: sharded_assembly_step bit-equal to one device, "
            f"{j['n_edges']} slots above the threshold summed over the ranks, "
            f"{j['launches']} join_verify launch, collectives {j['collectives']}, "
            f"{j['seconds']:.3f}s")
        stage_a = [s for s in b["stages"] if s[0] == "a"]
        rest = [s for s in b["stages"] if s[0] != "a"]
        if len(stage_a) != 1 or stage_a[0][1:3] != [0, 0] or stage_a[0][3] == 0 \
                or (stage_a[0][4] > 0) != bool(launch):
            raise AssertionError(f"global mesh, {tag}: stage a was not rank-local "
                                 f"on the card: {b['stages']}")
        if [s[0] for s in rest] != ["b", "c"] or any(
                s[1] == 0 or s[2] == 0 or s[3] for s in rest):
            raise AssertionError(f"global mesh, {tag}: stages b and c did not go "
                                 f"through the mesh: {b['stages']}")
        if b["counts"]["numpy"] or b["counts"]["native"]:
            raise AssertionError(f"global mesh, {tag}: tasks on a host backend")
        if b["digests"] != savage_digests:
            raise AssertionError(f"global mesh, {tag}: SAVAGE contigs differ from "
                                 "phase 11's one-process torch run")
        t = b["timings"]
        log(f"[global_mesh_b] {tag}: SAVAGE split 2 wall={b['seconds']:.2f}s "
            f"stage_a={t.get('stage_a_s')}s (gather {t.get('stage_a_gather_s')}s) "
            f"stage_b={t.get('stage_b_s')}s stage_c={t.get('stage_c_s')}s contigs "
            f"a/b/c={[b['contigs'][s] for s in 'abc']}; launches={b['launches']} "
            f"tasks={b['counts']}; per stage [stage, collectives, mesh tasks, torch "
            f"tasks, launches] {b['stages']}; a/b/c contigs equal phase 11's")
    log(f"[global_mesh] one score_tasks_torch call on {one}, call seconds (host "
        "clock) " + ", ".join(f"{v:.3f}" for v in one_s))
    return {"score_tasks": sum(sum(r["stream"]["launches"]) + r["savage"]["launches"]
                               for r in ranks),
            "join_verify": sum(r["join"]["launches"] for r in ranks)}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    os.environ["HC_TORCH_DEVICE"] = "cuda"
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(f"[card] {smi.stdout.strip().splitlines()[0]}")

    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.workflows.savage import denovo_candidates

    # phase 1: build every kernel, one nvcc per source at once
    t0 = time.perf_counter()
    kernels.build_all()
    for src in (kernels.SCORE_SRC, kernels.JOIN_SRC):
        kernels.load(src)
    log(f"[build] {kernels.SCORE_SRC.name}, {kernels.JOIN_SRC.name} -> "
        f"{kernels.BUILD_DIR}: {time.perf_counter() - t0:.2f}s")
    for src in (kernels.SCORE_SRC, kernels.JOIN_SRC):
        ptxas = kernels.BUILD_DIR / f"{src.stem}.log"
        for line in (ptxas.read_text().splitlines() if ptxas.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {src.stem}: {line.strip()}")

    # phase 2: kernel vs plain
    report = phase_kernel(torch, np.random.default_rng(SEED))

    # phase 3: stage a, small
    store = dryrun_store()
    ov = denovo_candidates(store, 80, 50, k=16)
    contigs = {}
    for backend in ("torch", "numpy"):
        params = StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                             original_readcount=len(store), backend=backend)
        res = run_stage(params, store, ov)
        contigs[backend] = [res.store.seq_str(i) for i in range(len(res.store))]
    if contigs["torch"] != contigs["numpy"] or not contigs["torch"]:
        raise AssertionError("stage a (small): torch contigs differ from the oracle's")
    log(f"[stage_a_small] {len(store)} reads, {len(ov)} candidates -> "
        f"{len(contigs['torch'])} contigs, byte-identical to the numpy oracle")

    # phase 4: the main path at one envelope patch
    t0 = time.perf_counter()
    patch = envelope_patch()
    log(f"[envelope] {len(patch)} reads of 150 bp built in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {}
    card0 = torch.device("cuda", 0)
    for backend in ("torch", "native"):
        with (checked_cache(torch) if backend == "torch"
              else contextlib.nullcontext()) as checked:
            run = savage_patch_run(torch, patch, backend, [card0])
        res, wall = run["res"], run["wall"]
        if backend == "torch":
            launches, counts, peak = run["launches"], run["counts"], run["peak"]
            transfers, n_checked = run["transfers"], checked["matrices"]
        t = res.timings
        bc = sum(v for k, v in t.items() if k.startswith(("stage_b", "stage_c")))
        verify_s = sum(r.phase_times.get("verify", 0.0)
                       for r in (res.stage_a, res.stage_b, res.stage_c) if r is not None)
        runs[backend] = contig_sets(res)
        # top-level phases only: a dotted phase lies inside one of them
        phases_s = sum(v for k, v in res.stage_a.phase_times.items() if "." not in k)
        log(f"[savage_{backend}] wall={wall:.2f}s stage_a_incl_candidates="
            f"{wall - bc:.2f}s (phases {phases_s:.2f}s) "
            f"stage_b={t.get('stage_b_s')}s "
            f"(cand {t.get('stage_b_candidates_s')}s, filter "
            f"{t.get('stage_b_filter_s')}s) stage_c={t.get('stage_c_s')}s "
            f"(cand {t.get('stage_c_candidates_s')}s, filter "
            f"{t.get('stage_c_filter_s')}s) verify_phase={verify_s:.2f}s "
            f"contigs a/b/c={[len(runs[backend][s][0]) for s in sorted(runs[backend])]}")
    log(f"[savage_torch] kernel launches={launches} tasks={counts['torch']} "
        f"rechecked_tasks={counts['recheck']} numpy_tasks={counts['numpy']} "
        f"native_tasks={counts['native']} peak_cuda_mem={peak / 2**20:.1f}MiB")
    log(f"[savage_torch] the packed matrix kept on the card (ops/device_cache.py): "
        f"{transfers_line(transfers)}; {n_checked} cached matrices, each "
        "torch.equal to a fresh upload")
    if n_checked == 0 or n_checked != transfers["iterations"]:
        raise AssertionError(f"{n_checked} cached matrices checked of "
                             f"{transfers['iterations']}")
    if launches == 0:
        raise AssertionError("the main path never launched the scoring kernel")
    if counts["numpy"] or counts["native"]:
        raise AssertionError("the torch run scored tasks on a host backend")
    if set(runs["torch"]) != set("abc") or runs["torch"] != runs["native"]:
        raise AssertionError("SAVAGE contigs (torch) differ from the native engine's")
    log("[savage] stage a/b/c contigs byte-identical, torch vs native")
    from haploconduct_torch.workflows.evaluate import evaluate_assembly

    strains = ["".join("ACGT"[c] for c in h)
               for h in envelope_strains(np.random.default_rng(SEED))]
    log("[savage_eval] stage c against the 4 strains: "
        + evaluate_assembly(runs["torch"]["c"][1], strains).summary())

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        phase_join(torch)
        phase_polyte_small()
        phase_savage_ref(workdir)
        log(f"[phases 5-7] {time.perf_counter() - t0:.1f}s")
        split = phase_polyte_split(torch, workdir)
        t0 = time.perf_counter()
        envelope_launches, envelope_contigs = phase_savage_envelope(torch, workdir)
        log(f"[phase 11] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    diploid_launches = phase_polyte_diploid(torch)
    log(f"[phase 12] {time.perf_counter() - t0:.1f}s")
    phase_mesh_stream(torch)
    mesh_launches = phase_mesh_savage(torch, patch, runs["torch"], counts["torch"],
                                      launches)

    # phase 10: the dry run's steps 2-4 and the fused join + verify step
    # at full size, the main path of the join_verify kernel
    from haploconduct_torch.parallel import mesh

    card0 = torch.device("cuda", 0)
    device_lists = [[card0, card0]]
    if torch.cuda.device_count() > 1:
        device_lists.append(mesh.default_mesh())
    inputs = envelope_join_inputs(patch)
    t0 = time.perf_counter()
    kernels.score_tasks_cuda.launches = 0
    kernels.join_verify_cuda.launches = 0
    phase_dryrun_steps(torch, device_lists)
    one = phase_join_verify(torch, inputs, card0)
    dryrun_launches = kernels.score_tasks_cuda.launches
    join_launches = kernels.join_verify_cuda.launches
    if dryrun_launches == 0 or join_launches == 0:
        raise AssertionError("phase 10 did not launch both kernels: "
                             f"{dryrun_launches} and {join_launches}")
    join = measure_join_verify(torch, inputs, one, card0)
    join_want = (sha256_of(one[0]), one[1])
    del one, inputs
    log(f"[phase 10] {time.perf_counter() - t0:.1f}s; launches score_tasks "
        f"{dryrun_launches}, join_verify {join_launches}")

    # phase 13: torch_bench.py's default mode and --mesh
    t0 = time.perf_counter()
    bench_launches = phase_bench(torch)
    log(f"[phase 13] {time.perf_counter() - t0:.1f}s; launches score_tasks "
        f"{bench_launches}")

    # phase 14: torch_cands.py, the join on the card against the host engine
    t0 = time.perf_counter()
    phase_cands(torch)
    log(f"[phase 14] {time.perf_counter() - t0:.1f}s")

    # phase 15: two ranks over the mesh that spans them
    t0 = time.perf_counter()
    global_launches = phase_global_mesh(torch, join_want, envelope_contigs)
    log(f"[phase 15] {time.perf_counter() - t0:.1f}s; launches over both ranks "
        f"{global_launches}")

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("haploconduct_tpu", "jax", "jaxlib"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package or jax: {loaded}")
    log("[standalone] no module of haploconduct_tpu and no jax in sys.modules")
    log(f"[total] {time.perf_counter() - t_start:.1f}s")

    env = report[0]
    print(json.dumps({"kernels": [{
        "name": "score_tasks",
        "route": "cuda",
        "source": "haploconduct_torch/csrc/score_tasks.cu",
        "replaces": "haploconduct_tpu/ops/pallas_score.py:75",
        "launches": (launches + split["launches"] + mesh_launches + dryrun_launches
                     + envelope_launches + diploid_launches + bench_launches
                     + global_launches["score_tasks"]),
        "launches_by_path": {"savage": launches, "polyte_split": split["launches"],
                             "mesh": mesh_launches, "mesh_dryrun": dryrun_launches,
                             "savage_envelope": envelope_launches,
                             "polyte_diploid": diploid_launches,
                             "bench": bench_launches,
                             "global_mesh": global_launches["score_tasks"]},
        "max_abs_err": max(r["max_abs_err"] for r in report),
        "ms": env["ms"],
        "plain_ms": env["plain_ms"],
        "bound_ms": env["bound_ms"],
        "bound_by": env["bound_by"],
        # no single PyTorch call computes this function
        "library_ms": None,
    }, {
        "name": "join_verify",
        "route": "cuda",
        "source": "haploconduct_torch/csrc/join_verify.cu",
        # a jnp device program (sharded_pipeline_fn), not a Pallas kernel
        "replaces": "haploconduct_tpu/parallel/mesh.py:404",
        "launches": join_launches + global_launches["join_verify"],
        "launches_by_path": {"join_step": join_launches,
                             "global_mesh": global_launches["join_verify"]},
        "max_abs_err": join["max_abs_err"],
        "ms": join["ms"],
        "plain_ms": join["plain_ms"],
        "bound_ms": join["bound_ms"],
        "bound_by": join["bound_by"],
        # no single PyTorch call computes this function
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
