#!/usr/bin/env python3
"""Headline benchmark of haploconduct_torch: overlap verifications per
second per card, the twin of bench.py and tools/pin_baseline.py.

    python3 torch_bench.py [--device cpu] [--seed 0]
    python3 torch_bench.py --e2e [--backend=torch,native] [--runs 2]
    python3 torch_bench.py --mesh [--counts 1,2,4,8]
    python3 torch_bench.py --cands
    python3 torch_bench.py --pin [N] [--pin-path TORCH_BASELINE_PINNED.json]

Workload (bench.py:27-44 reads the bundled savage/example reads, which
neither this repo nor the card's machines hold). The reads here
are synthetic, drawn from --seed with the port's copy of the repo's
simulator (haploconduct_torch/utils/simulate.py) to the example's
documented composition (BASELINE.md:15, :17): 2,000 single-end and 200
paired (forward-forward, inserts of 600 +- 60 bp) reads of 250 bp at
0.2% error and phred 40, from a 9,700 bp random genome and two strains at
3% substitutions, at the frequencies 0.511 / 0.259 / 0.230. The store is
packed at width 512 and the tasks are drawn from the packed store with
bench.py's own arithmetic (`tasks_from_packed`): BENCH_TASKS (65,536)
tasks, overlaps of 100-400 bp.

Each mode prints one JSON line per measurement with bench.py's keys
(metric, value, unit, vs_baseline and the mode's own) and `device` (the
card's name and power limit as nvidia-smi gives them, or "cpu"),
`samples` (every timed run) and `median`. `value` is the best timed run,
as bench.py's. The port runs on the card; with --device cpu (or
HC_TORCH_DEVICE=cpu) it runs the kernels' plain versions on the CPU, and
without a card and without that request it raises. On a card the kernels
are built (ops/kernels.py:build_all) and one small scoring call is made
before anything is timed.

- default (bench.py:bench_device, bench_cpu): the scoring kernel's rate,
  `repeats` launches of score_tasks in one loop on one stream through
  ops/kernels.py:launch_score_tasks, the launch the wrapper makes
  (captured in a CUDA graph when the capture succeeds), each followed by
  bench.py's checksum (the f64 sum of sum_log, and here the integer
  totals of counted and mismatches), timed with CUDA events, best of 3.
  The matrix's max phred is read once before the loop: the wrapper
  ops/kernels.py:score_tasks_cuda waits on the host for it on every call,
  so a loop over the wrapper would time host round trips. The kernel is
  held to its plain version at both shapes in chip_smoke.py phase 2.
  bench.py rolls its task columns each round so that XLA cannot fold the
  rounds; CUDA does not elide launches, so every round here relaunches
  the same columns. Rates count tasks (the kernel takes whole tasks), and the line
  also gives the 512-lane subtasks bench.py counts (`n_sub`). Beside it
  the scoring call's rate (`call_rate`: ops/score.py:score_tasks_torch end
  to end, its matrix kept on the card after a warm-up call), the live
  OpenMP baseline (the port's native/baseline_score.cpp on 200,000 tasks
  of the same store, every host core) and the pinned one
  (TORCH_BASELINE_PINNED.json, measured on the example shape, so only
  that line reads it). A second line does the same at the main
  path's shape, the iteration-1 stream of one SAVAGE envelope patch
  (10.5M tasks over 88,932 rows of 150; chip_smoke.py phase 2's draw),
  unless --envelope-tasks 0.
- --e2e (bench.py:bench_e2e): stage a on the example-shaped store with
  bench.py's candidates and StageParams: one untimed warm-up run a
  backend (its stage wall and phases are in the line as warmup_*), then
  the backends in turns within one process (torch, native, native, torch
  for --runs 2). One line a backend: the stage walls, candidate seconds,
  iterations, contigs and the phase seconds of its best run; vs_baseline
  is native's best stage wall over torch's. Every run's contigs must be
  byte-identical.
- --mesh (bench.py:bench_mesh): parallel/mesh.py:sharded_score_tasks over
  make_mesh(n) for each n of --counts that the host has cards for (on the
  CPU, [cpu] * n), best of 8, at the example shape and the envelope
  stream; every sharding's four columns must equal one score_tasks_torch
  call's bit for bit.
- --cands (bench.py:bench_candidates): the k-mer sort-join
  (ops/kmer_device.py) against the host k-mer engine (ops/kmer.py) on a
  20 kb genome, 15x of 600 bp error-free reads, after a warm-up; the
  candidate counts must be equal.
- --pin [N] (tools/pin_baseline.py): the median of N (9) runs of the
  baseline extension on 200,000 tasks of the example-shaped workload,
  with a pause between samples, written to TORCH_BASELINE_PINNED.json.

A mode whose check fails exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PINNED_PATH = REPO / "TORCH_BASELINE_PINNED.json"

# the savage/example composition (BASELINE.md:15, :17)
GENOME_LEN = 9_700
FREQS = (0.511, 0.259, 0.230)
DIVERGENCE = 0.03
N_SINGLES, N_PAIRS = 2_000, 200
READ_LEN, INSERT, INSERT_STD = 250, 600, 60
WIDTH = 512
BASELINE_TASKS = 200_000
# the iteration-1 stream of one SAVAGE envelope patch (chip_smoke.py phase 2)
ENVELOPE_ROWS, ENVELOPE_WIDTH, ENVELOPE_TASKS, ENVELOPE_SLACK = 88_932, 150, 10_500_000, 90


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def device_label(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[device.index or 0]


def timed(samples) -> dict:
    """samples, their median and best (the largest rate)."""
    return {"samples": [float(s) for s in samples], "median": statistics.median(samples),
            "value": max(samples)}


# ---------------------------------------------------------------- workload


def counts_of(total: int) -> list:
    """`total` reads over the strains at FREQS, the remainder to the last."""
    head = [int(round(total * f)) for f in FREQS[:-1]]
    return head + [total - sum(head)]


def example_reads(seed: int = 0, singles: int = N_SINGLES, pairs: int = N_PAIRS,
                  genome_len: int = GENOME_LEN):
    """(strains, singles [(seq, qual)], pairs [(seq1, seq2, qual)]) drawn
    from `seed` to the example's composition."""
    from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                                   simulate_paired_reads,
                                                   simulate_reads)

    rng = np.random.default_rng(seed)
    master = random_genome(rng, genome_len)
    strains = [master] + [mutate_sequence(master, rng, sub_rate=DIVERGENCE)
                          for _ in FREQS[1:]]
    single_reads, pair_reads = [], []
    for strain, n_s, n_p in zip(strains, counts_of(singles), counts_of(pairs)):
        # coverage for exactly n reads: the simulator draws int(cov * L / len)
        seqs, quals = simulate_reads([strain], (n_s + 0.5) * READ_LEN / len(strain),
                                     READ_LEN, rng)
        single_reads += zip(seqs, quals)
        p1, p2, q = simulate_paired_reads([strain], (n_p + 0.5) * 2 * READ_LEN / len(strain),
                                          READ_LEN, INSERT, INSERT_STD, rng)
        pair_reads += zip(p1, p2, q)
    single_reads = [single_reads[i] for i in rng.permutation(len(single_reads))]
    pair_reads = [pair_reads[i] for i in rng.permutation(len(pair_reads))]
    return strains, single_reads, pair_reads


def fill_store(store, single_reads, pair_reads):
    """Singles 0..S-1, then pairs S.., as ReadStore.from_files adds them;
    works on either package's ReadStore."""
    for i, (seq, qual) in enumerate(single_reads):
        store.add_single(i, seq, qual)
    store.readcount_single = len(single_reads)
    for j, (s1, s2, qual) in enumerate(pair_reads):
        store.add_paired(len(single_reads) + j, s1, qual, s2, qual)
    return store


def example_store(seed: int = 0, **sizes):
    """The port's ReadStore of example_reads(seed)."""
    from haploconduct_torch.core.reads import ReadStore

    _, single_reads, pair_reads = example_reads(seed, **sizes)
    return fill_store(ReadStore(), single_reads, pair_reads)


def tasks_from_packed(packed, n_tasks: int, seed: int = 0):
    """bench.py:35-44's tasks from a store packed at width 512: (lens,
    row_a, row_b, pos), lens doubled for the forward and reverse rows."""
    lens = np.concatenate([packed.lens, packed.lens]).astype(np.int32)
    rng = np.random.default_rng(seed)
    n_rows = packed.codes.shape[0]
    row_a = rng.integers(0, n_rows, n_tasks).astype(np.int32)
    row_b = rng.integers(0, n_rows, n_tasks).astype(np.int32)
    # realistic suffix-prefix diagonals: overlap lengths ~100..read length
    la = lens[row_a]
    ov = rng.integers(100, 400, n_tasks)
    pos = np.maximum(la - ov, 0).astype(np.int32)
    return lens, row_a, row_b, pos


def build_workload(n_tasks: int, seed: int = 0, store=None):
    """(name, codes, quals, lens, row_a, row_b, pos) of the example shape."""
    packed = (store or example_store(seed)).pack(width=WIDTH)
    return ("example", packed.codes, packed.quals,
            *tasks_from_packed(packed, n_tasks, seed))


def random_matrix(rng, R, W, lmin, lmax=None):
    """(R, W) codes/quals with random bases and phreds 2-40 over each
    row's random length, pad beyond it."""
    lens = rng.integers(lmin, (lmax or W) + 1, R).astype(np.int64)
    codes = rng.integers(0, 4, (R, W)).astype(np.int8)
    quals = rng.integers(2, 41, (R, W)).astype(np.uint8)
    pad = np.arange(W)[None, :] >= lens[:, None]
    codes[pad] = 5
    quals[pad] = 0
    return codes, quals, lens


def kernel_case(name, rng, R, W, lmin, B, pos_slack, row_a_lo=0, lmax=None):
    """(name, codes, quals, lens, row_a, row_b, pos): B scoring tasks over
    random_matrix rows, each task's a-side offset below its row's length
    less pos_slack (chip_smoke.py phase 2's shapes)."""
    codes, quals, lens = random_matrix(rng, R, W, lmin, lmax)
    row_a = rng.integers(row_a_lo, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = (rng.random(B) * np.maximum(1, lens[row_a] - pos_slack)).astype(np.int64)
    return name, codes, quals, lens, row_a, row_b, pos


def envelope_workload(n_tasks: int = ENVELOPE_TASKS, seed: int = 0):
    """(name, codes, quals, lens, row_a, row_b, pos) of the iteration-1
    stream of one SAVAGE envelope patch, drawn as chip_smoke.py phase 2
    draws it."""
    return kernel_case("envelope_it1", np.random.default_rng(seed), ENVELOPE_ROWS,
                       ENVELOPE_WIDTH, ENVELOPE_WIDTH, n_tasks, ENVELOPE_SLACK)


def lanes_of(lens, row_a, row_b, pos) -> np.ndarray:
    lens = np.asarray(lens, np.int64)
    pos = np.asarray(pos, np.int64)
    la, lb = lens[row_a], lens[row_b]
    return np.where(pos >= la, 0, np.minimum(la - pos, lb))


# ---------------------------------------------------------------- rates


def prepare(device):
    """The device every mode runs on (None: the torch backend's, which
    raises without a card unless the CPU was asked for). On a card the
    kernels are built and loaded and one small scoring call is made, so
    that neither nvcc nor the first CUDA use lands in a timed run."""
    import torch

    from haploconduct_torch.ops.score import score_tasks_torch
    from haploconduct_torch.parallel.devices import default_device

    device = torch.device(device) if device is not None else default_device()
    if device.type == "cuda":
        from haploconduct_torch.ops import kernels

        kernels.build_all()
        for src in (kernels.SCORE_SRC, kernels.JOIN_SRC):
            kernels.load(src)
        torch.cuda.set_device(device)
        _, *args = build_workload(64, store=example_store(singles=40, pairs=4))
        score_tasks_torch(*args, device=device)
        torch.cuda.synchronize()
    return device


class KernelLoop:
    """`repeats` launches of the scoring kernel on one stream of a card,
    each followed by the checksum: sum_log's f64 sum and the int64 totals
    of counted and mismatches, accumulated on the card. Each launch goes
    through ops/kernels.py:launch_score_tasks with the table sized once by
    the matrix's max phred; a replay of the captured loop counts its
    `repeats` launches."""

    def __init__(self, comb, cols, repeats: int):
        import torch

        from haploconduct_torch.ops import kernels

        self.torch, self.kernels = torch, kernels
        self.comb, self.cols, self.repeats = comb, cols, repeats
        self.max_qual = int(comb.max()) >> 3  # the one host wait, before the loop
        self.group = kernels.default_group(comb.shape[1])
        dev = comb.device
        self.sum_log, self.ints = kernels.score_tasks_outputs(cols[1].shape[0], dev)
        self.acc_f = torch.zeros((), dtype=torch.float64, device=dev)
        self.acc_i = torch.zeros(2, dtype=torch.int64, device=dev)
        self.graph = None

    def launch(self):
        n = self.cols[1].shape[0]
        self.kernels.launch_score_tasks(self.comb, *self.cols, 0.0, self.max_qual,
                                        self.group, self.sum_log, self.ints)
        self.acc_f += self.sum_log.sum()
        self.acc_i += self.ints[:2 * n].view(2, n).sum(dim=1, dtype=self.torch.int64)

    def eager(self):
        for _ in range(self.repeats):
            self.launch()

    def capture(self) -> bool:
        """Capture the loop in a CUDA graph; False when the capture fails."""
        torch = self.torch
        self.eager()  # warm-up outside the capture
        torch.cuda.synchronize()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(self.repeats):
                    self.launch()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            log(f"[bench] the loop did not capture ({exc}); timing it eagerly")
            torch.cuda.synchronize()
            return False
        self.graph = graph
        return True

    def run(self):
        """One timed loop: (seconds by CUDA events, host seconds to enqueue
        it, checksum f64, [counted, mismatches] totals)."""
        torch = self.torch
        self.acc_f.zero_()
        self.acc_i.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        if self.graph is not None:
            self.graph.replay()
            self.kernels.count_score_tasks_launches(self.repeats)
        else:
            self.eager()
        end.record()
        host = time.perf_counter() - t0
        end.synchronize()
        return (start.elapsed_time(end) / 1e3, host, float(self.acc_f),
                [int(v) for v in self.acc_i.tolist()])


def kernel_rate(comb, cols, repeats: int, runs: int = 3) -> dict:
    """The kernel's tasks/s over `runs` timed loops, checked: each loop's
    checksum equals `repeats` times one call's sums (f64 within 1e-9
    relative, integers exactly)."""
    from haploconduct_torch.ops.score import score_tasks_plain

    import torch

    n = cols[1].shape[0]
    if comb.device.type != "cuda":
        # the plain version: no kernel, one call a round
        score_tasks_plain(comb, *cols, 0.0)
        seconds = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(repeats):
                score_tasks_plain(comb, *cols, 0.0)
            seconds.append(time.perf_counter() - t0)
        return dict(timed([n * repeats / s for s in seconds]), launch_path="plain")
    loop = KernelLoop(comb, cols, repeats)
    graphed = loop.capture()
    one = loop.kernels.score_tasks_cuda(comb, *cols, 0.0)
    want_f = float(one[0].sum()) * repeats
    want_i = [int(c.to(torch.int64).sum()) * repeats for c in one[1:3]]
    seconds, hosts = [], []
    loop.run()  # warm-up replay
    for _ in range(runs):
        sec, host, got_f, got_i = loop.run()
        if abs(got_f - want_f) > 1e-9 * abs(want_f) or got_i != want_i:
            raise AssertionError(f"the loop's checksum {got_f}, {got_i} is not "
                                 f"{repeats} x one call's {want_f}, {want_i}")
        seconds.append(sec)
        hosts.append(host)
    out = dict(timed([n * repeats / s for s in seconds]),
               launch_path="cuda_graph" if graphed else "eager",
               checksum=got_f, checksum_expected=want_f, checksum_ints=got_i,
               checksum_ints_expected=want_i)
    # the host's enqueue rate: above the card's, the loop measured the card
    out["host_launches_per_s"] = repeats / min(hosts)
    return out


def call_rate(args, device, runs: int = 3) -> dict:
    """ops/score.py:score_tasks_torch end to end (pack, the card's matrix
    cache, copies, kernel, f64 tail), after a warm-up call."""
    from haploconduct_torch.ops import device_cache
    from haploconduct_torch.ops.score import score_tasks_torch

    score_tasks_torch(*args, device=device)
    device_cache.reset_stats()
    seconds = []
    for _ in range(runs):
        t0 = time.perf_counter()
        score_tasks_torch(*args, device=device)
        seconds.append(time.perf_counter() - t0)
    r = timed([len(args[3]) / s for s in seconds])
    return {"call_rate": r["value"], "call_samples": r["samples"],
            "call_median": r["median"], "call_transfers": dict(device_cache.TRANSFER_STATS)}


def baseline_ext():
    os.environ.setdefault("OMP_NUM_THREADS", str(os.cpu_count()))
    from haploconduct_torch.native import load_baseline_ext

    ext = load_baseline_ext()
    if ext is None:
        raise RuntimeError("the OpenMP baseline extension "
                           "(haploconduct_torch/native/baseline_score.cpp) did not build")
    return ext


def baseline_samples(codes, quals, lens, row_a, row_b, pos, n_samples=1, pause=0.0):
    """Tasks/s of the OpenMP baseline on every host core, after bench.py's
    1,000-task warm-up: one sample a run."""
    ext = baseline_ext()
    ext.score_tasks(codes, quals, lens, row_a[:1000], row_b[:1000], pos[:1000])
    samples = []
    for _ in range(n_samples):
        t0 = time.perf_counter()
        ext.score_tasks(codes, quals, lens, row_a, row_b, pos)
        samples.append(len(row_a) / (time.perf_counter() - t0))
        time.sleep(pause)
    return samples


def pinned_baseline(path: Path = PINNED_PATH):
    """The pinned rate of TORCH_BASELINE_PINNED.json, or None."""
    try:
        return float(json.loads(Path(path).read_text())["value"])
    except (OSError, KeyError, ValueError):
        return None


def bench_rates(workload, device, repeats: int, baseline_workload=None) -> dict:
    """The default mode's line for one workload."""
    import torch

    from haploconduct_torch.ops.score import pack_for_device

    name, codes, quals, lens, row_a, row_b, pos = workload
    lanes = lanes_of(lens, row_a, row_b, pos)
    comb = pack_for_device(codes, quals, device)
    cols = [torch.from_numpy(np.asarray(c).astype(np.int32)).to(device)
            for c in (lens, row_a, row_b, pos)]
    rate = kernel_rate(comb, cols, repeats)
    del comb, cols
    calls = call_rate((codes, quals, lens, row_a, row_b, pos), device)
    bw = baseline_workload or workload
    n_base = min(len(bw[4]), BASELINE_TASKS)
    live = baseline_samples(*bw[1:4], *(c[:n_base] for c in bw[4:]))[0]
    # the pinned baseline was measured on the example-shaped workload
    pinned = pinned_baseline() if name == "example" else None
    vs_live = rate["value"] / live
    return {
        "metric": "overlap verifications/s/card",
        "value": rate["value"],
        "unit": "verifications/s",
        "vs_baseline": rate["value"] / pinned if pinned else vs_live,
        "vs_live": vs_live,
        "baseline_pinned": pinned,
        "baseline_live": live,
        "baseline_live_tasks": n_base,
        "device": device_label(device),
        "samples": rate["samples"],
        "median": rate["median"],
        **{k: v for k, v in rate.items() if k not in ("value", "samples", "median")},
        **calls,
        "shape": name,
        "rows": int(codes.shape[0]),
        "width": int(codes.shape[1]),
        "n_tasks": len(row_a),
        "n_sub": int(np.maximum(-(-lanes // 512), 1).sum()),
        "lanes": int(lanes.sum()),
        "repeats": repeats,
        "relaunch": "the same task columns every round",
        "host_cores": os.cpu_count(),
    }


def bench_default(device, seed: int, n_tasks: int, envelope_tasks: int,
                  repeats: int = 20) -> list:
    store = example_store(seed)
    lines = [emit(bench_rates(build_workload(n_tasks, seed, store), device, repeats,
                              baseline_workload=build_workload(BASELINE_TASKS, seed,
                                                               store)))]
    if envelope_tasks:
        lines.append(emit(bench_rates(envelope_workload(envelope_tasks, seed), device,
                                      repeats)))
    return lines


def bench_pin(n_samples: int, seed: int, path: Path) -> dict:
    """tools/pin_baseline.py: the median of n_samples runs of the baseline
    on 200,000 tasks of the example-shaped workload, written to `path`."""
    _, codes, quals, *cols = build_workload(BASELINE_TASKS, seed)
    samples = baseline_samples(codes, quals, *cols, n_samples=n_samples, pause=0.2)
    median = statistics.median(samples)
    try:
        loadavg = list(os.getloadavg())
    except OSError:
        loadavg = [-1.0] * 3
    rec = {
        "metric": "OpenMP baseline overlap verifications/s (host)",
        "value": median,
        "unit": "verifications/s",
        "samples": samples,
        "n_tasks": BASELINE_TASKS,
        "date": datetime.date.today().isoformat(),
        "host_cores": os.cpu_count(),
        "cpu": platform.processor() or platform.machine(),
        "loadavg_at_pin": loadavg,
        "note": (f"median of {n_samples} runs of haploconduct_torch/native/"
                 "baseline_score.cpp score_tasks, every host core, on torch_bench.py's "
                 f"example-shaped synthetic workload (seed {seed}); re-pin with "
                 "python3 torch_bench.py --pin on the card's host when it changes"),
    }
    Path(path).write_text(json.dumps(rec, indent=1) + "\n")
    spread = (max(samples) - min(samples)) / median
    return emit({"metric": rec["metric"], "value": median, "unit": rec["unit"],
                 "vs_baseline": None, "pinned": str(path), "spread": spread,
                 "device": "cpu", "samples": samples, "median": median,
                 "host_cores": os.cpu_count()})


# ---------------------------------------------------------------- e2e


def stage_run(store, backend: str) -> dict:
    """bench.py:bench_e2e's run: candidates, then stage a."""
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.workflows.savage import denovo_candidates

    t0 = time.perf_counter()
    overlaps = denovo_candidates(store, 200, 50)
    t_cand = time.perf_counter() - t0
    params = StageParams(stage="a", min_overlap_len=200, edge_threshold=0.97,
                         remove_branches=True, max_tip_len=415,
                         original_readcount=len(store), backend=backend)
    t1 = time.perf_counter()
    res = run_stage(params, store, overlaps)
    t_stage = time.perf_counter() - t1
    return dict(stage=t_stage, cand=t_cand, iterations=res.iterations,
                n_candidates=int(len(overlaps)), phases=res.phase_times,
                contigs=[res.store.seq_str(i) for i in range(len(res.store))])


def bench_e2e(device, seed: int, backends, runs: int = 2, store=None) -> list:
    """Stage a, one discarded warm-up run a backend, then the backends in
    turns (ABBA...), one line a backend."""
    from haploconduct_torch.ops import kernels

    store = store or example_store(seed)
    # a process's first stage a took 4-5x its second on an H100 (PERF.md)
    warmup = {b: stage_run(store, b) for b in backends}
    for b, w in warmup.items():
        log(f"[e2e] {b}: warm-up stage {w['stage']:.3f}s (not timed)")
    order = []
    for r in range(runs):
        order += list(backends) if r % 2 == 0 else list(reversed(backends))
    results = {b: [] for b in backends}
    launches = 0
    for b in order:
        before = kernels.score_tasks_cuda.launches
        results[b].append(stage_run(store, b))
        if b == "torch":
            launches += kernels.score_tasks_cuda.launches - before
        log(f"[e2e] {b}: stage {results[b][-1]['stage']:.3f}s")
    contigs = {b: rs[0]["contigs"] for b, rs in results.items()}
    for b, rs in results.items():
        if any(r["contigs"] != contigs[b] for r in rs + [warmup[b]]):
            raise AssertionError(f"{b}'s runs gave different contigs")
    if len({tuple(c) for c in contigs.values()}) > 1:
        raise AssertionError(f"the backends' contigs differ: "
                             f"{ {b: len(c) for b, c in contigs.items()} }")
    best = {b: min(r["stage"] for r in rs) for b, rs in results.items()}
    lines = []
    for b, rs in results.items():
        top = min(rs, key=lambda r: r["stage"])
        stage_s = [r["stage"] for r in rs]
        lines.append(emit({
            "metric": "savage/example-shaped stage-a wall-clock",
            "value": best[b],
            "unit": "s",
            "vs_baseline": best["native"] / best[b] if "native" in best else None,
            "device": device_label(device),
            "samples": stage_s,
            "median": statistics.median(stage_s),
            "candidates_s": [r["cand"] for r in rs],
            "total_s": top["cand"] + top["stage"],
            "iterations": top["iterations"],
            "n_candidates": top["n_candidates"],
            "n_contigs": len(top["contigs"]),
            "contig_bp": sum(len(c) for c in top["contigs"]),
            "backend": b,
            "order": order,
            "launches": launches if b == "torch" else 0,
            "contigs_identical": True,
            "phases": top["phases"],
            "warmup_s": warmup[b]["stage"],
            "warmup_candidates_s": warmup[b]["cand"],
            "warmup_phases": warmup[b]["phases"],
        }))
        lines[-1]["contigs"] = top["contigs"]
    return lines


# ---------------------------------------------------------------- mesh


def mesh_for(n: int, device):
    from haploconduct_torch.parallel import mesh

    return [device] * n if device.type == "cpu" else mesh.make_mesh(n)


def bench_mesh(device, workload, counts, repeats: int = 8) -> dict:
    """sharded_score_tasks over each mesh size, best of `repeats`; every
    column bit-equal to one score_tasks_torch call."""
    import torch

    from haploconduct_torch.ops.score import score_tasks_torch
    from haploconduct_torch.parallel import mesh

    name, *args = workload
    n_tasks = len(args[3])
    avail = len(mesh.default_mesh()) if device.type == "cuda" else max(counts)
    counts = [c for c in counts if c <= avail]
    one = score_tasks_torch(*args, device=device)
    per, samples = {}, {}
    for n in counts:
        devices = mesh_for(n, device)
        got = mesh.sharded_score_tasks(*args, mesh=devices)  # warm-up, checked
        for col in one._fields:
            if getattr(got, col).tobytes() != getattr(one, col).tobytes():
                raise AssertionError(f"mesh of {n}: {col} differs from one call")
        secs = []
        for _ in range(repeats):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.sharded_score_tasks(*args, mesh=devices)
            secs.append(time.perf_counter() - t0)
        samples[str(n)] = [n_tasks / s for s in secs]
        per[str(n)] = max(samples[str(n)])
    top = str(counts[-1])
    line = {
        "metric": f"mesh-sharded verifications/s @ {top} device(s)",
        "value": per[top],
        "unit": "verifications/s",
        "vs_baseline": per[top] / per[str(counts[0])],
        "per_device_count": per,
        "per_device_median": {k: statistics.median(v) for k, v in samples.items()},
        "device": device_label(device),
        "samples": samples[top],
        "median": statistics.median(samples[top]),
        "samples_by_count": samples,
        "platform": device.type,
        "host_cores": os.cpu_count(),
        "n_tasks": n_tasks,
        "shape": name,
        "bit_equal_to_one_call": True,
    }
    if len(counts) == 1:
        line["note"] = f"{avail} device(s) visible: n = {counts[0]} alone"
    return emit(line)


# ---------------------------------------------------------------- candidates


def candidate_seqs(seed: int = 0, genome_len: int = 20_000):
    """bench.py:262-267's input: 15x of 600 bp error-free reads."""
    from haploconduct_torch.core.reads import encode_seq
    from haploconduct_torch.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    seqs_s, _ = simulate_reads([genome], coverage=15, read_len=600, rng=rng,
                               error_rate=0.0)
    return [encode_seq(s) for s in seqs_s]


def bench_candidates(device, seed: int = 0, genome_len: int = 20_000,
                     runs: int = 3) -> dict:
    """The sort-join on `device` against the host engine, after a warm-up
    of each; candidates/s of the join."""
    from haploconduct_torch.ops.kmer import find_overlap_candidates
    from haploconduct_torch.ops.kmer_device import find_overlap_candidates_device

    seqs = candidate_seqs(seed, genome_len)

    def host():
        return find_overlap_candidates(seqs, min_overlap_len=50, k=20, error_rate=0.0,
                                       verify=True, subsample=1)

    def dev():
        return find_overlap_candidates_device(seqs, min_overlap_len=50, error_rate=0.0,
                                              verify=True, device=device)

    t_host, t_dev = [], []
    host_out, dev_out = host(), dev()
    for _ in range(runs):
        t0 = time.perf_counter()
        host_out = host()
        t_host.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dev_out = dev()
        t_dev.append(time.perf_counter() - t0)
    if len(dev_out) != len(host_out):
        raise AssertionError(f"candidate counts differ: join {len(dev_out)}, "
                             f"host {len(host_out)}")
    rates = [len(dev_out) / s for s in t_dev]
    line = emit({
        "metric": "candidate overlaps/s (device sort-join)",
        "value": max(rates),
        "unit": "candidates/s",
        "vs_baseline": min(t_host) / min(t_dev),
        "device": device_label(device),
        "samples": rates,
        "median": statistics.median(rates),
        "n_seqs": len(seqs),
        "n_candidates": int(len(dev_out)),
        "host_s": t_host,
        "device_s": t_dev,
    })
    line["candidates"] = dev_out
    return line


# ---------------------------------------------------------------- main


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--e2e", action="store_true")
    mode.add_argument("--mesh", action="store_true")
    mode.add_argument("--cands", action="store_true")
    mode.add_argument("--pin", nargs="?", type=int, const=9, default=None)
    ap.add_argument("--backend", default="torch,native",
                    help="--e2e: the backends, in turns")
    ap.add_argument("--runs", type=int, default=2, help="--e2e: runs a backend")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: the plain versions on the CPU (HC_TORCH_DEVICE=cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tasks", type=int,
                    default=int(os.environ.get("BENCH_TASKS", 65536)))
    ap.add_argument("--envelope-tasks", type=int, default=ENVELOPE_TASKS,
                    help="tasks of the envelope stream's line (0: none)")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--counts", default="1,2,4,8", help="--mesh: device counts")
    ap.add_argument("--mesh-repeats", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=20_000, help="--cands")
    ap.add_argument("--pin-path", type=Path, default=PINNED_PATH)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    if args.device:
        os.environ["HC_TORCH_DEVICE"] = args.device
    if args.pin is not None:
        bench_pin(args.pin, args.seed, args.pin_path)
        return 0
    device = prepare(None)
    if args.e2e:
        bench_e2e(device, args.seed, args.backend.split(","), args.runs)
    elif args.mesh:
        counts = [int(c) for c in args.counts.split(",")]
        bench_mesh(device, build_workload(args.tasks, args.seed), counts,
                   args.mesh_repeats)
        if args.envelope_tasks:
            bench_mesh(device, envelope_workload(args.envelope_tasks, args.seed),
                       counts, args.mesh_repeats)
    elif args.cands:
        bench_candidates(device, args.seed, args.genome_len)
    else:
        bench_default(device, args.seed, args.tasks, args.envelope_tasks, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
