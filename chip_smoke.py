#!/usr/bin/env python3
"""Smoke run of haploconduct_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernel from csrc/;
  2. the scoring kernel against its plain PyTorch version on the card, on
     the same subtask streams at four shapes (SAVAGE iteration 1 of one
     envelope patch, kb-wide contigs, more than 2^16 rows, a 9 kb wide
     matrix): integer columns equal, sum_log within rtol 1e-4 / atol 1e-3;
  3. stage a on a 160-read store (150 bp reads of a 2 kb genome, k=16
     candidates) with the torch backend against the f64 numpy oracle
     backend: byte-identical contigs;
  4. SAVAGE stages a -> b -> c on one envelope patch (10 kb genome, 4
     strains at 3% divergence, 150 bp reads at 0.2% error, 667x coverage,
     about 44k reads) with the torch backend, which must go through the
     kernel, against the native host engine: byte-identical contigs.

The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
RTOL, ATOL = 1e-4, 1e-3


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
    codes, quals, lens = random_matrix(rng, R, W, lmin, lmax)
    row_a = rng.integers(row_a_lo, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = (rng.random(B) * np.maximum(1, lens[row_a] - pos_slack)).astype(np.int64)
    return name, codes, quals, lens, row_a, row_b, pos


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


def phase_kernel(torch, rng):
    """Phase 2: kernel vs plain version on the card."""
    from haploconduct_torch.ops.kernels import score_segments_cuda
    from haploconduct_torch.ops.score import (pack_for_device, segment_scores_torch,
                                              segment_tasks)

    cases = [
        # iteration 1 of an envelope patch: 2 x 44k oriented reads of
        # 150 bp, overlaps of at least 90 bp
        kernel_case("envelope_it1", rng, 88_932, 150, 150, 10_500_000, 90),
        kernel_case("kb_contigs", rng, 64, 6200, 4000, 4096, 2000),
        kernel_case("rows_over_2^16", rng, (1 << 16) + 512, 64, 40, 4096, 34,
                    row_a_lo=(1 << 16) + 512 - 4096),
        kernel_case("wide_9kb", rng, 1600, 9000, 800, 1024, 100),
    ]
    thresh = far_threshold()
    report = []
    for name, codes, quals, lens, row_a, row_b, pos in cases:
        L = np.minimum(lens[row_a] - pos, lens[row_b])
        L = np.where(pos >= lens[row_a], 0, L)
        cols_np = segment_tasks(row_a, row_b, pos, L)[:4]
        comb = pack_for_device(codes, quals, "cuda")
        cols = [torch.from_numpy(c).cuda() for c in cols_np]
        n_sub = len(cols_np[0])
        max_err = 0.0
        for th in (0.0, thresh):
            kern = score_segments_cuda(comb, *cols, th)
            plain = segment_scores_torch(comb, *cols, th)
            torch.cuda.synchronize()
            for j, col in enumerate(("counted", "mismatches", "rejected"), 1):
                if not torch.equal(kern[j], plain[j]):
                    raise AssertionError(f"{name}: kernel {col} differs from plain")
            if not torch.allclose(kern[0], plain[0], rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{name}: kernel sum_log differs from plain")
            max_err = max(max_err, float((kern[0] - plain[0]).abs().max()))
            if th > 0 and name == "envelope_it1" and int(kern[3].sum()) == 0:
                raise AssertionError("threshold test rejected no lane")
        ms = cuda_ms(lambda: score_segments_cuda(comb, *cols, 0.0), 10)
        plain_ms = cuda_ms(lambda: segment_scores_torch(comb, *cols, 0.0), 3)
        log(f"[kernel] {name}: R={codes.shape[0]} W={codes.shape[1]} "
            f"subtasks={n_sub} max_abs_err={max_err:.3g} kernel_ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} (thresholds 0 and {thresh:.4f})")
        report.append(dict(name=name, subtasks=n_sub, max_abs_err=max_err,
                           ms=ms, plain_ms=plain_ms))
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


def envelope_patch(seed=SEED, genome_len=10_000, n_haps=4, divergence=0.03,
                   coverage=667, read_len=150, error_rate=0.002):
    """One SAVAGE envelope patch: n_haps strains, each `divergence` from a
    random master genome, uniform single-end reads at constant phred 40."""
    from haploconduct_torch.workflows.savage import ReadStore

    rng = np.random.default_rng(seed)
    master = rng.integers(0, 4, genome_len).astype(np.int8)
    haps = [master]
    for _ in range(n_haps - 1):
        h = master.copy()
        at = rng.choice(genome_len, int(round(genome_len * divergence)), replace=False)
        h[at] = (h[at] + rng.integers(1, 4, len(at))) % 4
        haps.append(h)
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


def contig_sets(res):
    return {s: res.contigs(s) for s in "abc"
            if (res.combined_store if s == "a" else getattr(res, f"stage_{s}")) is not None}


def main() -> int:
    import torch

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
    from haploconduct_torch.ops.verify import BACKEND_COUNTS
    from haploconduct_torch.workflows.savage import (
        SavageConfig, denovo_candidates, run_savage)

    # phase 1: build
    t0 = time.perf_counter()
    kernels.load()
    log(f"[build] {kernels.SCORE_SRC.name} -> {kernels.BUILD_DIR}: "
        f"{time.perf_counter() - t0:.2f}s")
    ptxas = kernels.BUILD_DIR / f"{kernels.SCORE_SRC.stem}.log"
    for line in (ptxas.read_text().splitlines() if ptxas.exists() else []):
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

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
    store = envelope_patch()
    log(f"[envelope] {len(store)} reads of 150 bp built in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {}
    for backend in ("torch", "native"):
        cfg = SavageConfig(split_num=1, backend=backend)
        if backend == "torch":
            torch.cuda.reset_peak_memory_stats()
            for key in BACKEND_COUNTS:
                BACKEND_COUNTS[key] = 0
            kernels.score_segments_cuda.launches = 0
        t0 = time.perf_counter()
        res = run_savage(store, cfg)
        wall = time.perf_counter() - t0
        if backend == "torch":
            launches = kernels.score_segments_cuda.launches
            counts = dict(BACKEND_COUNTS)
            peak = torch.cuda.max_memory_allocated()
        t = res.timings
        bc = sum(v for k, v in t.items() if k.startswith(("stage_b", "stage_c")))
        verify_s = sum(r.phase_times.get("verify", 0.0)
                       for r in (res.stage_a, res.stage_b, res.stage_c) if r is not None)
        runs[backend] = contig_sets(res)
        log(f"[savage_{backend}] wall={wall:.2f}s stage_a_incl_candidates="
            f"{wall - bc:.2f}s (phases {sum(res.stage_a.phase_times.values()):.2f}s) "
            f"stage_b={t.get('stage_b_s')}s "
            f"(cand {t.get('stage_b_candidates_s')}s, filter "
            f"{t.get('stage_b_filter_s')}s) stage_c={t.get('stage_c_s')}s "
            f"(cand {t.get('stage_c_candidates_s')}s, filter "
            f"{t.get('stage_c_filter_s')}s) verify_phase={verify_s:.2f}s "
            f"contigs a/b/c={[len(runs[backend][s][0]) for s in sorted(runs[backend])]}")
    log(f"[savage_torch] kernel launches={launches} tasks={counts['torch']} "
        f"rechecked_tasks={counts['recheck']} numpy_tasks={counts['numpy']} "
        f"native_tasks={counts['native']} peak_cuda_mem={peak / 2**20:.1f}MiB")
    if launches == 0:
        raise AssertionError("the main path never launched the scoring kernel")
    if counts["numpy"] or counts["native"]:
        raise AssertionError("the torch run scored tasks on a host backend")
    if set(runs["torch"]) != set("abc") or runs["torch"] != runs["native"]:
        raise AssertionError("SAVAGE contigs (torch) differ from the native engine's")
    log("[savage] stage a/b/c contigs byte-identical, torch vs native")

    env = report[0]
    print(json.dumps({"kernels": [{
        "name": "score_segments",
        "route": "cuda",
        "source": "haploconduct_torch/csrc/score_segments.cu",
        "replaces": "haploconduct_tpu/ops/pallas_score.py:75",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in report),
        "ms": env["ms"],
        "plain_ms": env["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
