#!/usr/bin/env python3
"""A/B timings of haploconduct_torch on one CUDA card, in one process or
one call, the variants in turns (A, B, B, A).

    python3 torch_ab.py kernel [--old-src SRC] [--reps 10]

The scoring kernel (csrc/score_tasks.cu) with 4 and with 32 lanes a task
at chip_smoke.py's five kernel shapes, each against chip_smoke.py's bound.
With --old-src, also an earlier revision of the kernel built from SRC
(taken from git into a gitignored directory, for example
`git show <commit>:haploconduct_torch/csrc/score_segments.cu >
build/ab/score_segments.cu`), on the same tasks. SRC exports either
`hc_score_segments` (512-lane subtasks cut on the host and their sums
added on the host) or `hc_score_tasks` (this tree's C interface). One
JSON line per shape: the card's name and power limit, CUDA-event ms per
launch (median of --reps after a warm-up), and the wall ms of the whole
scoring call (ops/score.py:score_tasks_torch; for a subtask kernel, the
host split, upload, kernel, download and f64 reduce it needed). Both
revisions must give the same integer columns per task.

    python3 torch_ab.py join [--old-src SRC ...] [--cuts] [--reps 10]

The fused join + verify kernel (csrc/join_verify.cu) against earlier
revisions, each built from its SRC (for example `git show
<commit>:haploconduct_torch/csrc/join_verify.cu >
build/ab/join_verify_old.cu`, with that commit's csrc/lane_p.cuh beside
it), both through the C interface hc_join_verify, on chip_smoke.py's
phase 10 (b) join of the envelope patch (88,928 rows of 150, k = 13,
expand 8), in turns (the old ones, new, new, the old ones in reverse).
Each must give the new one's zero pattern and scores within 1e-5 of
them (f32 sums in other orders). --cuts also times, without comparing,
two cuts of this tree's kernel (join_cuts: the gathers and writes alone,
and those with the hashing but no scoring), to see where its time goes.
One JSON line: the card's name and power limit, CUDA-event ms per launch
(median of --reps after a warm-up) and chip_smoke.py's bound.

    python3 torch_ab.py verify --trees A B [--pairs 3]

SAVAGE a -> b -> c on chip_smoke.py's envelope patch, run by two
checkouts of the repo (for example the parent unpacked with `git archive`
into build/parent, and .) in turns, each run in a fresh process, plus the
native host engine of the second checkout as a yardstick. One JSON line
a run: the tree, the backend, the card, the wall seconds of run_savage,
the verify-phase seconds of stages a, b and c and their sum, the seconds
inside the torch backend's scoring calls (ops/verify.py:
score_tasks_torch), the kernel's launches and the contig counts. All runs
must give the same contigs.

    python3 torch_ab.py cache [--mesh one,all] [--pairs 2]

SAVAGE a -> b -> c on chip_smoke.py's envelope patch, torch backend, with
the cache of the packed read matrix on and off (ops/device_cache.py;
HC_DEVICE_CACHE=0), in turns (on, off, then off, on, ...), each run in a
fresh process of this checkout. For each --mesh entry: "one" pins the
mesh to card 0; "all" leaves every visible card in it, over which verify
shards each scoring call. One JSON line a run: the mesh, the cache, the
card, the wall seconds of run_savage, the verify-phase seconds, the
seconds inside the scoring calls (ops/verify.py:score_tasks_torch, over
either mesh) and of the first one (stage a's iteration 1), the number of
calls, TRANSFER_STATS, the kernel's launches, the contig counts and a
digest. All runs must give the same contigs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---- kernel


def load_lib(src: Path):
    """(kind, entry point) of the kernel library built from src."""
    from haploconduct_torch.ops import kernels

    lib = ctypes.CDLL(str(kernels.build(src)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if hasattr(lib, "hc_score_segments"):
        fn = lib.hc_score_segments
        fn.argtypes = [p, i64, p, p, p, p, i64, ctypes.c_float, p, p, p, p, p]
        kind = "segments"
    else:
        fn = lib.hc_score_tasks
        fn.argtypes = [p, i64, p, p, p, p, i64, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, p, p, p, p, p, p]
        kind = "tasks"
    fn.restype = ctypes.c_int
    return kind, fn


def launch_tasks(fn, comb, cols, max_qual, group):
    """One launch of a task kernel through its C interface, threshold 0
    (ops/kernels.py:launch_score_tasks, which counts it)."""
    from haploconduct_torch.ops import kernels

    n = cols[1].shape[0]
    sum_log, ints = kernels.score_tasks_outputs(n, comb.device)
    kernels.launch_score_tasks(comb, *cols, 0.0, max_qual, group, sum_log, ints, fn=fn)
    return sum_log, ints[:n], ints[n:2 * n], ints[2 * n:3 * n]


def launch_segments(fn, comb, cols):
    """One launch of the subtask kernel, threshold 0."""
    import torch

    n = cols[0].shape[0]
    out = (torch.empty(n, dtype=torch.float32, device=comb.device),
           *(torch.empty(n, dtype=torch.int32, device=comb.device) for _ in range(3)))
    err = fn(comb.data_ptr(), comb.shape[1], *(c.data_ptr() for c in cols), n, 0.0,
             *(o.data_ptr() for o in out), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"subtask kernel launch failed: CUDA error {err}")
    return out


def segments_call(fn, codes, quals, lens, row_a, row_b, pos):
    """The subtask kernel's scoring call: split on the host, the kernel,
    the f64 reduce on the host."""
    import torch
    from haploconduct_torch.ops.score import (finish_task_scores, pack_for_device,
                                              segment_tasks)

    L = np.where(pos >= lens[row_a], 0, np.minimum(lens[row_a] - pos, lens[row_b]))
    *cols, bounds = segment_tasks(row_a, row_b, pos, L)
    comb = pack_for_device(codes, quals, "cuda")
    sub = launch_segments(fn, comb, [torch.from_numpy(c).cuda() for c in cols])
    sums = [np.add.reduceat(c.cpu().numpy().astype(np.float64 if j == 0 else np.int64),
                            bounds) for j, c in enumerate(sub)]
    return finish_task_scores(*sums, pos, lens[row_a], lens[row_b], 0)


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_ab(args) -> int:
    import torch

    import chip_smoke
    import torch_bench
    from haploconduct_torch.ops import kernels
    from haploconduct_torch.ops.score import (pack_for_device, score_tasks_torch,
                                              segment_tasks)

    card = card_name()
    new_fn = load_lib(kernels.SCORE_SRC)[1]
    old_kind, old_fn = load_lib(args.old_src) if args.old_src else (None, None)
    rng = np.random.default_rng(chip_smoke.SEED)
    shapes = [("envelope_it1", 88_932, 150, 150, 10_500_000, 90, 0),
              ("kb_contigs", 64, 6200, 4000, 4096, 2000, 0),
              ("rows_over_2^16", (1 << 16) + 512, 64, 40, 4096, 34, (1 << 16) + 512 - 4096),
              ("wide_9kb", 1600, 9000, 800, 1024, 100, 0),
              ("polyte_region", 2640, 250, 250, 120_000, 127, 0)]
    for name, R, W, lmin, B, slack, lo in shapes:
        _, codes, quals, lens, row_a, row_b, pos = torch_bench.kernel_case(
            name, rng, R, W, lmin, B, slack, row_a_lo=lo)
        L = np.where(pos >= lens[row_a], 0, np.minimum(lens[row_a] - pos, lens[row_b]))
        comb = pack_for_device(codes, quals, "cuda")
        cols = [torch.from_numpy(c.astype(np.int32)).cuda()
                for c in (lens, row_a, row_b, pos)]
        max_qual = int(quals.max())
        variants = {f"new_g{g}": (lambda g=g: launch_tasks(new_fn, comb, cols, max_qual, g))
                    for g in (4, 32)}
        new = launch_tasks(new_fn, comb, cols, max_qual, kernels.default_group(comb.shape[1]))
        subtasks = None
        if old_kind == "segments":
            *sub_np, bounds = segment_tasks(row_a, row_b, pos, L)
            subtasks = len(sub_np[0])
            sub_cols = [torch.from_numpy(c).cuda() for c in sub_np]
            old = launch_segments(old_fn, comb, sub_cols)
            old = [np.add.reduceat(c.cpu().numpy().astype(np.int64), bounds)
                   for c in old[1:]]
            variants["old"] = lambda: launch_segments(old_fn, comb, sub_cols)
        elif old_kind == "tasks":
            old = [c.cpu().numpy() for c in launch_tasks(
                old_fn, comb, cols, max_qual, kernels.default_group(comb.shape[1]))[1:]]
            for g in (4, 32):
                variants[f"old_g{g}"] = (
                    lambda g=g: launch_tasks(old_fn, comb, cols, max_qual, g))
        if old_kind is not None:
            for j, col in enumerate(old, 1):
                if not np.array_equal(col, new[j].cpu().numpy()):
                    raise AssertionError(f"{name}: old and new kernels differ in column {j}")

        order = sorted(variants)
        times = {k: [] for k in order}
        for key in order + order[::-1]:
            times[key].append(chip_smoke.cuda_ms(variants[key], args.reps))
        host_args = (codes, quals, lens, row_a, row_b, pos)
        calls = {"new": lambda: score_tasks_torch(*host_args, device="cuda")}
        if old_kind == "segments":
            calls["old"] = lambda: segments_call(old_fn, *host_args)
        walls = {k: [] for k in calls}
        for key in list(calls) + list(calls)[::-1]:
            walls[key].append(wall_ms(calls[key]))
        bound_ms, bound_by = chip_smoke.score_bound(lens, row_a, row_b, pos, L)
        print(json.dumps({
            "shape": name, "card": card, "tasks": B, "subtasks": subtasks,
            "lanes": int(L.sum()), "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_ms": {k: [round(t, 4) for t in v] for k, v in times.items()},
            "kernel_ms_median": {k: statistics.median(v) for k, v in times.items()},
            "call_wall_ms": {k: [round(t, 2) for t in v] for k, v in walls.items()},
        }), flush=True)
        del comb, cols, variants
        torch.cuda.empty_cache()
    return 0


# ---- join

# the join kernel's tile loop, as its source marks it
_TILE_B = "      __syncthreads();\n      // B:"
_TILE_C = "      // C:"
_TILE_D = "      // D:"
_TILE_END = "      __syncthreads();\n    }\n  }\n  if (edges)"


def join_cuts(out_dir: Path) -> list:
    """Two cuts of csrc/join_verify.cu, written to out_dir with the
    header beside them, for timing only: `cut_gathers` finds each slot's
    key and writes it out (no hashing, no scoring); `cut_no_scoring`
    hashes the keys and writes each slot's entry (no scoring)."""
    import shutil

    from haploconduct_torch.ops import kernels

    src = kernels.JOIN_SRC.read_text()
    if any(src.count(m) != 1 for m in (_TILE_B, _TILE_C, _TILE_D, _TILE_END)):
        raise RuntimeError("the kernel's tile loop is not marked as join_cuts expects")
    gathers = src[:src.index(_TILE_B)] + """      {
        float* out = scores + static_cast<int64_t>(qr) * row_slots + t0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int s = i * kThreads + tid;
          if (s < tile_n) { out[s] = __int_as_float(key[i]); edges += key[i] > 0; }
        }
      }
""" + src[src.index(_TILE_END):]
    no_scoring = (src[:src.index(_TILE_C)] + src[src.index(_TILE_D):]).replace(
        "h >= 0 ? __int_as_float(s_key[h]) : 0.0f", "static_cast<float>(h)")
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(kernels.JOIN_SRC.parent / "lane_p.cuh", out_dir / "lane_p.cuh")
    paths = []
    for name, text in (("cut_gathers", gathers), ("cut_no_scoring", no_scoring)):
        paths.append(out_dir / f"{name}.cu")
        paths[-1].write_text(text)
    return paths


def join_ab(args) -> int:
    import torch

    import chip_smoke
    from haploconduct_torch.ops import kernels

    card = card_name()
    card0 = torch.device("cuda", 0)
    fns = {"new": kernels.load(kernels.JOIN_SRC)}
    cuts = join_cuts(REPO / "build" / "ab" / "cuts") if args.cuts else []
    for src in args.old_src + cuts:
        fn = ctypes.CDLL(str(kernels.build(src))).hc_join_verify
        fn.argtypes = fns["new"].argtypes
        fn.restype = ctypes.c_int
        fns[src.stem] = fn
    full = chip_smoke.join_inputs_on_card(
        torch, chip_smoke.envelope_join_inputs(chip_smoke.envelope_patch()), card0)
    comb, lens, t_rid, t_pos, left, count, row0, nk, expand, mol, thr = full
    n = left.shape[0]
    max_qual = int(comb.max()) >> 3

    def launch(fn):
        scores = torch.empty(n * expand, dtype=torch.float32, device=card0)
        n_edges = torch.zeros(1, dtype=torch.int32, device=card0)
        err = fn(comb.data_ptr(), comb.shape[1], lens.data_ptr(), t_rid.data_ptr(),
                 t_pos.data_ptr(), left.data_ptr(), count.data_ptr(), n, row0, nk,
                 expand, mol, thr, max_qual, scores.data_ptr(), n_edges.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"join_verify launch failed: CUDA error {err}")
        return scores, n_edges

    new = [t.cpu().numpy() for t in launch(fns["new"])]
    err = {}
    for key in (src.stem for src in args.old_src):
        old = [t.cpu().numpy() for t in launch(fns[key])]
        err[key] = chip_smoke.check_step((new[0], int(new[1][0])),
                                         (old[0], int(old[1][0])), thr,
                                         f"join_verify: new against {key}")
    del new
    times = {key: [] for key in fns}
    for key in list(fns)[::-1] + list(fns):
        times[key].append(chip_smoke.cuda_ms(lambda: launch(fns[key]), args.reps))
    bound_ms, bound_by, lanes = chip_smoke.step_bound(torch, comb, lens, t_rid, t_pos,
                                                      left, count, nk, expand)
    print(json.dumps({
        "kernel": "join_verify", "card": card, "old_src": [str(p) for p in args.old_src],
        "cuts": [p.stem for p in cuts],
        "queries": n, "slots": n * expand, "lanes": lanes,
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_diff": err,
        "kernel_ms": {k: [round(t, 4) for t in v] for k, v in times.items()},
        "kernel_ms_median": {k: statistics.median(v) for k, v in times.items()},
    }), flush=True)
    return 0


# ---- verify

RUN = r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke
from haploconduct_torch.ops import kernels, verify
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

backend, card = sys.argv[1], sys.argv[2]
score_s = [0.0]
scorer = verify.score_tasks_torch


def timed(*args, **kwargs):
    t = time.perf_counter()
    out = scorer(*args, **kwargs)  # numpy results: the card is done
    score_s[0] += time.perf_counter() - t
    return out


verify.score_tasks_torch = timed
kernels.load()
torch.zeros(1, device="cuda")
store = chip_smoke.envelope_patch()
t0 = time.perf_counter()
res = run_savage(store, SavageConfig(split_num=1, backend=backend))
wall = time.perf_counter() - t0
by_stage = [r.phase_times.get("verify", 0.0)
            for r in (res.stage_a, res.stage_b, res.stage_c)]
launches = [getattr(kernels, n).launches for n in ("score_tasks_cuda", "score_segments_cuda")
            if hasattr(kernels, n)][0]
print(json.dumps({"backend": backend, "card": card, "wall_s": wall,
                  "verify_s": sum(by_stage), "verify_s_by_stage": by_stage,
                  "score_call_s": score_s[0], "launches": launches,
                  "contigs": [len(res.contigs(s)[0]) for s in "abc"],
                  "digest": hashlib.sha256("\n".join(res.contigs("c")[1]).encode()
                                           ).hexdigest()[:16]}))
"""


def savage_run(tree: str, backend: str, card: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, backend, card], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} {backend} failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["tree"] = tree
    print(json.dumps(out), flush=True)
    return out


CACHE_RUN = r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke
from haploconduct_torch.ops import device_cache, kernels, verify
from haploconduct_torch.parallel import mesh
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

which, card = sys.argv[1], sys.argv[2]
calls = []


def timed(fn):
    def call(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)  # numpy results: the cards are done
        calls.append(time.perf_counter() - t)
        return out
    return call


verify.score_tasks_torch = timed(verify.score_tasks_torch)
kernels.build_all()
kernels.load()
devices = mesh.default_mesh() if which == "all" else [torch.device("cuda", 0)]
for dev in devices:
    torch.zeros(1, device=dev)
store = chip_smoke.envelope_patch()
device_cache.reset_stats()
with chip_smoke.pinned_mesh(devices):
    t0 = time.perf_counter()
    res = run_savage(store, SavageConfig(split_num=1, backend="torch"))
    wall = time.perf_counter() - t0
print(json.dumps({"mesh": which, "devices": len(devices),
                  "cache": device_cache.CombCache().enabled(), "card": card,
                  "wall_s": wall,
                  "verify_s": sum(r.phase_times.get("verify", 0.0)
                                  for r in (res.stage_a, res.stage_b, res.stage_c)),
                  "score_call_s": sum(calls), "first_call_s": calls[0],
                  "calls": len(calls), "transfers": dict(device_cache.TRANSFER_STATS),
                  "launches": kernels.score_tasks_cuda.launches,
                  "contigs": [len(res.contigs(s)[0]) for s in "abc"],
                  "digest": hashlib.sha256("\n".join(res.contigs("c")[1]).encode()
                                           ).hexdigest()[:16]}))
"""


def cache_run(which: str, cache_on: bool, card: str) -> dict:
    env = dict(os.environ, HC_TORCH_DEVICE="cuda")
    if cache_on:
        env.pop("HC_DEVICE_CACHE", None)
    else:
        env["HC_DEVICE_CACHE"] = "0"
    proc = subprocess.run([sys.executable, "-c", CACHE_RUN, which, card], cwd=REPO,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"mesh {which}, cache {cache_on} failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(out), flush=True)
    return out


def cache_ab(args) -> int:
    card = card_name()
    runs = []
    for i in range(args.pairs):
        for which in args.mesh.split(","):
            for cache_on in ((True, False) if i % 2 == 0 else (False, True)):
                runs.append(cache_run(which, cache_on, card))
    if len({(tuple(r["contigs"]), r["digest"]) for r in runs}) != 1:
        raise AssertionError("the runs gave different contigs")
    for r in runs:
        t = r["transfers"]
        if not r["cache"] and (t["reused_rows"] or t["uploaded_bytes"] != t["full_bytes"]):
            raise AssertionError("a run with the cache off reused rows")
    return 0


def verify_ab(args) -> int:
    card = card_name()
    a, b = args.trees
    runs = []
    for i in range(args.pairs):
        for tree in ((a, b) if i % 2 == 0 else (b, a)):
            runs.append(savage_run(tree, "torch", card))
    runs.append(savage_run(b, "native", card))
    if len({(r["contigs"][2], r["digest"]) for r in runs}) != 1:
        raise AssertionError("the runs gave different contigs")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernel")
    k.add_argument("--old-src", type=Path)
    k.add_argument("--reps", type=int, default=10)
    j = sub.add_parser("join")
    j.add_argument("--old-src", type=Path, nargs="*", default=[])
    j.add_argument("--cuts", action="store_true")
    j.add_argument("--reps", type=int, default=10)
    v = sub.add_parser("verify")
    v.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    v.add_argument("--pairs", type=int, default=3)
    c = sub.add_parser("cache")
    c.add_argument("--mesh", default="one")
    c.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    return {"kernel": kernel_ab, "join": join_ab, "verify": verify_ab,
            "cache": cache_ab}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
