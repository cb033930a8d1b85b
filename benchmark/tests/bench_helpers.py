"""Helpers of the benchmark's CPU tests: paths, and one cell run on the
CPU at a small genome, with the program's torch backend on its plain
versions (HC_TORCH_DEVICE=cpu)."""

import argparse
import contextlib
import io
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("HC_TORCH_DEVICE", "cpu")


SMALL = {"savage-patch-667x": {"genome_len": 700, "coverage": 667},
         "polyte-diploid-20x": {"genome_len": 1500}}


def shrink(monkeypatch=None, pool=2):
    """Cut every configuration's scale to SMALL, and every cell's pool of
    units to `pool`, for this test."""
    from benchlib import manifest

    orig_config, orig_cell = manifest.config_file, manifest.cell_file

    def config(man, name, root=manifest.ROOT):
        c = orig_config(man, name, root)
        c["shapes"].update(SMALL.get(name, {}))
        return c

    def cell(name, bench_dir=manifest.BENCH_DIR):
        c = orig_cell(name, bench_dir)
        c["pool"] = min(c["pool"], pool)
        return c

    put = monkeypatch.setattr if monkeypatch is not None else setattr
    put(manifest, "config_file", config)
    put(manifest, "cell_file", cell)


def run_small(workload, seed, seconds=0.1, trace=0, monkeypatch=None):
    """harness.run on the CPU at the SMALL scale; returns (exit code,
    result line as a dict or None)."""
    import torch

    from benchlib import harness

    shrink(monkeypatch)
    ns = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(ns, time.perf_counter(), require_cuda=False,
                         device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
