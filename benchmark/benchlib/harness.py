"""One run of one cell: set-up, the closed-loop window, the judge, and the
result line.

The window keeps starting units of work while fewer than `seconds` have
passed since it opened, and closes when the last unit it started has
completed; a rate is all the work of the window over all of its time. The
driver draws every unit's input during set-up, from the seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

from . import hooks, judge, manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "haploconduct_tpu")


class Context:
    """What a driver gets: the cell's entry and file, its configuration's
    file, the seed, whether the run is traced, the device, and the patches
    its hooks go into."""

    def __init__(self, name, entry, cell, config, seed, trace, device, patches):
        self.name, self.entry, self.cell, self.config = name, entry, cell, config
        self.seed, self.trace, self.device = seed, trace, device
        self.patches = patches


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def check_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return None


def run_window(driver, seconds: float, trace: bool, device, spans=None):
    """The closed loop. Returns (window seconds, each unit's seconds,
    failures, trace summary or None). `spans` names the host spans a trace
    labels idle time by."""
    import torch

    from . import trace as tracing

    prof = tracing.Profile() if trace else None
    units = failed = 0
    unit_s = []
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            t_unit = time.perf_counter()
            try:
                driver.run_unit(units)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                failed += 1
            unit_s.append(time.perf_counter() - t_unit)
            units += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    summary = None
    if prof is not None:
        names = {"bench." + k for k in spans.seconds} | set(spans.phases) if spans else set()
        summary = prof.summary(names)
    return window_s, unit_s, failed, summary


def run(argv_ns, t_start: float, require_cuda: bool = True, device=None) -> int:
    """Run one cell; print the result line. `require_cuda=False` and a
    `device` are for the benchmark's own tests on the CPU."""
    man = manifest.manifest()
    entry = manifest.workload(man, argv_ns.workload)
    cell = manifest.cell_file(argv_ns.workload)
    config = manifest.config_file(man, entry["config"])
    import torch

    if require_cuda:
        problem = check_cards(int(entry["chips"]))
        if problem:
            print(f"benchmark: {problem}; no result", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, before the peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    return _run(argv_ns, t_start, man, entry, cell, config, device, require_cuda)


def _run(argv_ns, t_start, man, entry, cell, config, device, require_cuda) -> int:
    import torch

    patches = hooks.Patches()
    trace = bool(int(argv_ns.trace))
    ctx = Context(argv_ns.workload, entry, cell, config, int(argv_ns.seed), trace,
                  device, patches)
    try:
        spans = hooks.Spans(patches, annotate=trace)
        driver = manifest.load_module("drivers", cell["driver"]).Driver(ctx)
        driver.setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
        spans.reset()
        before = hooks.counters()
        setup_s = time.perf_counter() - t_start
        window_s, unit_s, failed, summary = run_window(driver, float(argv_ns.seconds), trace,
                                                       device, spans)
        units = len(unit_s)
        counts = hooks.counter_delta(before, hooks.counters())
        peak = (int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0)
        record = {
            "window_s": window_s, "setup_s": setup_s, "units": units,
            "work": driver.work(), "spans": dict(spans.seconds),
            "span_calls": dict(spans.calls), "phases": dict(spans.phases),
            "counters": counts, "trace": summary, "extra": driver.extra(),
        }
    finally:
        patches.restore()
    # the program's state goes before the reference runs
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.judge()
    bad = forbidden_modules()
    busy = (summary or {}).get("busy_s", 0.0)
    limits = cell["limits"]
    checks = judge.verdict(readings, limits)
    correct = failed == 0 and all(ok for *_, ok in checks)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(man, argv_ns.workload, section):
        value = manifest.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = busy
        dev["window_s"] = summary.get("window_s", window_s) if summary else window_s
    if bad:
        print(f"benchmark: modules of {', '.join(bad)} are loaded; no result", file=sys.stderr)
        return 3
    line = {"correct": bool(correct), "attempted": units, "failed": failed,
            "metrics": metrics, "device": dev, "unit_seconds": unit_s}
    if require_cuda:
        line["card"] = card_line()
    line["readings"] = {k: v for k, v in readings.items() if k not in limits}
    if trace and summary:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in checks}
    for name, value, limit, ok in checks:
        print(f"check {name}: {value!r} (limit {limit!r}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0
