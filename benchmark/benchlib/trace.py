"""The device's side of a traced run, from torch.profiler: seconds busy,
kernel seconds by name, and the idle gaps labelled by the host span that
was open. Only the summary is kept, read from the profiler's events in
memory: no trace is written."""

from __future__ import annotations

from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"


def union_seconds(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total = 0.0
    reach = lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The stretches of [lo, hi) that no interval covers."""
    gaps = []
    reach = lo
    for start, end in sorted(intervals):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_of(t: float, spans: List[Tuple[float, float, str]]) -> str:
    """The innermost (shortest) host span open at time t."""
    best, best_len = "no span", float("inf")
    for start, end, name in spans:
        if start <= t < end and end - start < best_len:
            best, best_len = name, end - start
    return best


def summarize(events: List[dict]) -> dict:
    """Reduce Chrome-trace events (times in microseconds) to the window's
    summary, all in seconds."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN and "dur" in e]
    if not window:
        return {}
    lo = float(window[0]["ts"])
    hi = lo + float(window[0]["dur"])
    dev, kernel_s, ops = [], {}, {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if end <= lo or start >= hi:
                continue
            dev.append((start, end))
            sec = (min(end, hi) - max(start, lo)) * 1e-6
            ops[e["name"]] = ops.get(e["name"], 0.0) + sec
            if e.get("cat") == "kernel":
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + sec
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if e.get("cat") == "user_annotation" and "dur" in e and e.get("name") != WINDOW_SPAN]
    by_label: Dict[str, float] = {}
    for a, b in idle_gaps(dev, lo, hi):
        name = label_of(0.5 * (a + b), host)
        by_label[name] = by_label.get(name, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union_seconds(dev, lo, hi) * 1e-6,
        "kernel_s": kernel_s,
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:10],
    }


class Profile:
    """torch.profiler around the window, CPU and CUDA activities."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    def summary(self, annotations) -> dict:
        """The window's summary from the profiler's events in memory (no
        trace file is written). `annotations` are the names of the host
        spans (the benchmark's and the program's phases)."""
        return summarize(device_and_span_events(
            self._prof.profiler.kineto_results.events(), set(annotations)))


def device_and_span_events(kineto_events, annotations) -> List[dict]:
    """Chrome-trace-like dicts (times in microseconds) of the device's
    kernels, copies and memsets and of the named host spans, told apart by
    device type and name alone, which every torch 2.x event has."""
    out = []
    for e in kineto_events:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and name not in annotations and name != WINDOW_SPAN:
            cat = ("gpu_memcpy" if name.startswith("Memcpy")
                   else "gpu_memset" if name.startswith("Memset") else "kernel")
        elif not on_device and (name in annotations or name == WINDOW_SPAN):
            cat = "user_annotation"
        else:
            continue
        out.append({"name": name, "cat": cat, "ts": e.start_ns() * 1e-3,
                    "dur": e.duration_ns() * 1e-3})
    return out
