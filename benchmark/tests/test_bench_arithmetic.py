"""The window, the rates, the idle share and the kernel's bound."""

import time

import numpy as np
import torch

import bench_helpers  # noqa: F401
from benchlib import harness, manifest, roofline, trace


class SleepDriver:
    def __init__(self, unit_s):
        self.unit_s, self.started = unit_s, 0

    def run_unit(self, k):
        assert k == self.started
        self.started += 1
        time.sleep(self.unit_s)


def test_window_starts_units_until_the_time_is_up_and_waits_for_the_last():
    d = SleepDriver(0.12)
    window_s, unit_s, failed, summary = harness.run_window(d, 0.3, False,
                                                           torch.device("cpu"))
    assert len(unit_s) == 3 and failed == 0 and summary is None
    assert all(0.12 <= u < 0.2 for u in unit_s)
    assert 0.36 <= window_s < 0.6


def test_rates_are_all_the_work_over_all_the_time():
    record = {"window_s": 40.0, "work": {"reads": 8892 * 5, "tasks": 10_000_000, "units": 5}}
    reads = manifest.load_module("metrics", "assembly_reads_per_s").read(record)
    tasks = manifest.load_module("metrics", "verify_tasks_per_s").read(record)
    assert reads == 8892 * 5 / 40.0 and tasks == 250_000.0
    record["work"]["reads"] = 0
    assert manifest.load_module("metrics", "assembly_reads_per_s").read(record) is None


def test_idle_share_from_synthetic_intervals():
    # a window of 100 us: kernels over [10, 30) and [20, 40), a copy over
    # [70, 80); host spans "verify" over [0, 50) and "graph" over [50, 100)
    events = [
        {"name": trace.WINDOW_SPAN, "cat": "user_annotation", "ts": 0, "dur": 100},
        {"name": "verify", "cat": "user_annotation", "ts": 0, "dur": 50},
        {"name": "graph", "cat": "user_annotation", "ts": 50, "dur": 50},
        {"name": "score_tasks_kernel", "cat": "kernel", "ts": 10, "dur": 20},
        {"name": "score_tasks_kernel", "cat": "kernel", "ts": 20, "dur": 20},
        {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 70, "dur": 10},
        {"name": "outside", "cat": "kernel", "ts": 150, "dur": 10},
    ]
    s = trace.summarize(events)
    assert abs(s["window_s"] - 100e-6) < 1e-12
    assert abs(s["busy_s"] - 40e-6) < 1e-12
    assert abs(s["kernel_s"]["score_tasks_kernel"] - 40e-6) < 1e-12
    idle = dict(s["idle_gaps"])
    # each gap goes to the span open at its middle
    assert abs(idle["verify"] - 10e-6) < 1e-12  # [0, 10)
    assert abs(idle["graph"] - 50e-6) < 1e-12  # [40, 70) and [80, 100)
    record = {"trace": s}
    pct = manifest.load_module("metrics", "device.idle_pct.assembly").read(record)
    assert abs(pct - 60.0) < 1e-9


def test_score_bound_worked_case():
    # two rows of 100 and 80 (and their reverse rows); task 0 reads row 0
    # from 30 against row 1: L = min(70, 80) = 70; task 1 reads row 1 from
    # 0 against row 0: L = 80. Row 0: spans [30, 100) and [0, 80) -> 100
    # words; row 1: [0, 70) and [0, 80) -> 80 words.
    lens = np.array([100, 80, 100, 80])
    ms, kind = roofline.score_bound(lens, np.array([0, 1]), np.array([1, 0]),
                                    np.array([30, 0]))
    moved = 2 * 180 + 4 * 2 + 2 * 32
    assert kind == "bytes"
    assert abs(ms - moved / roofline.HBM_BYTES_PER_S * 1e3) < 1e-15
    ops_ms = 150 / roofline.FP32_FLOPS * 1e3
    assert ms > ops_ms


def test_roofline_reads_nothing_without_a_kernel():
    reader = manifest.load_module("metrics", "score_tasks_roofline")
    assert reader.read({"trace": {"kernel_s": {}}, "extra": {"bound_ms": 1.0}}) is None
    v = reader.read({"trace": {"kernel_s": {"void score_tasks_kernel<4>": 0.01}},
                     "extra": {"bound_ms": 0.5}})
    assert abs(v - 5.0) < 1e-12


class FakeEvent:
    def __init__(self, name, device, start_us, dur_us):
        self._n, self._d, self._s, self._t = name, device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._t * 1000


def test_profiler_events_are_told_apart_by_device_and_name():
    events = [FakeEvent(trace.WINDOW_SPAN, "CPU", 0, 100),
              FakeEvent("verify", "CPU", 0, 50),
              FakeEvent("verify", "CUDA", 10, 30),  # the span's shadow on the device
              FakeEvent("aten::add", "CPU", 5, 1),
              FakeEvent("score_tasks_kernel<4>", "CUDA", 10, 20),
              FakeEvent("Memcpy HtoD (Pageable -> Device)", "CUDA", 60, 10),
              FakeEvent("Memset (Device)", "CUDA", 80, 5)]
    got = trace.device_and_span_events(events, {"verify"})
    assert [(e["name"], e["cat"]) for e in got] == [
        (trace.WINDOW_SPAN, "user_annotation"), ("verify", "user_annotation"),
        ("score_tasks_kernel<4>", "kernel"), ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
        ("Memset (Device)", "gpu_memset")]
    s = trace.summarize(got)
    assert abs(s["busy_s"] - 35e-6) < 1e-12
    assert list(s["kernel_s"]) == ["score_tasks_kernel<4>"]
