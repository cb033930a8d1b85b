"""Hooks into the program, from the benchmark's side: wrappers put around
the program's functions where their callers look them up, spans around
them, and the extraction of what the judge compares.

This module is the only part of the harness, with the drivers, that
touches the program's objects; the reference and the judge see numpy
arrays alone.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
from typing import Callable, Dict, List

import numpy as np

SPAN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "spans")


class Patches:
    """Module attributes replaced for the run and put back at the end."""

    def __init__(self):
        self._saved = []

    def wrap(self, target: str, make: Callable) -> None:
        """`target` is "package.module:attr"; `make(fn)` returns the
        wrapper of the function found there."""
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        self._saved.append((mod, attr, fn))
        setattr(mod, attr, make(fn))

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


class Spans:
    """Host seconds spent inside each span (summed over calls and threads),
    from the span files in benchmark/spans/: {"span": name, "kind":
    "span" | "phases", "targets": ["module:function", ...]}. A "phases"
    span reads the phase seconds that the program's PhaseTimer adds during
    each call of assemble/iteration.py:run_iteration. With `annotate`,
    each span also opens a torch.profiler.record_function named
    "bench.<span>", and the program's phase timers annotate their phases,
    so a trace shows both."""

    def __init__(self, patches: Patches, annotate: bool):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.phases: Dict[str, float] = {}
        self.annotate = annotate
        self._lock = threading.Lock()
        for name in sorted(os.listdir(SPAN_DIR)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(SPAN_DIR, name)) as f:
                spec = json.load(f)
            for target in spec["targets"]:
                make = self._phases if spec["kind"] == "phases" else self._span(spec["span"])
                patches.wrap(target, make)

    def _add(self, table, key, dt):
        with self._lock:
            table[key] = table.get(key, 0.0) + dt

    def _span(self, name: str):
        def make(fn):
            def call(*args, **kwargs):
                ann = None
                if self.annotate:
                    import torch.profiler

                    ann = torch.profiler.record_function("bench." + name)
                    ann.__enter__()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._add(self.seconds, name, time.perf_counter() - t0)
                    with self._lock:
                        self.calls[name] = self.calls.get(name, 0) + 1
                    if ann is not None:
                        ann.__exit__(None, None, None)
            return call
        return make

    def _phases(self, fn):
        def call(*args, **kwargs):
            timer = kwargs.get("timer")
            if timer is None:
                from haploconduct_torch.utils.log import PhaseTimer

                timer = kwargs["timer"] = PhaseTimer()
            timer.annotate = timer.annotate or self.annotate
            before = dict(timer.times)
            try:
                return fn(*args, **kwargs)
            finally:
                for phase, sec in timer.times.items():
                    self._add(self.phases, phase, sec - before.get(phase, 0.0))
        return call

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()
            self.phases.clear()


def counters() -> Dict[str, int]:
    """The program's own counts: tasks scored per backend and rechecked in
    f64 (ops/verify.py), kernel launches (ops/kernels.py) and the packed
    matrix's bytes (ops/device_cache.py)."""
    from haploconduct_torch.ops import device_cache, kernels, verify

    out = {f"tasks_{k}": int(v) for k, v in verify.BACKEND_COUNTS.items()}
    out["launches_score_tasks"] = int(kernels.score_tasks_cuda.launches)
    out["launches_join_verify"] = int(kernels.join_verify_cuda.launches)
    for k, v in device_cache.TRANSFER_STATS.items():
        if isinstance(v, (int, float)):
            out[f"transfer_{k}"] = v
    return out


def counter_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


# ------------------------------------------------------------ extraction

def raw_units(reads):
    """The benchmark's own reads, as (codes, phreds) in the store's order,
    with their ids 0..N-1 as the reference takes them."""
    units = [(np.asarray(c, dtype=np.int8), np.asarray(q, dtype=np.uint8)) for c, q in reads]
    return units, np.arange(len(units), dtype=np.int64)


def store_units(store):
    """A store's single-end units and ids, for a call on the program's own
    state (a later iteration's superreads)."""
    if any(bool(p) for p in store.is_paired):
        raise ValueError("the reference judges single-end stores only")
    units = [(np.asarray(store.unit_codes(store.unit1[i]), dtype=np.int8),
              np.asarray(store.unit_quals(store.unit1[i]), dtype=np.uint8))
             for i in range(len(store))]
    return units, np.asarray(store.ids, dtype=np.int64)


def extract_call(units, ids, ov: np.ndarray, settings, result) -> dict:
    """One verify_overlaps call as the judge takes it."""
    from . import reference

    if len(ov) and not (np.all(ov["type1"] == b"s") and np.all(ov["type2"] == b"s")):
        raise ValueError("the reference judges single-end overlaps only")
    scored = result.scored
    score = np.asarray(scored["score"], dtype=np.float64)
    rate = np.asarray(scored["mismatch_rate"], dtype=np.float64)
    is_edge = (score > settings.edge_threshold) | (rate <= settings.merge_contigs)
    cls = np.where(np.asarray(result.nonedge_mask, bool), reference.NONEDGE,
                   reference.NEITHER).astype(np.int8)
    cls[is_edge] = reference.EDGE
    answer = {"score": score, "mismatch_rate": rate, "cls": cls,
              "v1": np.asarray(scored["v1"], np.int64),
              "v2": np.asarray(scored["v2"], np.int64)}
    # the edges the program handed on must be the rows its scores make
    # edges, and no row may be an edge and a non-edge at once
    if (len(result.edges) != int(is_edge.sum())
            or not np.array_equal(result.edges, scored[is_edge])
            or np.any(is_edge & np.asarray(result.nonedge_mask, bool))):
        answer["cls"] = np.full(len(score), -1, np.int8)
    return {"units": units, "ids": ids, "id1": ov["id1"], "id2": ov["id2"],
            "ori1": ov["ori1"] == b"+", "ori2": ov["ori2"] == b"+",
            "pos1": ov["pos1"], "edge_threshold": float(settings.edge_threshold),
            "ov_threshold": float(settings.ov_threshold),
            "merge_contigs": float(settings.merge_contigs),
            "mismatch": float(settings.mismatch),
            "min_read_len": int(settings.min_read_len), "answer": answer}


def extract_contigs(store, subreads, read_units) -> dict:
    """A store of single-end contigs with, for each, its original reads at
    their stated offsets and orientations (io/subreads.py's
    OriginalIndex)."""
    if any(bool(p) for p in store.is_paired):
        raise ValueError("the reference judges single-end contigs only")
    contigs, layouts = [], []
    for i in range(len(store)):
        contigs.append(np.asarray(store.unit_codes(store.unit1[i]), dtype=np.int8))
        placed = (subreads or {}).get(int(store.ids[i]), {})
        layouts.append([(read_units[int(rid)][0], int(oi.index1), bool(oi.forward))
                        for rid, oi in placed.items()])
    return {"contigs": contigs, "layouts": layouts}


class VerifyCapture:
    """Wraps the program's verify_overlaps where run_iteration calls it and
    keeps, for the unit running now, each call's store, overlaps,
    settings and result (references only; extracted after the window)."""

    TARGET = "haploconduct_torch.assemble.iteration:verify_overlaps"

    def __init__(self, patches: Patches):
        self.calls: List[tuple] = []
        self.tasks = 0
        self.keep = False
        patches.wrap(self.TARGET, self._make)

    def _make(self, fn):
        def call(store, packed, ov, s):
            res = fn(store, packed, ov, s)
            self.tasks += int(res.n_tasks)
            if self.keep:
                self.calls.append((store, ov, s, res))
            return res
        return call

    def take(self) -> List[tuple]:
        out, self.calls = self.calls, []
        return out
