"""Observability: per-iteration logs, stats, and graph exports.

Equivalent of the reference's viralquasispecies.log (parameters + counts,
src/ViralQuasispecies.cpp:166-218, 374-385, 481-489), stats.txt (vertex /
edge / overlap counts appended per iteration), pipeline.log concatenation,
and GFA graph exports — written only when an output directory is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Optional


class PhaseTimer:
    """Per-phase wall-clock accumulator (the reference brackets each main
    phase with get_timestamp() pairs and prints elapsed seconds under
    --verbose, src/ViralQuasispecies.cpp:33-38 + the per-phase prints
    throughout main). Use as `with timer("verify"): ...`; times accumulate
    across calls so multi-iteration runs report totals per phase.

    With `annotate=True` each span also opens a
    torch.profiler.record_function, so phases show up as named host spans
    in a torch.profiler trace captured around the run (see run_stage's
    profile_dir).

    While one of its phases is open, a timer is this thread's current
    timer (`PhaseTimer.current()`): a function called inside the phase
    opens its own phases on it with `nested_phase`, under dotted names
    ("verify.plan")."""

    _open = threading.local()

    def __init__(self, verbose: bool = False, annotate: bool = False):
        self.times: dict = {}
        self.verbose = verbose
        self.annotate = annotate

    @classmethod
    def current(cls) -> Optional["PhaseTimer"]:
        """The timer whose phase is open on this thread, else None."""
        return getattr(cls._open, "timer", None)

    class _Span:
        def __init__(self, timer: "PhaseTimer", name: str):
            self.timer, self.name = timer, name
            self._ann = None

        def __enter__(self):
            if self.timer.annotate:
                import torch.profiler

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            self._outer = PhaseTimer.current()
            PhaseTimer._open.timer = self.timer
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            PhaseTimer._open.timer = self._outer
            if self._ann is not None:
                self._ann.__exit__(None, None, None)
            self.timer.times[self.name] = self.timer.times.get(self.name, 0.0) + dt
            if self.timer.verbose:
                print(f"[phase] {self.name}: {dt:.3f}s")
            return False

    def __call__(self, name: str) -> "PhaseTimer._Span":
        return self._Span(self, name)


def nested_phase(name: str):
    """Phase `name` on the timer whose phase is open on this thread; where
    none is open it times nothing."""
    timer = PhaseTimer.current()
    return contextlib.nullcontext() if timer is None else timer(name)


class RunLogger:
    def __init__(self, output_dir: Optional[str]):
        self.dir = output_dir
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            self._reset("pipeline.log")
            self._reset("stats.txt")

    def _reset(self, name: str) -> None:
        open(os.path.join(self.dir, name), "w").close()

    def iteration(self, settings, stats: dict, graph=None) -> None:
        if not self.dir:
            return
        # per-iteration log, appended to pipeline.log like the reference's
        # viralquasispecies.log concatenation
        with open(os.path.join(self.dir, "pipeline.log"), "a") as f:
            f.write(time.strftime("%c") + "\n\n")
            for field in dataclasses.fields(settings):
                f.write(f"{field.name}: {getattr(settings, field.name)}\n")
            f.write("\nOutput:\n")
            for key, val in stats.items():
                f.write(f"{key}: {val}\n")
            f.write("\n*****************************************\n\n")
        with open(os.path.join(self.dir, "stats.txt"), "a") as f:
            f.write(f"{stats.get('n_reads', 0)}\t{stats.get('n_edges_final', 0)}"
                    f"\t{stats.get('next_overlaps', '.')}\n")
        with open(os.path.join(self.dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        if graph is not None:
            self.write_gfa(graph, "graph_trimmed.gfa")

    def cycles(self, backedges) -> None:
        """Append detected cycle back-edges to cycles.txt (the reference
        reports every back-edge found during cycle removal,
        src/OverlapGraph.cpp:548-562 via GraphAlgos.cpp:536; one
        tab-separated (u, v) pair per line, appended across iterations)."""
        if not self.dir or not backedges:
            return
        with open(os.path.join(self.dir, "cycles.txt"), "a") as f:
            for u, v in sorted(backedges):
                f.write(f"{u}\t{v}\n")

    def write_gfa(self, graph, name: str) -> None:
        if not self.dir:
            return
        from ..core.reads import decode_seq
        from ..io.gfa import write_gfa

        store = graph.store
        vertex_seqs = {}
        for v in range(graph.n):
            if not store.is_paired[v]:
                fwd = bool(graph.vertex_orientations[v])
                u1, _ = store.units_of(v)
                vertex_seqs[v] = decode_seq(store.unit_codes(u1, fwd))
        rows = graph.alive_edges()
        edges = [(int(r["v1"]), int(r["v2"]), int(r["len1"]) + int(r["len2"]))
                 for r in rows]
        write_gfa(os.path.join(self.dir, name), vertex_seqs, edges)
