"""What the assembly drivers share: units drawn from the seed during
set-up, one warm-up unit of the cell's own path, the window's units with
every verify call and every contig kept for the judge, and the judge."""

from __future__ import annotations

import gc
from typing import List

from . import hooks, judge
from .simulate import draw_unit


def unit_store(unit):
    """The program's read store of a unit, as its fastq files would load:
    single-end reads 0..N-1 in the order drawn, or pairs 0..P-1 of mate 1
    and mate 2. The store gets copies, so that nothing the program does to
    its arrays reaches the reads the reference judges by."""
    from haploconduct_torch.core.reads import ReadStore

    store = ReadStore()
    if unit.pairs:
        p = unit.pairs
        for i in range(p):
            (c1, q1), (c2, q2) = unit.reads[i], unit.reads[p + i]
            store.add_paired_codes(i, c1.copy(), q1.copy(), c2.copy(), q2.copy())
        store.readcount_single = 0
    else:
        for i, (c, q) in enumerate(unit.reads):
            store.add_single_codes(i, c.copy(), q.copy())
        store.readcount_single = len(unit.reads)
    return store


def warmup_shapes(ctx) -> dict:
    """The warm-up unit's shapes: the configuration's, on the genome length
    the cell gives for it (a shorter genome runs the same code, kernels and
    widths in less set-up)."""
    return dict(ctx.config["shapes"],
                genome_len=int(ctx.cell.get("warmup_genome_len",
                                            ctx.config["shapes"]["genome_len"])))


class AssemblyDriver:
    """A unit is one whole assembly. Subclasses give `assemble(store)`,
    which returns ([(contig store, subreads), ...], timings dict)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.shapes = ctx.config["shapes"]
        self.capture = hooks.VerifyCapture(ctx.patches)
        self.window: List[dict] = []
        self.timings = {}

    def assemble(self, store):
        raise NotImplementedError

    def setup(self):
        seed, stream = self.ctx.seed, self.ctx.cell["stream"]
        pool = int(self.ctx.cell["pool"])
        self.pool = []
        for k in range(pool):
            unit = draw_unit(seed, stream, k, self.shapes)
            self.pool.append((unit, unit_store(unit)))
        self.assemble(unit_store(draw_unit(seed, stream + "-warmup", 0,
                                           warmup_shapes(self.ctx))))
        self.capture.tasks = 0
        self.timings = {}

    def run_unit(self, k: int):
        unit, store = self.pool[k % len(self.pool)]
        self.capture.keep = True
        try:
            contig_sets, timings = self.assemble(store)
        finally:
            self.capture.keep = False
            calls = self.capture.take()
        for key, v in timings.items():
            self.timings[key] = self.timings.get(key, 0.0) + v
        self.window.append({"unit": unit, "calls": calls, "contigs": contig_sets})

    def work(self) -> dict:
        return {"reads": sum(len(u["unit"].reads) for u in self.window),
                "tasks": self.capture.tasks, "units": len(self.window)}

    def extra(self) -> dict:
        return {"timings": dict(self.timings)}

    def release(self):
        self.pool = []  # the window's units stay with the window
        gc.collect()

    def judge(self, control: bool = False, faults: bool = False) -> dict:
        """The window's readings; with `control`, the verify calls' readings
        of the float32 reference in the program's place; with `faults`,
        also the contig numbers of each fault of judge.CONTIG_FAULTS."""
        readings = []
        contig_units = []
        for entry in self.window:
            unit = entry["unit"]
            raw, raw_ids = hooks.raw_units(unit.reads)
            for j, (store, ov, s, res) in enumerate(entry["calls"]):
                if j == 0 and len(store) == len(raw):
                    units, ids = raw, raw_ids  # iteration 1: the drawn reads
                else:
                    units, ids = hooks.store_units(store)  # the program's state
                call = hooks.extract_call(units, ids, ov, s, res)
                readings.append(judge.judge_call(call, self.ctx.device, control))
            contig_units.append({"haps": unit.haps, "sets": [
                hooks.extract_contigs(store, sub, raw)
                for store, sub in entry["contigs"] if store is not None]})
        out = judge.merge(readings)
        if not control:
            out.update(judge.judge_contigs(contig_units))
        if faults:
            out["faults"] = judge.contig_fault_readings(contig_units)
        return out
