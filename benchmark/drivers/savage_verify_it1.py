"""A unit is one iteration-1 verification call of SAVAGE's stage a:
ops/verify.verify_overlaps(store, packed, candidates, settings) with
backend "torch", on a patch's candidates as stage a computes them (the
host k-mer engine, then the length filter of assemble/iteration.py).

Set-up takes the iteration-1 settings from a stage-a run on a small
warm-up patch stopped at its first verification, draws `pool` patches,
computes each one's candidates and packs its reads (the work stage a does
before it verifies), verifies every patch once, and reads the scoring kernel's
least time for each patch's tasks (benchlib/roofline.py). The window
verifies the patches in turn, so consecutive calls never share reads.
The judge compares every task of `judged_calls` calls drawn from the seed
(a reservoir sample over the window's calls)."""

import gc

from benchlib import hooks, judge, roofline
from benchlib.assembly import unit_store, warmup_shapes
from benchlib.simulate import draw_unit, unit_rng


class _Stop(Exception):
    pass


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.shapes = ctx.config["shapes"]
        self.tasks = 0
        self.units = 0
        self.kept = []
        self.seen = 0
        self.rng = unit_rng(ctx.seed, ctx.cell["stream"] + "-judge", 0)

    def _iteration1_settings(self, store):
        """The settings of stage a's first verification, as run_savage sets
        them, read from a run stopped at that call."""
        patches = hooks.Patches()
        got = {}

        def make(fn):
            def call(store, packed, ov, s):
                got["s"] = s
                raise _Stop()
            return call

        patches.wrap(hooks.VerifyCapture.TARGET, make)
        try:
            from haploconduct_torch.workflows.savage import SavageConfig, run_savage

            run_savage(store, SavageConfig(**self.ctx.config["savage"]))
        except _Stop:
            pass
        finally:
            patches.restore()
        return got["s"]

    def setup(self):
        from haploconduct_torch.assemble.iteration import length_prefilter
        from haploconduct_torch.ops.verify import verify_overlaps
        from haploconduct_torch.workflows.savage import denovo_candidates

        seed, stream = self.ctx.seed, self.ctx.cell["stream"]
        warm = draw_unit(seed, stream + "-warmup", 0, warmup_shapes(self.ctx))
        self.settings = s = self._iteration1_settings(unit_store(warm))
        cand = self.ctx.config["candidates"]
        self.pool = []
        for k in range(int(self.ctx.cell["pool"])):
            unit = draw_unit(seed, stream, k, self.shapes)
            store = unit_store(unit)
            ov = denovo_candidates(store, cand["min_overlap_len"], cand["sfo_mm"], cand["k"])
            scored, _ = length_prefilter(ov, s)
            self.pool.append({"reads": unit.reads, "store": store,
                              "packed": store.pack(), "ov": ov[scored]})
        # warm every patch's shapes, and read each one's least kernel time
        bounds = hooks.Patches()

        def make(fn):
            def call(codes, quals, lens_by_row, row_a, row_b, pos, **kw):
                self._bound = roofline.score_bound(lens_by_row, row_a, row_b, pos)
                return fn(codes, quals, lens_by_row, row_a, row_b, pos, **kw)
            return call

        bounds.wrap("haploconduct_torch.ops.verify:score_tasks_torch", make)
        try:
            for p in self.pool:
                verify_overlaps(p["store"], p["packed"], p["ov"], s)
                p["bound_ms"], p["bound_kind"] = self._bound
        finally:
            bounds.restore()

    def run_unit(self, k: int):
        from haploconduct_torch.ops.verify import verify_overlaps

        p = self.pool[k % len(self.pool)]
        res = verify_overlaps(p["store"], p["packed"], p["ov"], self.settings)
        self.tasks += int(res.n_tasks)
        self.units += 1
        # reservoir sample of the window's calls, drawn from the seed
        n_keep = int(self.ctx.cell["judged_calls"])
        if len(self.kept) < n_keep:
            self.kept.append((k, res))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < n_keep:
                self.kept[j] = (k, res)
        self.seen += 1

    def work(self) -> dict:
        return {"reads": 0, "tasks": self.tasks, "units": self.units}

    def extra(self) -> dict:
        n = len(self.pool)
        return {"bound_ms": float(sum(self.pool[k % n]["bound_ms"] for k in range(self.units))),
                "bound_kinds": sorted({p["bound_kind"] for p in self.pool})}

    def release(self):
        for p in self.pool:
            p.pop("packed", None)
        gc.collect()

    def judge(self, control: bool = False, faults: bool = False) -> dict:
        readings = []
        for k, res in self.kept:
            p = self.pool[k % len(self.pool)]
            units, ids = hooks.raw_units(p["reads"])
            call = hooks.extract_call(units, ids, p["ov"], self.settings, res)
            readings.append(judge.judge_call(call, self.ctx.device, control))
        return judge.merge(readings)
