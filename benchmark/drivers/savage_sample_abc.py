"""A unit is SAVAGE a -> b -> c with the abundance filter on one whole
sample, as a job of one rank a card runs it: every rank calls
workflows/savage.run_savage(store, SavageConfig(split_num=4,
backend="torch", min_clique_size=4)) on the same sample, in one process
group (NCCL, one card a rank; benchlib/ranks.py). The program deals the
patches round-robin to the ranks for stage a, gathers their contigs to
every rank, and runs stages b and c on every rank with their verification
sharded over the cards.

This process is rank 0 on card 0, and its spans, phases and device trace
are the run's; ranks 1-3 are its children. Judged: every verify call of
rank 0 (its own patch's, and each of stages b and c with the whole
gathered stream) and rank 0's final stage-c contigs against the sample's
reads and haplotypes; ranks 1-3's own patches only through the contigs,
and every rank through the SHA-256 of its final contigs against rank 0's
(`rank_disagreements`: the (sample, rank) pairs that differ).
"""

import torch

from benchlib import ranks
from benchlib.assembly import AssemblyDriver, unit_store
from benchlib.simulate import draw_unit


def sample_shapes(config) -> dict:
    """The configuration's shapes with the sample's coverage: its patches'
    coverage times their number."""
    shapes = dict(config["shapes"])
    shapes["coverage"] = shapes["patch_coverage"] * shapes["n_patches"]
    return shapes


def run_sample(store, options):
    """run_savage on one sample, as every rank runs it: ((final contigs,
    their subreads), timings). No stage-c contigs give (None, None)."""
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    res = run_savage(store, SavageConfig(**options))
    final = (res.stage_c.store, res.stage_c.subreads) if res.stage_c else (None, None)
    return final, dict(res.timings)


def gather_stats() -> dict:
    """The program's counts of its gathers across ranks, where it keeps
    them (nothing where it does not)."""
    from haploconduct_torch.parallel import distributed, mesh

    out = {}
    for name, module in (("distributed", distributed), ("mesh", mesh)):
        stats = getattr(module, "GATHER_STATS", None)
        if isinstance(stats, dict):
            out[name] = dict(stats)
    return out


def disagreements(window) -> int:
    return sum(reply["sha256"] != entry["sha256"]
               for entry in window for reply in entry["ranks"])


class Driver(AssemblyDriver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.shapes = sample_shapes(ctx.config)
        self.world = int(ctx.entry["chips"])
        self.threads = ranks.rank_threads(self.world)

    def setup(self):
        seed, stream = self.ctx.seed, self.ctx.cell["stream"]
        warm = dict(self.shapes, genome_len=int(self.ctx.cell["warmup_genome_len"]))
        options = self.ctx.config["savage"]
        self.threads_before = torch.get_num_threads()
        torch.set_num_threads(self.threads)
        self.ranks = ranks.Ranks(
            {"driver": self.ctx.cell["driver"], "seed": seed, "stream": stream,
             "pool": int(self.ctx.cell["pool"]), "shapes": self.shapes,
             "warmup_shapes": warm, "options": options}, self.world, self.threads)
        self.ranks.start(self.ctx.device)
        try:
            self.pool = []
            for k in range(int(self.ctx.cell["pool"])):
                unit = draw_unit(seed, stream, k, self.shapes)
                self.pool.append((unit, unit_store(unit)))
            self.ranks.send({"op": "warmup"})
            self.assemble(unit_store(draw_unit(seed, stream + "-warmup", 0, warm)))
            self.ranks.collect()
        except Exception:
            self.ranks.fail("the warm-up sample failed")
        self.capture.tasks = 0
        self.timings = {}
        self.stats_before = gather_stats()

    def assemble(self, store):
        final, self.last_timings = run_sample(store, self.ctx.config["savage"])
        return [final], self.last_timings

    def run_unit(self, k: int):
        self.ranks.send({"op": "unit", "k": k % len(self.pool)})
        try:
            super().run_unit(k)
        except Exception:
            self.ranks.fail(f"sample {k} failed on rank 0")
        entry = self.window[-1]
        entry["ranks"] = self.ranks.collect()
        entry["sha256"] = ranks.contig_digest(*entry["contigs"][0])
        entry["stage_a_s"] = self.last_timings.get("stage_a_s")
        entry["peak_bytes"] = ranks.peak_bytes(self.ctx.device)

    def by_rank(self) -> dict:
        """Each rank's stage-a seconds a sample and its peak device memory,
        in rank order."""
        return {"stage_a_s": [[e["stage_a_s"] for e in self.window]] + [
                    [e["ranks"][r]["timings"].get("stage_a_s") for e in self.window]
                    for r in range(self.world - 1)],
                "peak_bytes": [max((e["peak_bytes"] for e in self.window), default=0)] + [
                    max((e["ranks"][r]["peak_bytes"] for e in self.window), default=0)
                    for r in range(self.world - 1)]}

    def extra(self) -> dict:
        after = gather_stats()
        return {"timings": dict(self.timings), "by_rank": self.by_rank(),
                "gather_stats": {name: {k: v - self.stats_before[name].get(k, 0)
                                        for k, v in stats.items()}
                                 for name, stats in after.items()},
                "threads_a_rank": self.threads}

    def release(self):
        self.ranks.stop()
        torch.set_num_threads(self.threads_before)
        super().release()

    def judge(self, control: bool = False, faults: bool = False) -> dict:
        out = super().judge(control, faults)
        if control:
            return out
        out["rank_disagreements"] = disagreements(self.window)
        out["sample_sha256"] = [e["sha256"] for e in self.window]
        # not compared: what the result line would otherwise not show
        out["by_rank"] = self.by_rank()
        out["timings"] = self.timings
        if faults:
            # one rank's contigs changed in every sample
            changed = [dict(e, ranks=[dict(e["ranks"][0], sha256="0" * 64)] + e["ranks"][1:])
                       for e in self.window]
            out["faults"]["rank_contigs_changed"] = {
                "rank_disagreements": disagreements(changed)}
        return out
