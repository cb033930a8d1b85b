"""A unit is POLYTE on one diploid sample, as users run it:
workflows/polyte.run_polyte(store, PolyteConfig(..., backend="torch"))
with the default candidate engine ("auto": the card's join for the exact
passes). The contigs judged are the haplotigs and, with diploid=True, the
diploid round's contigs, each with their reads."""

from benchlib.assembly import AssemblyDriver


class Driver(AssemblyDriver):
    def assemble(self, store):
        from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte

        res = run_polyte(store, PolyteConfig(**self.ctx.config["polyte"]))
        return [(res.store, res.subreads),
                (res.diploid_store, res.diploid_subreads)], {}
