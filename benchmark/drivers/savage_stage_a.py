"""A unit is SAVAGE's stage a on one patch, as users run it:
workflows/savage.run_savage(store, SavageConfig(split_num=1,
stage_b=False, stage_c=False, backend="torch", ...)). The contigs judged
are the patch's stage-a contigs with their reads."""

from benchlib.assembly import AssemblyDriver


class Driver(AssemblyDriver):
    def assemble(self, store):
        from haploconduct_torch.workflows.savage import SavageConfig, run_savage

        res = run_savage(store, SavageConfig(**self.ctx.config["savage"]))
        return [(res.combined_store, res.combined_subreads)], dict(res.timings)
