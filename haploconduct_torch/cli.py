"""Command-line front-end: ``python -m haploconduct_torch savage``.

The savage subcommand of haploconduct_tpu/cli.py with the same arguments,
run through the port. --backend defaults to auto: the CUDA kernel when a
card is present, the native host engine otherwise. The POLYTE commands
are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

from haploconduct_tpu.cli import _load_store, _write_contigs


def cmd_savage(argv) -> int:
    from .workflows.savage import SavageConfig, run_savage

    ap = argparse.ArgumentParser(prog="haploconduct-torch savage")
    ap.add_argument("-s", dest="input_s")
    ap.add_argument("-p1", dest="input_p1")
    ap.add_argument("-p2", dest="input_p2")
    ap.add_argument("-m", "--min_overlap_len", type=int, default=None)
    ap.add_argument("--split", dest="split_num", type=int, required=True)
    ap.add_argument("--revcomp", action="store_true")
    ap.add_argument("-o", "--outdir", default=".")
    ap.add_argument("--no_stage_b", dest="stage_b", action="store_false")
    ap.add_argument("--no_stage_c", dest="stage_c", action="store_false")
    ap.add_argument("--merge_contigs", type=float, default=0.0)
    ap.add_argument("--min_clique_size", type=int, default=4)
    ap.add_argument("--overlap_len_stage_c", type=int, default=100)
    ap.add_argument("--contig_len_stage_c", type=int, default=100)
    ap.add_argument("--keep_branches", dest="remove_branches", action="store_false")
    ap.add_argument("--sfo_mm", type=int, default=50)
    ap.add_argument("--diploid", action="store_true")
    ap.add_argument("--average_read_len", type=float)
    ap.add_argument("--max_tip_len", type=int)
    ap.add_argument("--ignore_subreads", dest="use_subreads", action="store_false")
    ap.add_argument("--no_filtering", dest="filtering", action="store_false")
    ap.add_argument("--resume", action="store_true",
                    help="reuse completed stage checkpoints in the output dir")
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "native", "numpy", "auto"])
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler Chrome trace per stage")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    store = _load_store(args)
    cfg = SavageConfig(
        min_overlap_len=args.min_overlap_len, split_num=args.split_num,
        revcomp=args.revcomp, merge_contigs=args.merge_contigs,
        min_clique_size=args.min_clique_size,
        overlap_len_stage_c=args.overlap_len_stage_c,
        contig_len_stage_c=args.contig_len_stage_c,
        remove_branches=args.remove_branches, sfo_mm=args.sfo_mm,
        filtering=args.filtering,
        diploid=args.diploid, average_read_len=args.average_read_len,
        max_tip_len=args.max_tip_len, use_subreads=args.use_subreads,
        stage_b=args.stage_b, stage_c=args.stage_c,
        output_dir=args.outdir, resume=args.resume,
        backend=args.backend, profile_dir=args.profile_dir,
        verbose=args.verbose,
    )
    res = run_savage(store, cfg)
    os.makedirs(args.outdir, exist_ok=True)
    if res.combined_store is not None:
        _write_contigs(os.path.join(args.outdir, "contigs_stage_a.fasta"), res.combined_store)
    for stage in ("b", "c"):
        sres = getattr(res, f"stage_{stage}")
        if sres is not None:
            _write_contigs(os.path.join(args.outdir, f"contigs_stage_{stage}.fasta"), sres.store)
    if res.diploid is not None:
        _write_contigs(os.path.join(args.outdir, "diploid_contigs.fasta"), res.diploid.store)
    for name, fr in res.frequencies.items():
        with open(os.path.join(args.outdir, f"frequencies_{name}.txt"), "w") as f:
            f.write(fr.table())
    final = "diploid_contigs.fasta" if res.diploid else (
        "contigs_stage_c.fasta" if res.stage_c else (
            "contigs_stage_b.fasta" if res.stage_b else "contigs_stage_a.fasta"))
    print(f"SAVAGE assembly completed, final contigs: {os.path.join(args.outdir, final)}")
    return 0


USAGE = """HaploConduct on PyTorch/CUDA: haplotype-aware genome assembly.

usage: haploconduct-torch <command> [options]

commands:
    savage         assembly of viral quasispecies (ultra-deep coverage)

Run haploconduct-torch <command> -h for command options.
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    if argv[0] == "savage":
        return cmd_savage(argv[1:])
    print(USAGE)
    return 1


if __name__ == "__main__":
    sys.exit(main())
