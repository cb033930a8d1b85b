"""Command-line front-end: ``python -m haploconduct_torch {savage,polyte,
polyte-split,count-strains}``.

The subcommands of the reference CLI with the same arguments. --backend
defaults to auto, the CUDA kernel on the card; without a card auto stops
with an error, and the host engines run when named (--backend native or
numpy). --device (default cuda, or HC_TORCH_DEVICE) says where the torch
backend runs: --device cpu runs its plain versions on the CPU, the only
way it runs there. polyte's --candidates auto re-overlaps contigs with the
torch sort-join when the torch backend runs on a card. Under a process
group (torchrun) savage and polyte-split round-robin their patches or
regions over the ranks and every rank ends with the whole result; rank 0
writes it to -o, rank r > 0 to <-o>/rank<r> (its checkpoints too), so no
two processes write one file.
"""

from __future__ import annotations

import argparse
import os
import sys

from .core.reads import ReadStore, decode_seq
from .parallel import distributed
from .parallel.devices import DEVICE_ENV

BACKENDS = ["torch", "native", "numpy", "auto"]


def _add_device(ap) -> None:
    ap.add_argument("--device", default=os.environ.get(DEVICE_ENV) or "cuda",
                    choices=["cuda", "cpu"],
                    help="where the torch backend runs: the CUDA card, or "
                         f"the CPU ({DEVICE_ENV}=cpu)")


def _parse(ap, argv):
    """Parse argv; --device becomes the process's HC_TORCH_DEVICE, which
    parallel/devices.py:default_devices reads."""
    args = ap.parse_args(argv)
    os.environ[DEVICE_ENV] = args.device
    return args


def _rank_outdir(outdir: str) -> str:
    """The directory this process writes: `outdir`, or `outdir/rank<r>` for
    rank r > 0 of a process group of more than one rank."""
    if distributed.maybe_initialize() and distributed.process_index() > 0:
        return os.path.join(outdir, f"rank{distributed.process_index()}")
    return outdir


def _load_store(args) -> ReadStore:
    if not (args.input_s or (args.input_p1 and args.input_p2)):
        sys.exit("Please enter input fastq file(s) with -s and/or -p1,-p2.")
    if bool(args.input_p1) != bool(args.input_p2):
        sys.exit("For paired-end reads, please enter both -p1 and -p2.")
    return ReadStore.from_files(
        singles=args.input_s, paired1=args.input_p1, paired2=args.input_p2)


def _write_contigs(path: str, store) -> None:
    with open(path, "w") as f:
        for i in range(len(store)):
            seq = decode_seq(store.unit_codes(store.unit1[i]))
            f.write(f">{int(store.ids[i])}\n{seq}\n")


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
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    _add_device(ap)
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler Chrome trace per stage")
    ap.add_argument("--verbose", action="store_true")
    args = _parse(ap, argv)
    args.outdir = _rank_outdir(args.outdir)

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


def cmd_polyte(argv) -> int:
    from .workflows.polyte import PolyteConfig, run_polyte

    ap = argparse.ArgumentParser(prog="haploconduct-torch polyte")
    ap.add_argument("-s", dest="input_s")
    ap.add_argument("-p1", dest="input_p1")
    ap.add_argument("-p2", dest="input_p2")
    ap.add_argument("-m", "--min_overlap_len", type=int, default=50)
    ap.add_argument("-m_EC", "--min_overlap_len_EC", type=int)
    ap.add_argument("--hap_cov", type=float, required=True)
    ap.add_argument("--insert_size", type=float, required=True)
    ap.add_argument("--stddev", type=float, required=True)
    ap.add_argument("-o", "--outdir", default=".")
    ap.add_argument("--no_EC", dest="error_correction", action="store_false")
    ap.add_argument("--mismatch_rate", dest="merge_contigs", type=float, default=0.0)
    ap.add_argument("--min_clique_size", type=int, default=3)
    ap.add_argument("--sfo_err", type=float, default=0.02)
    ap.add_argument("--diploid", action="store_true")
    ap.add_argument("--diploid_contig_len", type=int, default=0)
    ap.add_argument("--diploid_overlap_len", type=int)
    ap.add_argument("--average_read_len", type=float)
    ap.add_argument("--max_tip_len", type=int)
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    ap.add_argument("--candidates", default="auto",
                    choices=["auto", "host", "device"],
                    help="per-iteration re-overlap engine (device = torch sort-join)")
    _add_device(ap)
    ap.add_argument("--verbose", action="store_true")
    args = _parse(ap, argv)

    store = _load_store(args)
    cfg = PolyteConfig(
        hap_cov=args.hap_cov, insert_size=args.insert_size, stddev=args.stddev,
        min_overlap_len=args.min_overlap_len,
        min_overlap_len_EC=args.min_overlap_len_EC,
        merge_contigs=args.merge_contigs, min_clique_size=args.min_clique_size,
        sfo_err=args.sfo_err, error_correction=args.error_correction,
        diploid=args.diploid, diploid_contig_len=args.diploid_contig_len,
        diploid_overlap_len=args.diploid_overlap_len,
        average_read_len=args.average_read_len, max_tip_len=args.max_tip_len,
        backend=args.backend, candidates=args.candidates, verbose=args.verbose,
    )
    res = run_polyte(store, cfg)
    os.makedirs(args.outdir, exist_ok=True)
    if res.store is not None:
        _write_contigs(os.path.join(args.outdir, "contigs.fasta"), res.store)
    if res.diploid_store is not None:
        _write_contigs(os.path.join(args.outdir, "contigs_diploid.fasta"), res.diploid_store)
    print(f"POLYTE assembly completed in {res.iterations} iterations")
    return 0


def cmd_polyte_split(argv) -> int:
    from .workflows.polyte_split import PolyteSplitConfig, run_polyte_split

    ap = argparse.ArgumentParser(prog="haploconduct-torch polyte-split")
    ap.add_argument("-s", dest="input_s")
    ap.add_argument("-p1", dest="input_p1")
    ap.add_argument("-p2", dest="input_p2")
    ap.add_argument("--ref", dest="reference", required=True)
    ap.add_argument("-m", "--min_overlap_len", type=int, default=50)
    ap.add_argument("--hap_cov", type=float, required=True)
    ap.add_argument("--insert_size", type=float, required=True)
    ap.add_argument("--stddev", type=float, required=True)
    ap.add_argument("--split_size", type=int, default=10000)
    ap.add_argument("--split_overlap", type=int, default=1000)
    ap.add_argument("--pool_size", type=int, default=1)
    ap.add_argument("--diploid", action="store_true")
    ap.add_argument("--mismatch_rate", dest="merge_contigs", type=float, default=0.0)
    ap.add_argument("-o", "--outdir", default=".")
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    _add_device(ap)
    args = _parse(ap, argv)
    args.outdir = _rank_outdir(args.outdir)
    store = _load_store(args)
    cfg = PolyteSplitConfig(
        hap_cov=args.hap_cov, insert_size=args.insert_size, stddev=args.stddev,
        reference=args.reference, min_overlap_len=args.min_overlap_len,
        split_size=args.split_size, split_overlap=args.split_overlap,
        pool_size=args.pool_size,
        diploid=args.diploid, merge_contigs=args.merge_contigs,
        backend=args.backend)
    res = run_polyte_split(store, cfg)
    os.makedirs(args.outdir, exist_ok=True)
    final = res.final.diploid_store if (args.diploid and res.final
                                        and res.final.diploid_store) else (
        res.final.store if res.final else None)
    if final is not None:
        _write_contigs(os.path.join(args.outdir, "contigs.fasta"), final)
    for region, err in res.failed_regions:
        print(f"polyte-split: region {region} failed: {err}", file=sys.stderr)
    print(f"polyte-split completed: {len(res.regions)} regions")
    return 0


def cmd_count_strains(argv) -> int:
    from .io.fastq import read_fasta
    from .workflows.strain_count import strain_count_from_contigs

    ap = argparse.ArgumentParser(prog="haploconduct-torch count-strains")
    ap.add_argument("--contigs", required=True, help="contig fasta/fastq")
    ap.add_argument("--ref", dest="reference", required=True)
    args = ap.parse_args(argv)
    store = ReadStore()
    if args.contigs.endswith("a"):
        ids, seqs = read_fasta(args.contigs)
        for i, seq in enumerate(seqs):
            store.add_single(i, seq, "I" * len(seq))
    else:
        store = ReadStore.from_files(singles=args.contigs)
    store.readcount_single = len(store.ids)
    count = strain_count_from_contigs(store, args.reference)
    print(f"The estimated number of strains in this sample is {count}.")
    return 0


USAGE = """HaploConduct on PyTorch/CUDA: haplotype-aware genome assembly.

usage: haploconduct-torch <command> [options]

commands:
    savage         assembly of viral quasispecies (ultra-deep coverage)
    polyte         assembly of diploid/polyploid haplotigs (low coverage)
    polyte-split   large-genome (>100kb) reference-binned POLYTE
    count-strains  lower bound on the number of strains in a sample

Run haploconduct-torch <command> -h for command options.
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    commands = {"savage": cmd_savage, "polyte": cmd_polyte,
                "polyte-split": cmd_polyte_split, "polyte_split": cmd_polyte_split,
                "count-strains": cmd_count_strains, "count_strains": cmd_count_strains}
    if cmd not in commands:
        print(USAGE)
        return 1
    try:
        return commands[cmd](rest)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
