#!/usr/bin/env python3
"""The card's k-mer sort-join against the host k-mer engine, on
haploconduct_torch: the twin of tools/cand_device_vs_host.py.

    python3 torch_cands.py [--workloads synthetic10x,savage_patch,
                            polyte_reads_exact,polyte_passes]
                           [--runs 3] [--device cpu] [--genome-len 50000]

The host engine is ops/kmer.py:find_overlap_candidates (k=20, native
OpenMP join); the join is ops/kmer_device.py:find_overlap_candidates_device
(k=15, at most `expand` = 32 entries of a hash group taken, groups above
`max_group` = 512 dropped), on the card unless --device cpu (or
HC_TORCH_DEVICE=cpu) asks for its torch ops on the CPU; without a card and
without that request it raises. Every input is drawn in the process with
the port's copy of the repo's simulator (haploconduct_torch/utils/
simulate.py).

Workloads (all by default):
- synthetic10x: the tool's second workload, drawn as tools/
  profile_stage.py:33-48 draws it (seed 0: a 10 kb genome and one mutant
  at 1%, 22,000 reads of 150 bp at 0.2% error), min_ov 90, error_rate
  0.01; the host engine with its automatic subsampling, the join with
  verify=False, as the tool calls them.
- savage_patch: patch 0 of the SAVAGE envelope
  (torch_envelope.savage_envelope_store split by workflows/savage.py:
  split_into_patches, 44,464 reads at ~667x), the sequences and parameters
  workflows/savage.py:denovo_candidates gives the host engine: min_ov
  0.6 x 150 = 90, error_rate 1/sfo_mm = 0.02, verify=False.
- polyte_reads_exact: POLYTE diploid's 13,332 reads
  (torch_envelope.polyte_diploid_store) at an exact pass: min_ov = mol_ec
  (77), error_rate 0, verify=True; the host engine under POLYTE's seed rule
  (subsampled above 1,500 sequences, workflows/polyte.py:
  single_end_candidates).
- polyte_passes: POLYTE diploid run once with candidates="host"; every call
  of workflows/polyte.py:single_end_candidates is captured by a wrapper,
  and each captured pass runs both engines under its own parameters and
  POLYTE's seed rule (verify=True). One line a pass (its iteration, the
  engine workflows/polyte.py:_resolve_engine would pick on a card), then a
  summary line: the passes whose two sets differ, the first of them, and
  the candidates it gains and loses.

Each workload's line carries the tool's fields under its names (workload,
n_seqs, host_s, host_candidates, device_s, device_candidates,
device_recall_vs_host = |H & D| / |H|, device_extra = |D - H|; the sets
keyed on (ida, idb, oha, ori)), and adds: the complete k=20 set (the host
engine at subsample=1: full_candidates, host_recall_vs_full,
device_recall_vs_full, device_extra_vs_full), the 15-mer groups of the
join's table larger than `expand` and than `max_group` (counted with
ops/kmer_device.py:kmer_hashes and kmer_table, outside the engine), every
timed run's seconds (host_s and device_s are their medians; each engine
runs once untimed first, then --runs times, host and join in turns; the
complete set once), and the card's name and power limit. The join's
seconds include the copy of its candidates back to the host, as the host
engine's include its output.

Exit status 1 when a check fails: an engine's set differs between its
untimed and its timed runs, a join candidate missing from the complete set
fails ops/kmer.py's verification at the workload's error rate (verify=True
workloads), or a field is not finite. The failed checks are in the line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import numpy as np

WORKLOADS = ("synthetic10x", "savage_patch", "polyte_reads_exact", "polyte_passes")
HOST_K = 20
# find_overlap_candidates_device's defaults, as the tool and POLYTE call it
JOIN = dict(k=15, expand=32, max_group=512)
# workflows/polyte.py:single_end_candidates subsamples the host engine's
# seeds above this many sequences
POLYTE_FULL_SEEDS_UP_TO = 1500


def sfo_key_set(sfo):
    """The tool's candidate key: (ida, idb, oha, ori)."""
    return set(zip(sfo["ida"].tolist(), sfo["idb"].tolist(),
                   sfo["oha"].tolist(), sfo["ori"].tolist()))


def row_keys(sfo) -> np.ndarray:
    """sfo_key_set's key of each row, packed into one int64 by
    ops/kmer.py:_pack_keys (one to one for ids below 2^19 and |oha| below
    2^23, which the host engine asserts): sets of millions of candidates
    are compared as sorted arrays."""
    from haploconduct_torch.ops.kmer import _pack_keys

    return _pack_keys(sfo["ida"].astype(np.int64), sfo["idb"].astype(np.int64),
                      sfo["oha"].astype(np.int64),
                      (sfo["ori"] == b"I").astype(np.int64))


def sfo_keys(sfo) -> np.ndarray:
    """The packed keys of sfo_key_set(sfo), sorted."""
    return np.unique(row_keys(sfo))


def recall(want: np.ndarray, got: np.ndarray) -> float:
    """|want & got| / |want| of two sfo_keys (the tool's
    device_recall_vs_host, unrounded)."""
    return len(np.intersect1d(want, got, assume_unique=True)) / max(len(want), 1)


def extra(got: np.ndarray, want: np.ndarray) -> int:
    """|got - want| of two sfo_keys (the tool's device_extra)."""
    return len(np.setdiff1d(got, want, assume_unique=True))


def polyte_subsample(n: int):
    """POLYTE's seed rule for the host engine: automatic above 1,500
    sequences, every seed below."""
    return None if n > POLYTE_FULL_SEEDS_UP_TO else 1


# ---------------------------------------------------------------- inputs


def store_seqs(store):
    """A single-end store's sequences by position, as
    workflows/polyte.py:single_end_candidates takes them."""
    return [store.unit_codes(store.unit1[i]) for i in range(len(store))]


def synthetic_seqs(scale: int = 10):
    """tools/profile_stage.py:33-48's reads (seed 0): a 10 kb genome and a
    mutant at 1%, 2,200 x `scale` reads of 150 bp at 0.2% error."""
    from haploconduct_torch.utils.simulate import (mutate_sequence,
                                                   random_genome,
                                                   simulate_reads)
    from torch_envelope import single_end_store

    rng = np.random.default_rng(0)
    genome = random_genome(rng, 10000)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.01)]
    n_reads, read_len = 2200 * scale, 150
    coverage = n_reads * read_len / (2 * len(genome))
    seqs, quals = simulate_reads(haps, coverage=coverage, read_len=read_len,
                                 rng=rng, error_rate=0.002)
    store = single_end_store(seqs, quals)
    return [store.unit_codes(u) for u in range(store.n_units)]


def savage_patch_input():
    """Patch 0 of the SAVAGE envelope as workflows/savage.py:run_savage
    hands it to denovo_candidates: (seqs, min_ov, error_rate)."""
    from haploconduct_torch.workflows.savage import (SavageConfig,
                                                     split_into_patches)
    from torch_envelope import savage_envelope_store

    cfg = SavageConfig(split_num=15)
    store, _ = savage_envelope_store(split_num=cfg.split_num)
    patch, _ = split_into_patches(store, cfg.split_num, cfg.revcomp)[0]
    assert len(patch) == patch.readcount_single  # singles: sfo_len = min_ov
    seqs = store_seqs(patch)
    avg_len = sum(store.unit_len(u) for u in range(store.n_units)) / store.n_units
    return seqs, int(round(0.6 * avg_len)), 1.0 / cfg.sfo_mm


# ---------------------------------------------------------------- engines


def group_counts(seqs, device) -> dict:
    """The join's forward 15-mer table (ops/kmer_device.py:kmer_hashes,
    kmer_table): its hash groups, those larger than `expand` and than
    `max_group` (which the join drops), and the k-mers in the latter."""
    import torch

    from haploconduct_torch.core.reads import PAD_CODE
    from haploconduct_torch.ops.kmer_device import (INT32_MAX, kmer_hashes,
                                                    kmer_table)

    w = max(len(s) for s in seqs)
    codes = np.full((len(seqs), w), PAD_CODE, np.int8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = s
    h = kmer_hashes(torch.from_numpy(codes).to(device), JOIN["k"]).reshape(-1)
    tkey, _, _ = kmer_table(h, w - JOIN["k"] + 1)
    _, sizes = torch.unique_consecutive(tkey[tkey != INT32_MAX], return_counts=True)
    dropped = sizes > JOIN["max_group"]
    return {"groups": int(sizes.numel()),
            "groups_over_expand": int((sizes > JOIN["expand"]).sum()),
            "groups_over_max_group": int(dropped.sum()),
            "kmers_in_groups_over_max_group": int(sizes[dropped].sum())}


def non_finite(line: dict) -> list:
    bad = []
    for key, value in line.items():
        values = value if isinstance(value, list) else [value]
        if any(isinstance(v, float) and not math.isfinite(v) for v in values):
            bad.append(key)
    return bad


def run_workload(name, seqs, min_ov, error_rate, verify, device, runs=3,
                 host_subsample=None, card=None, **fields) -> dict:
    """Both engines and the complete set on `seqs`; the workload's line
    (`fields` go in after `workload`). host_subsample None: the host
    engine's automatic modulus."""
    from haploconduct_torch.native import load_kmerjoin_ext
    from haploconduct_torch.ops.kmer import (_verify_candidates,
                                             auto_subsample,
                                             find_overlap_candidates)
    from haploconduct_torch.ops.kmer_device import find_overlap_candidates_device

    def host(subsample):
        return find_overlap_candidates(seqs, min_overlap_len=min_ov, k=HOST_K,
                                       error_rate=error_rate, verify=verify,
                                       subsample=subsample)

    def join():
        return find_overlap_candidates_device(seqs, min_overlap_len=min_ov,
                                              error_rate=error_rate, verify=verify,
                                              device=device, **JOIN)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    failed = []
    engines = {"host": (host, (host_subsample,)), "device": (join, ())}
    first = {e: sfo_keys(fn(*args)) for e, (fn, args) in engines.items()}
    samples = {e: [] for e in engines}
    sfo = {}
    for _ in range(runs):
        for e, (fn, args) in engines.items():
            sfo[e], dt = timed(fn, *args)
            samples[e].append(dt)
            if not np.array_equal(sfo_keys(sfo[e]), first[e]):
                failed.append(f"{e}_set_not_deterministic")
    full, full_s = timed(host, 1)
    hs, ds, fs = first["host"], first["device"], sfo_keys(full)

    line = {"workload": name, **fields, "n_seqs": len(seqs), "min_ov": min_ov,
            "error_rate": error_rate, "verify": verify, "host_k": HOST_K,
            "host_subsample": (auto_subsample(min_ov, HOST_K, error_rate)
                               if host_subsample is None else host_subsample),
            "host_native": load_kmerjoin_ext() is not None, "join": dict(JOIN),
            "host_s": statistics.median(samples["host"]),
            "host_s_samples": samples["host"],
            "host_candidates": len(sfo["host"]),
            "device_s": statistics.median(samples["device"]),
            "device_s_samples": samples["device"],
            "device_candidates": len(sfo["device"]),
            "device_recall_vs_host": recall(hs, ds),
            "device_extra": extra(ds, hs),
            "device_missing": extra(hs, ds),
            "full_s": full_s,
            "full_candidates": len(full),
            "host_recall_vs_full": recall(fs, hs),
            "device_recall_vs_full": recall(fs, ds),
            "device_extra_vs_full": extra(ds, fs)}
    if verify and line["device_extra_vs_full"]:
        outside = sfo["device"][~np.isin(row_keys(sfo["device"]), fs)]
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        line["device_extra_vs_full_verified"] = len(
            _verify_candidates(seqs, lens, outside, error_rate))
        if line["device_extra_vs_full_verified"] != len(outside):
            failed.append("device_extra_vs_full_fails_verification")
    line.update(group_counts(seqs, device))
    line["device"] = str(device)
    line["card"] = card
    failed += [f"not_finite:{k}" for k in non_finite(line)]
    line["checks_failed"] = failed
    # for the passes' summary; not printed
    line["_keys"], line["_sfo"] = (hs, ds, fs), (sfo["host"], sfo["device"])
    return line


# ---------------------------------------------------------------- POLYTE's passes


def capture_passes(store, cfg):
    """Run POLYTE on `store` with every call of single_end_candidates
    captured (the module's name is wrapped for the run and restored):
    (result, [pass dicts: iteration, caller, seqs, min_ov, sfo_err])."""
    from haploconduct_torch.workflows import polyte

    passes = []
    original = polyte.single_end_candidates

    def wrapped(store, min_overlap_len, sfo_err, k=20, engine="host"):
        frame = sys._getframe(1)
        loops = [v for v in frame.f_locals.values()
                 if isinstance(v, polyte._AssemblyLoop)]
        caller = ("reoverlap" if frame.f_code.co_name == "step"
                  else "diploid" if loops else "first")
        passes.append({"iteration": loops[0].iteration if loops else 0,
                       "caller": caller,
                       "seqs": [s.copy() for s in store_seqs(store)],
                       "min_ov": min_overlap_len, "sfo_err": sfo_err})
        return original(store, min_overlap_len, sfo_err, k, engine)

    polyte.single_end_candidates = wrapped
    try:
        res = polyte.run_polyte(store, cfg)
    finally:
        polyte.single_end_candidates = original
    return res, passes


def pass_delta(line) -> dict:
    """What the join gains and loses against the host set of one pass, how
    many of each the complete set holds, and the first ten of each."""
    hs, ds, fs = line["_keys"]
    gains, losses = np.setdiff1d(ds, hs), np.setdiff1d(hs, ds)
    host_set, device_set = (sfo_key_set(x) for x in line["_sfo"])
    return {"pass": line["pass"], "iteration": line["iteration"],
            "caller": line["caller"], "n_seqs": line["n_seqs"],
            "engine_on_card": line["engine_on_card"],
            "gains": len(gains), "gains_in_full": len(np.intersect1d(gains, fs)),
            "losses": len(losses), "losses_in_full": len(np.intersect1d(losses, fs)),
            "gained": [printable(c) for c in sorted(device_set - host_set)[:10]],
            "lost": [printable(c) for c in sorted(host_set - device_set)[:10]]}


def printable(key):
    """A candidate key with its orientation as text."""
    return [*key[:3], key[3].decode()]


def polyte_passes(device, runs, genome_len, card):
    """POLYTE diploid with the host engine; both engines on every pass."""
    from haploconduct_torch.workflows.polyte import (PolyteConfig,
                                                     _device_candidates_ok)
    from torch_envelope import POLYTE_CONFIG, contig_digest, polyte_diploid_store

    store, _ = polyte_diploid_store(genome_len)
    t0 = time.perf_counter()
    res, passes = capture_passes(store, PolyteConfig(
        backend="torch", candidates="host", **POLYTE_CONFIG))
    wall = time.perf_counter() - t0
    lines = []
    for i, p in enumerate(passes):
        n = len(p["seqs"])
        engine = ("device" if _device_candidates_ok(p["min_ov"], p["sfo_err"], n)
                  else "host")
        line = run_workload("polyte_passes", p["seqs"], p["min_ov"], p["sfo_err"],
                            True, device, runs, polyte_subsample(n), card,
                            **{"pass": i, "iteration": p["iteration"],
                               "caller": p["caller"], "sfo_err": p["sfo_err"],
                               "engine_on_card": engine})
        lines.append(print_line(line))
    differ = [pass_delta(x) for x in lines
              if not np.array_equal(x["_keys"][0], x["_keys"][1])]
    on_card = [d for d in differ if d["engine_on_card"] == "device"]
    contigs = [res.store.seq_str(i) for i in range(len(res.store))] if res.store else []
    summary = {"workload": "polyte_passes_summary", "genome_len": genome_len,
               "n_reads": len(store), "polyte_wall_s": wall,
               "iterations": res.iterations, "contigs": len(contigs),
               "digest": contig_digest(contigs), "passes": len(lines),
               "device_passes": sum(x["engine_on_card"] == "device" for x in lines),
               "passes_differing": len(differ),
               "device_passes_differing": len(on_card),
               "first_differing": differ[0] if differ else None,
               "first_device_pass_differing": on_card[0] if on_card else None,
               "device": str(device), "card": card,
               "checks_failed": sorted({c for x in lines for c in x["checks_failed"]})}
    return lines + [print_line(summary)]


# ---------------------------------------------------------------- main


def run(workloads, device, runs=3, genome_len=50_000) -> list:
    """Each named workload's lines, printed as they come."""
    from haploconduct_torch.workflows.polyte import concat_to_single_end
    from torch_envelope import POLYTE_CONFIG, card_line, polyte_diploid_store

    unknown = sorted(set(workloads) - set(WORKLOADS))
    if unknown or runs < 1:
        raise ValueError(f"workloads {unknown} not of {WORKLOADS}, or runs {runs} < 1")
    card = card_line() if device.type == "cuda" else None
    lines = []
    for name in workloads:
        if name == "synthetic10x":
            lines.append(print_line(run_workload(
                name, synthetic_seqs(), 90, 0.01, False, device, runs, None, card)))
        elif name == "savage_patch":
            seqs, min_ov, err = savage_patch_input()
            lines.append(print_line(run_workload(
                name, seqs, min_ov, err, False, device, runs, None, card)))
        elif name == "polyte_reads_exact":
            store, _ = polyte_diploid_store(genome_len)
            seqs = store_seqs(concat_to_single_end(store))
            lines.append(print_line(run_workload(
                name, seqs, POLYTE_CONFIG["min_overlap_len_EC"], 0.0, True, device,
                runs, polyte_subsample(len(seqs)), card, genome_len=genome_len)))
        else:
            lines += polyte_passes(device, runs, genome_len, card)
    return lines


def print_line(line: dict) -> dict:
    print(json.dumps({k: v for k, v in line.items() if not k.startswith("_")}),
          flush=True)
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help=f"comma-separated, of {', '.join(WORKLOADS)}")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs of each engine, after one untimed run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: the join's torch ops on the CPU (HC_TORCH_DEVICE=cpu)")
    ap.add_argument("--genome-len", type=int, default=50_000,
                    help="POLYTE diploid's genome (its 50 kb record by default)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    if args.device:
        os.environ["HC_TORCH_DEVICE"] = args.device
    # the host engine's OpenMP join on every core (torch_bench.py:baseline_ext)
    os.environ.setdefault("OMP_NUM_THREADS", str(os.cpu_count()))
    from haploconduct_torch.parallel.devices import default_device

    lines = run([w for w in args.workloads.split(",") if w], default_device(),
                args.runs, args.genome_len)
    return 1 if any(line["checks_failed"] for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
