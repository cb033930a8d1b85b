"""torch_cands.py, the port's twin of tools/cand_device_vs_host.py, on the
CPU at small sizes: its candidate keys, recall and extras are the tool's;
its synthetic10x reads are tools/profile_stage.py's draw; the port's join
as the tool calls it (verify=False) equals the JAX package's; every line
has every field, and on an error-free store the join finds the whole
complete set; without a card it raises unless the CPU was asked for."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import haploconduct_tpu.ops.kmer_device as ref_kmer_device
import torch_cands
from haploconduct_tpu.core.reads import ReadStore as RefReadStore
from haploconduct_tpu.utils.simulate import (mutate_sequence, random_genome,
                                             simulate_reads)
from haploconduct_torch.core.reads import encode_seq
from haploconduct_torch.io.sfo import SFO_DTYPE
from haploconduct_torch.ops.kmer_device import find_overlap_candidates_device
from haploconduct_torch.workflows import polyte

from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LINE_FIELDS = {
    # the tool's
    "workload", "n_seqs", "host_s", "host_candidates", "device_s",
    "device_candidates", "device_recall_vs_host", "device_extra",
    # the twin's
    "min_ov", "error_rate", "verify", "host_k", "host_subsample", "host_native",
    "join", "host_s_samples", "device_s_samples", "device_missing", "full_s",
    "full_candidates", "host_recall_vs_full", "device_recall_vs_full",
    "device_extra_vs_full", "groups", "groups_over_expand",
    "groups_over_max_group", "kmers_in_groups_over_max_group", "device", "card",
    "checks_failed"}
PASS_FIELDS = LINE_FIELDS | {"pass", "iteration", "caller", "sfo_err", "engine_on_card"}
SUMMARY_FIELDS = {
    "workload", "genome_len", "n_reads", "polyte_wall_s", "iterations", "contigs",
    "digest", "passes", "device_passes", "passes_differing",
    "device_passes_differing", "first_differing", "first_device_pass_differing",
    "device", "card", "checks_failed"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's many small CPU ops on one thread, so idle intra-op threads
    do not spin against the suite's other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_tool():
    """tools/cand_device_vs_host.py by path (it reads the bundled example
    reads only inside main())."""
    spec = importlib.util.spec_from_file_location(
        "cand_device_vs_host", REPO / "tools" / "cand_device_vs_host.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def sfo_of(rows):
    out = np.zeros(len(rows), dtype=SFO_DTYPE)
    for i, (a, b, oha, ori) in enumerate(rows):
        out[i]["ida"], out[i]["idb"], out[i]["oha"], out[i]["ori"] = a, b, oha, ori
    return out


# hand-built host and device sets: shared keys, keys that differ only in
# oha or only in ori, ids up to the host engine's 2^19 - 1, negative oha
HOST_ROWS = [(0, 1, 10, b"N"), (0, 1, 10, b"I"), (0, 2, -35, b"N"),
             (3, 7, 0, b"N"), (5, 524287, 120, b"I"), (8, 9, -4000, b"N")]
DEVICE_ROWS = [(0, 1, 10, b"N"), (0, 1, 11, b"N"), (3, 7, 0, b"N"),
               (5, 524287, 120, b"I"), (11, 12, 7, b"I")]


@pytest.mark.parametrize("rows", [HOST_ROWS, DEVICE_ROWS, []])
def test_keys_equal_the_tools(rows):
    tool = load_tool()
    sfo = sfo_of(rows)
    assert torch_cands.sfo_key_set(sfo) == tool.sfo_key_set(sfo)
    # the packed keys are one to one with the tool's
    assert len(torch_cands.sfo_keys(sfo)) == len(tool.sfo_key_set(sfo))


def test_recall_and_extras_equal_the_tools(monkeypatch, capsys):
    """The tool's run_workload on the hand-built sets (its engines patched
    to return them) against the twin's recall and extras."""
    tool = load_tool()
    host, dev = sfo_of(HOST_ROWS), sfo_of(DEVICE_ROWS)
    monkeypatch.setattr(tool, "find_overlap_candidates", lambda *a, **k: host)
    monkeypatch.setattr(ref_kmer_device, "find_overlap_candidates_device",
                        lambda *a, **k: dev)
    want = tool.run_workload("hand-built", [], 90, 0.01, skip_device=False)
    capsys.readouterr()
    hs, ds = torch_cands.sfo_keys(host), torch_cands.sfo_keys(dev)
    assert want["device_recall_vs_host"] == round(torch_cands.recall(hs, ds), 4) == 0.5
    assert want["device_extra"] == torch_cands.extra(ds, hs) == 2
    assert want["host_candidates"] == len(hs)
    assert want["device_candidates"] == len(ds)
    sets = tool.sfo_key_set(host), tool.sfo_key_set(dev)
    assert torch_cands.extra(hs, ds) == len(sets[0] - sets[1])
    assert torch_cands.recall(ds, hs) == len(sets[0] & sets[1]) / len(sets[1])


def ref_synthetic_codes(scale):
    """tools/profile_stage.py:33-48 with the JAX package's simulator."""
    rng = np.random.default_rng(0)
    genome = random_genome(rng, 10000)
    mut = mutate_sequence(genome, rng, sub_rate=0.01)
    haps = [genome, mut[0] if isinstance(mut, tuple) else mut]
    n_reads = 2200 * scale
    read_len = 150
    coverage = n_reads * read_len / (2 * len(genome))
    seqs, quals = simulate_reads(haps, coverage=coverage, read_len=read_len, rng=rng,
                                 error_rate=0.002)
    store = RefReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return [store.unit_codes(u) for u in range(store.n_units)]


def test_synthetic_draw_is_profile_stages():
    got, want = torch_cands.synthetic_seqs(scale=1), ref_synthetic_codes(1)
    assert len(got) == len(want) == 2200
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_join_as_the_tool_calls_it_equals_the_reference():
    """verify=False at error_rate 0.01, min_ov 90, on 532 reads of 150 bp
    at 0.2% error over a 2 kb genome and a mutant at 1% (40x: hash groups
    past `expand`, where the table's order decides which candidates
    exist)."""
    rng = np.random.default_rng(7)
    genome = random_genome(rng, 2000)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.01)]
    reads, _ = simulate_reads(haps, coverage=20, read_len=150, rng=rng,
                              error_rate=0.002)
    seqs = [encode_seq(s) for s in reads]
    assert torch_cands.group_counts(seqs, CPU)["groups_over_expand"] > 500
    got = find_overlap_candidates_device(seqs, min_overlap_len=90, error_rate=0.01,
                                         verify=False, device=CPU, **torch_cands.JOIN)
    want = ref_kmer_device.find_overlap_candidates_device(
        seqs, min_overlap_len=90, error_rate=0.01, verify=False)
    assert len(got) > 1000 and got.dtype == want.dtype and len(got) == len(want)
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def error_free_seqs(n_reads=1600, genome_len=20_000, seed=5):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    seqs, _ = simulate_reads([genome], coverage=n_reads * 150 / genome_len,
                             read_len=150, rng=rng, error_rate=0.0)
    return [encode_seq(s) for s in seqs]


@pytest.mark.parametrize("verify", [False, True], ids=["tool", "exact"])
def test_error_free_store_line(verify, capsys):
    """Each mode's line on ~1,600 error-free reads (12x of a 20 kb genome),
    the host engine under POLYTE's seed rule: every field, no failed check,
    and the join finds every candidate of the complete k=20 set."""
    seqs = error_free_seqs()
    assert len(seqs) > torch_cands.POLYTE_FULL_SEEDS_UP_TO
    line = torch_cands.run_workload(
        "error_free", seqs, 77, 0.0, verify, CPU, runs=2,
        host_subsample=torch_cands.polyte_subsample(len(seqs)))
    assert LINE_FIELDS <= set(line)
    assert line["checks_failed"] == []
    assert line["host_subsample"] > 1  # seeds subsampled above 1,500 sequences
    assert line["device_recall_vs_full"] == 1.0
    assert line["full_candidates"] > 1000
    assert len(line["host_s_samples"]) == len(line["device_s_samples"]) == 2
    assert line["groups_over_max_group"] == 0
    torch_cands.print_line(line)
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == {k for k in line if not k.startswith("_")}


def test_polyte_passes_lines_and_summary(capsys):
    """POLYTE diploid at 2 kb: one line a captured pass, then the summary;
    single_end_candidates is restored after the run."""
    original = polyte.single_end_candidates
    lines = torch_cands.run(["polyte_passes"], CPU, runs=1, genome_len=2000)
    assert polyte.single_end_candidates is original
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    passes, summary = printed[:-1], printed[-1]
    assert len(lines) == len(printed) and len(passes) > 3
    assert all(PASS_FIELDS <= set(p) for p in passes)
    assert SUMMARY_FIELDS <= set(summary) and summary["passes"] == len(passes)
    assert summary["checks_failed"] == []
    assert [p["caller"] for p in passes[:2]] == ["first", "reoverlap"]
    assert passes[0]["iteration"] == 0 and passes[1]["iteration"] == 1
    assert passes[0]["n_seqs"] == summary["n_reads"]
    assert passes[0]["engine_on_card"] == "host"  # sfo_err 0.02: approximate
    assert summary["device_passes"] == sum(p["engine_on_card"] == "device"
                                           for p in passes)
    differ = [p for p in passes
              if p["device_extra"] or p["device_missing"]]
    assert summary["passes_differing"] == len(differ)


def test_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    env = {k: v for k, v in os.environ.items() if k != "HC_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "torch_cands.py", "--workloads",
                           "polyte_reads_exact", "--genome-len", "2000"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "HC_TORCH_DEVICE=cpu" in proc.stderr
    assert not proc.stdout.strip()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_cands.main(["--device", "cpu", "--workloads", "polyte_reads_exact",
                               "--genome-len", "2000", "--runs", "1"])
    (line,) = [json.loads(x) for x in out.getvalue().splitlines()]
    assert rc == 0 and line["workload"] == "polyte_reads_exact"
    assert line["device"] == "cpu" and line["card"] is None
