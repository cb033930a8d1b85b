"""torch_bench.py, the port's twin of bench.py and tools/pin_baseline.py,
on the CPU at small sizes (the plain versions): its tasks are bench.py's
on the same store and seed; its stage a, candidates and mesh agree with
the JAX package and with one scoring call; every mode prints bench.py's
keys with `device`, `samples` and `median`; and without a card it raises
unless the CPU was asked for."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import torch_bench
from haploconduct_tpu.assemble.stages import StageParams as RefStageParams
from haploconduct_tpu.assemble.stages import run_stage as ref_run_stage
from haploconduct_tpu.core.reads import ReadStore as RefReadStore
from haploconduct_tpu.ops.kmer_device import (
    find_overlap_candidates_device as ref_candidates_device)
from haploconduct_tpu.workflows.savage import denovo_candidates as ref_denovo_candidates
from haploconduct_torch.ops.score import score_tasks_torch
from haploconduct_torch.parallel import mesh

from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SEED = 3
CPU = torch.device("cpu")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
TWIN_KEYS = {"device", "samples", "median"}


def lines_of(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_tasks_equal_bench_build_workload(monkeypatch):
    """bench.py's build_workload on the reference package's store of the
    same reads (its ReadStore.from_files patched to return it) gives the
    twin's packed matrix and task columns bit for bit."""
    _, singles, pairs = torch_bench.example_reads(SEED)
    ref_store = torch_bench.fill_store(RefReadStore(), singles, pairs)
    monkeypatch.setattr(RefReadStore, "from_files",
                        classmethod(lambda cls, **files: ref_store))
    want = bench.build_workload(4096, seed=SEED)
    name, codes, quals, lens, row_a, row_b, pos = torch_bench.build_workload(4096, SEED)
    assert name == "example" and len(ref_store) == 2200
    for got, exp in zip((codes, quals, lens, row_a, row_b, pos),
                        (want[0].codes, want[0].quals, *want[1:])):
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes()


def test_example_composition():
    strains, singles, pairs = torch_bench.example_reads(SEED)
    assert [len(s) for s in strains] == [9700] * 3
    assert len(singles) == 2000 and len(pairs) == 200
    assert {len(s) for s, _ in singles} == {250}
    assert torch_bench.counts_of(2000) == [1022, 518, 460]


def test_e2e_contigs_equal_native_and_the_reference(capsys):
    """Stage a on a 200-read store: the torch backend (its plain version)
    and native in turns give the same contigs as the JAX package's
    run_stage with its numpy backend on the same reads."""
    sizes = dict(singles=180, pairs=20, genome_len=2000)
    _, singles, pairs = torch_bench.example_reads(SEED, **sizes)
    store = torch_bench.example_store(SEED, **sizes)
    lines = torch_bench.bench_e2e(CPU, SEED, ["torch", "native"], runs=1, store=store)
    ref_store = torch_bench.fill_store(RefReadStore(), singles, pairs)
    ref = ref_run_stage(RefStageParams(
        stage="a", min_overlap_len=200, edge_threshold=0.97, remove_branches=True,
        max_tip_len=415, original_readcount=len(ref_store), backend="numpy"),
        ref_store, ref_denovo_candidates(ref_store, 200, 50))
    want = [ref.store.seq_str(i) for i in range(len(ref.store))]
    assert want
    assert [line["backend"] for line in lines] == ["torch", "native"]
    for line in lines:
        assert line["contigs"] == want and line["n_contigs"] == len(want)
        # one untimed warm-up run a backend, outside the samples
        assert line["warmup_s"] > 0 and line["warmup_phases"]
        assert len(line["samples"]) == 1 and len(line["order"]) == 2
    printed = lines_of(capsys.readouterr().out)
    assert [p["backend"] for p in printed] == ["torch", "native"]
    assert printed[0]["vs_baseline"] == pytest.approx(
        printed[1]["value"] / printed[0]["value"])


def test_cands_equal_the_reference_join():
    line = torch_bench.bench_candidates(CPU, SEED, genome_len=4000, runs=1)
    seqs = torch_bench.candidate_seqs(SEED, 4000)
    want = ref_candidates_device(seqs, min_overlap_len=50, error_rate=0.0, verify=True)
    got = line["candidates"]
    assert len(got) == len(want) == line["n_candidates"] > 0
    for field in want.dtype.names:
        np.testing.assert_array_equal(got[field], want[field])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_mesh_columns_bit_equal_to_one_call(k):
    _, *args = torch_bench.build_workload(3000, SEED)
    one = score_tasks_torch(*args, device=CPU)
    got = mesh.sharded_score_tasks(*args, mesh=torch_bench.mesh_for(k, CPU))
    for col in one._fields:
        assert getattr(got, col).tobytes() == getattr(one, col).tobytes()


def test_mesh_line(capsys):
    assert torch_bench.main(["--mesh", "--device", "cpu", "--counts", "1,2,3",
                             "--tasks", "2000", "--envelope-tasks", "0",
                             "--mesh-repeats", "2"]) == 0
    (line,) = lines_of(capsys.readouterr().out)
    assert BENCH_KEYS | TWIN_KEYS | {"per_device_count", "platform", "host_cores",
                                     "n_tasks"} <= set(line)
    assert set(line["per_device_count"]) == {"1", "2", "3"}
    assert line["n_tasks"] == 2000 and line["bit_equal_to_one_call"]
    assert len(line["samples"]) == 2 and line["value"] == max(line["samples"])


def test_pin_writes_the_record(tmp_path, capsys):
    path = tmp_path / "pinned.json"
    assert torch_bench.main(["--pin", "3", "--device", "cpu",
                             "--pin-path", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert {"value", "samples", "n_tasks", "date", "host_cores", "cpu",
            "loadavg_at_pin"} <= set(rec)
    assert len(rec["samples"]) == 3 and rec["n_tasks"] == 200_000
    assert rec["value"] == sorted(rec["samples"])[1] > 0
    (line,) = lines_of(capsys.readouterr().out)
    assert BENCH_KEYS | TWIN_KEYS <= set(line) and line["value"] == rec["value"]
    assert torch_bench.pinned_baseline(path) == rec["value"]


MODES = {
    "default": ["--tasks", "512", "--envelope-tasks", "2000", "--repeats", "1"],
    "e2e": ["--e2e", "--runs", "1"],
    "cands": ["--cands", "--genome-len", "3000"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_line_carries_device_samples_and_median(mode, capsys):
    assert torch_bench.main(MODES[mode] + ["--device", "cpu"]) == 0
    lines = lines_of(capsys.readouterr().out)
    assert len(lines) == 2 if mode != "cands" else len(lines) == 1
    for line in lines:
        assert BENCH_KEYS | TWIN_KEYS <= set(line), mode
        assert line["device"] == "cpu" and line["samples"]
        assert min(line["samples"]) <= line["median"] <= max(line["samples"])
    if mode == "default":
        assert [line["shape"] for line in lines] == ["example", "envelope_it1"]
        assert lines[0]["n_tasks"] == 512 and lines[1]["n_tasks"] == 2000
        assert lines[0]["n_sub"] == 512  # overlaps of at most 400 lanes
        for line in lines:
            assert line["baseline_live"] > 0 and line["call_rate"] > 0


def test_raises_without_a_card_unless_the_cpu_is_asked_for():
    env = {k: v for k, v in os.environ.items() if k != "HC_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "torch_bench.py", "--cands",
                           "--genome-len", "3000"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "HC_TORCH_DEVICE=cpu" in proc.stderr
    assert not lines_of(proc.stdout)
