"""The SAVAGE slice of haploconduct_torch (stages, workflow, CLI, process
group) against the JAX package: contigs must be byte-identical to the
reference driven with its f64 numpy oracle."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

from haploconduct_tpu.assemble.stages import StageParams as RefStageParams
from haploconduct_tpu.assemble.stages import run_stage as ref_run_stage
from haploconduct_tpu.cli import main as ref_main
from haploconduct_tpu.workflows.savage import SavageConfig as RefSavageConfig
from haploconduct_tpu.workflows.savage import run_savage as ref_run_savage
from haploconduct_torch.assemble.stages import StageParams, run_stage
from haploconduct_torch.cli import main
from haploconduct_torch.ops.verify import BACKEND_COUNTS
from haploconduct_torch.parallel import distributed
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

from torch_helpers import (dryrun_overlaps, dryrun_store, make_store,
                           multi_strain_reads, port_store)
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seqs(store):
    return [store.seq_str(i) for i in range(len(store))]


def test_stage_a_dryrun_matches_reference():
    store = dryrun_store()
    ov = dryrun_overlaps(store)
    kw = dict(stage="a", min_overlap_len=80, edge_threshold=0.97,
              original_readcount=len(store))
    ref = ref_run_stage(RefStageParams(backend="numpy", **kw), store, ov)
    before = BACKEND_COUNTS["torch"]
    got = run_stage(StageParams(backend="torch", **kw), port_store(store), ov)
    assert BACKEND_COUNTS["torch"] > before
    assert len(got.store) > 0 and _seqs(got.store) == _seqs(ref.store)
    assert got.iterations == ref.iterations
    assert [h["n_edges_final"] for h in got.history if "n_edges_final" in h] == \
        [h["n_edges_final"] for h in ref.history if "n_edges_final" in h]


def test_run_savage_abc_matches_reference():
    store = make_store(*multi_strain_reads())
    ref = ref_run_savage(store, RefSavageConfig(split_num=2, backend="numpy"))
    got = run_savage(port_store(store), SavageConfig(split_num=2, backend="torch"))
    for stage in "abc":
        assert got.contigs(stage) == ref.contigs(stage), stage
    assert {k: v.table() for k, v in got.frequencies.items()} == \
        {k: v.table() for k, v in ref.frequencies.items()}


def test_savage_checkpoint_resume(tmp_path):
    """Mirror of tests/test_workflows.py:test_savage_checkpoint_resume."""
    import dataclasses

    store = port_store(make_store(*multi_strain_reads()))
    cfg = SavageConfig(split_num=1, backend="torch", output_dir=str(tmp_path),
                       stage_c=False)
    res1 = run_savage(store, cfg)
    assert (tmp_path / "checkpoints" / "stage_b" / "singles.fastq").exists()
    res2 = run_savage(store, dataclasses.replace(cfg, resume=True))
    assert res2.stage_b.iterations == 0  # served from the checkpoint
    assert sorted(res1.contigs("b")[1]) == sorted(res2.contigs("b")[1])


def test_freq_filter_reids_surviving_contigs():
    """Mirror of tests/test_workflows.py:test_freq_filter_reids_surviving_contigs
    through the port's filter (torch EM) and a stage-c run of the port."""
    from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
    from haploconduct_torch.assemble.stages import StageResult
    from haploconduct_torch.workflows.savage import _freq_filter, contig_candidates

    rng = np.random.default_rng(21)
    g = random_genome(rng, 1200)
    reads = port_store(make_store(*simulate_reads([g], coverage=8, read_len=120,
                                                  rng=rng, error_rate=0.0)))
    contigs = port_store(make_store([g[:700], random_genome(rng, 600), g[500:]],
                                    ["I" * 700, "I" * 600, "I" * 700]))
    res = StageResult(store=contigs, subreads={0: {}, 1: {}, 2: {"x": None}},
                      overlap_lines=[], iterations=1)
    out = _freq_filter(res, reads, 120.0, "torch")
    assert [int(out.store.ids[i]) for i in range(len(out.store))] == [0, 1]
    assert set(out.subreads) <= {0, 1}
    params = StageParams(stage="c", min_overlap_len=100, edge_threshold=0.995,
                         remove_branches=True, max_tip_len=120, first_it=True,
                         original_readcount=2, backend="torch")
    run_stage(params, out.store, contig_candidates(out.store, 100, 50))


def test_cli_matches_reference_cli(tmp_path):
    seqs, quals = multi_strain_reads(seed=6)
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{q}\n" for i, (s, q) in enumerate(zip(seqs, quals))))
    args = ["savage", "-s", str(fq), "--split", "2"]
    assert ref_main(args + ["-o", str(tmp_path / "ref"), "--backend", "numpy"]) == 0
    assert main(args + ["-o", str(tmp_path / "torch"), "--backend", "torch"]) == 0
    names = sorted(f for f in os.listdir(tmp_path / "ref") if f.endswith((".fasta", ".txt")))
    assert "contigs_stage_c.fasta" in names
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_cli_usage_and_unported_modes(capsys):
    """USAGE lists every command of the reference's CLI; an unknown command
    prints it and fails."""
    from haploconduct_torch.cli import USAGE

    assert main([]) == 0
    assert capsys.readouterr().out.strip() == USAGE.strip()
    for cmd in ("savage", "polyte", "polyte-split", "count-strains"):
        assert f"\n    {cmd} " in USAGE
    assert main(["no-such-command"]) == 1
    assert "polyte-split" in capsys.readouterr().out


def test_cli_auto_backend_needs_a_card(tmp_path, monkeypatch):
    """The CLI's default backend, auto, is the kernel on the card: without
    a card the run stops with an error instead of scoring on the CPU."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    monkeypatch.delenv("HC_BACKEND", raising=False)
    seqs, quals = multi_strain_reads(seed=6)
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{q}\n" for i, (s, q) in enumerate(zip(seqs, quals))))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["savage", "-s", str(fq), "--split", "1", "-o", str(tmp_path / "o")])


def test_stage_profile_dir_writes_chrome_trace(tmp_path):
    store = port_store(dryrun_store())
    p = StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                    original_readcount=len(store), backend="torch",
                    profile_dir=str(tmp_path))
    run_stage(p, store, dryrun_overlaps(store))
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".trace.json")]
    assert len(traces) == 1
    text = (tmp_path / traces[0]).read_text()
    assert '"verify"' in text
    # the verification's own phases lie inside the iteration's verify phase
    events = [e for e in json.loads(text)["traceEvents"] if "dur" in e]
    spans = {name: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("name") == name]
             for name in ("verify", "verify.plan", "score.device")}
    for name in ("verify.plan", "score.device"):
        assert spans[name], name
        for a, b in spans[name]:
            assert any(lo <= a and b <= hi for lo, hi in spans["verify"]), (name, a, b)


JAX_FREE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.path.insert(0, %(tests)r)
    from torch_helpers import dryrun_overlaps, dryrun_store, port_store
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    store = dryrun_store()
    res = run_stage(StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                                original_readcount=len(store), backend="torch"),
                    port_store(store), dryrun_overlaps(store))
    assert len(res.store) > 0
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    print("contigs", len(res.store))
""")


def test_stage_runs_with_jax_unimportable():
    """The root conftest imports jax, so only a fresh process can show the
    port's stage never needs it."""
    env = dict(os.environ, PYTHONPATH=REPO, HC_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FREE % {"tests": os.path.join(REPO, "tests")}],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("contigs ")


def test_single_process_distributed_helpers():
    assert not distributed.maybe_initialize()
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.my_work_items(3) == [0, 1, 2]
    assert distributed.allgather_stage_results(["x", "y"], [0, 1], 2) == ["x", "y"]


GLOO_WORKER = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None
    sys.path.insert(0, %(tests)r)
    from torch_helpers import make_store, multi_strain_reads, port_store
    from haploconduct_torch.parallel import distributed
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage
    store = port_store(make_store(*multi_strain_reads()))
    res = run_savage(store, SavageConfig(split_num=2, backend="torch",
                                         stage_b=False, stage_c=False))
    assert distributed.process_count() == 2
    assert distributed.my_work_items(2) == [int(os.environ["RANK"])]
    ids, seqs = res.contigs("a")
    with open(sys.argv[1], "w") as f:
        f.write("\\n".join(f"{i} {s}" for i, s in zip(ids, seqs)))
""")


def test_two_process_gloo_savage_matches_single(tmp_path):
    """Mirror of tests/test_distributed.py:test_two_process_savage_matches_single:
    two gloo ranks split the patches and both end with the single-process
    stage a contigs."""
    worker = tmp_path / "worker.py"
    worker.write_text(GLOO_WORKER % {"tests": os.path.join(REPO, "tests")})
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    outs = [tmp_path / f"out{r}.txt" for r in range(2)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   CUDA_VISIBLE_DEVICES="", HC_TORCH_DEVICE="cpu")
        procs.append(subprocess.Popen([sys.executable, str(worker), str(outs[rank])],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        finally:
            p.kill()
        errs.append(err.decode()[-2000:])
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)

    single = run_savage(port_store(make_store(*multi_strain_reads())),
                        SavageConfig(split_num=2, backend="torch",
                                     stage_b=False, stage_c=False))
    ids, seqs = single.contigs("a")
    want = "\n".join(f"{i} {s}" for i, s in zip(ids, seqs))
    assert outs[0].read_text() == want
    assert outs[1].read_text() == want
