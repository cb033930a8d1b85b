"""torch_envelope.py's POLYTE workflows against the JAX package's tools:
polyte_diploid_store and polyte_envelope_store draw the reads of
tools/br_scale_bench.py and tools/envelope_run.py:polyte_envelope, the
configurations are the tools', and on small genomes the new modes give
the contigs of the JAX package's run_polyte and run_polyte_split, byte for
byte; the JSON line's fields, --profile's pieces, region threads and two
gloo ranks under torchrun."""

import ast
import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_envelope
from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.utils.simulate import (mutate_sequence, random_genome,
                                             simulate_reads)
from haploconduct_tpu.workflows.polyte import PolyteConfig as RefPolyteConfig
from haploconduct_tpu.workflows.polyte import run_polyte as ref_run_polyte
from haploconduct_tpu.workflows.polyte_split import \
    PolyteSplitConfig as RefPolyteSplitConfig
from haploconduct_tpu.workflows.polyte_split import \
    run_polyte_split as ref_run_polyte_split

from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_GENOME = 12_000
DIPLOID_GENOME = 4_000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's small CPU ops on one thread: several test workers share the
    cores (as in tests/test_torch_polyte_split.py)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envelope_tool():
    spec = importlib.util.spec_from_file_location(
        "envelope_run", os.path.join(REPO, "tools", "envelope_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_source(name):
    with open(os.path.join(REPO, "tools", name)) as f:
        return f.read()


def _config_call(source, name):
    """The keywords of the one call of `name` in a tool's source, as
    (keyword, expression source) pairs."""
    calls = [n for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == name]
    assert len(calls) == 1, name
    return {k.arg: ast.unparse(k.value) for k in calls[0].keywords}


def _ref_store(seqs, quals):
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return store


def _diploid_draws(genome_len):
    """tools/br_scale_bench.py's draws, with the JAX package's simulator."""
    rng = np.random.default_rng(0)
    hap1 = random_genome(rng, genome_len)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    seqs, quals = simulate_reads([hap1, hap2], coverage=20, read_len=150,
                                 rng=rng, error_rate=0.002)
    return seqs, quals, [hap1, hap2]


def _split_draws(genome_len, hap_cov=15, read_len=250):
    """tools/envelope_run.py:polyte_envelope's draws, with the JAX
    package's simulator."""
    rng = np.random.default_rng(1)
    genome = random_genome(rng, genome_len)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    seqs, quals = simulate_reads([genome, hap2], coverage=hap_cov,
                                 read_len=read_len, rng=rng, error_rate=0.0)
    return seqs, quals, [genome, hap2]


def _assert_store_holds(store, seqs, quals):
    assert len(store) == store.readcount_single == len(seqs)
    assert [store.seq_str(i) for i in range(len(store))] == seqs
    assert [store.phred_str(i) for i in range(len(store))] == quals
    assert list(store.ids) == list(range(len(seqs)))


@pytest.mark.parametrize("genome_len", [50_000, DIPLOID_GENOME])
def test_diploid_store_draws_the_tools_reads(genome_len):
    store, haps = (torch_envelope.polyte_diploid_store() if genome_len == 50_000
                   else torch_envelope.polyte_diploid_store(genome_len))
    seqs, quals, want = _diploid_draws(genome_len)
    assert haps == want
    _assert_store_holds(store, seqs, quals)
    if genome_len == 50_000:
        assert len(store) == 13_332  # BASELINE.md:108


@pytest.mark.parametrize("genome_len", [120_000, 6_000])
def test_envelope_store_draws_the_tools_reads(genome_len):
    store, haps = (torch_envelope.polyte_envelope_store() if genome_len == 120_000
                   else torch_envelope.polyte_envelope_store(genome_len))
    seqs, quals, want = _split_draws(genome_len)
    assert haps == want
    _assert_store_holds(store, seqs, quals)
    if genome_len == 120_000:
        assert len(store) == 14_400  # BASELINE.md:303


def test_stores_and_configs_are_the_tools():
    want = inspect.signature(_envelope_tool().polyte_envelope).parameters
    for name, p in inspect.signature(torch_envelope.polyte_envelope_store).parameters.items():
        assert want[name].default == p.default, name
    assert "GENOME = int(sys.argv[1]) if len(sys.argv) > 1 else 50000" in \
        _tool_source("br_scale_bench.py")
    assert inspect.signature(torch_envelope.polyte_diploid_store).parameters[
        "genome_len"].default == 50_000

    # br_scale_bench.py:57-59, but for the backend and the engine
    kw = _config_call(_tool_source("br_scale_bench.py"), "PolyteConfig")
    assert kw.pop("backend") == "'native'" and kw.pop("candidates") == "'host'"
    assert {k: ast.literal_eval(v) for k, v in kw.items()} == torch_envelope.POLYTE_CONFIG

    # envelope_run.py:216-222 at the tool's hap_cov and read_len
    kw = _config_call(_tool_source("envelope_run.py"), "PolyteSplitConfig")
    assert kw.pop("backend") == "'native'" and kw.pop("reference") == "ref_path"
    cfg = torch_envelope.polyte_split_config("ref.fasta", backend="torch")
    env = dict(hap_cov=15, read_len=250)
    for key, expr in kw.items():
        assert getattr(cfg, key) == eval(expr, {}, env), key
    assert (cfg.reference, cfg.backend, cfg.pool_size) == ("ref.fasta", "torch", 1)


def _main_lines(argv):
    """torch_envelope.main's JSON lines, and the rest of its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert torch_envelope.main(argv) == 0
    text = out.getvalue()
    lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    return lines, text


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """The new mode on a 12 kb genome (torch, native; --profile) and the
    JAX package's run_polyte_split of the same reads at the tool's
    configuration (native backend)."""
    lines, text = _main_lines(["--workflow", "polyte-split", "--genome-len",
                               str(SPLIT_GENOME), "--backend", "torch,native",
                               "--profile"])
    seqs, quals, haps = _split_draws(SPLIT_GENOME)
    ref_path = str(tmp_path_factory.mktemp("split") / "ref.fasta")
    with open(ref_path, "w") as f:
        f.write(f">chr\n{haps[0]}\n")
    ref = ref_run_polyte_split(_ref_store(seqs, quals), RefPolyteSplitConfig(
        hap_cov=15, insert_size=250, stddev=25, reference=ref_path,
        split_size=10000, split_overlap=1000, backend="native",
        min_overlap_len=100, min_overlap_len_EC=2 + 250 // 2))
    return lines, text, ref, haps


def test_small_polyte_split_matches_the_jax_package(split_runs):
    lines, _, ref, haps = split_runs
    st = ref.final.store
    contigs = [st.seq_str(i) for i in range(len(st))]
    assert len(ref.regions) == 2 and contigs
    tool = _envelope_tool()
    want_quality = {"per_haplotype": tool.quality_metrics(contigs, haps),
                    "union": tool.quality_metrics(contigs, haps[:1])}
    assert [line["backend"] for line in lines] == ["torch", "native"]
    for line in lines:
        assert line["digest"] == torch_envelope.contig_digest(contigs)
        assert line["final_contigs"] == len(contigs)
        assert line["longest_contig"] == max(len(c) for c in contigs)
        assert line["sum_final_bp"] == sum(len(c) for c in contigs)
        assert line["n_regions"] == len(ref.regions)
        assert line["final_ref_candidates"] == ref.final_ref_candidates > 0
        assert line["iterations"] == {
            "final": ref.final.iterations,
            "regions": sum(r.iterations for r in ref.region_results)}
        assert line["failed_regions"] == []
        assert line["quality"] == want_quality
    # the union places every contig on the genome: no less of it covered
    q = lines[0]["quality"]
    assert q["union"]["genome_fraction"] >= q["per_haplotype"]["genome_fraction"]


def test_split_json_line_carries_the_runs_record(split_runs):
    lines, _, _, _ = split_runs
    torch_line, native_line = lines
    for key in ("metric", "workflow", "backend", "candidates", "rank", "world_size",
                "genome_len", "n_reads", "pool_size", "wall_s", "n_regions",
                "iterations", "final_ref_candidates", "failed_regions",
                "final_contigs", "longest_contig", "sum_final_bp", "digest",
                "quality", "quality_s", "breakdown", "device", "card"):
        assert key in torch_line, key
    assert torch_line["metric"] == "polyte-split >100kb genome end-to-end"
    assert (torch_line["rank"], torch_line["world_size"]) == (0, 1)
    assert (torch_line["candidates"], torch_line["pool_size"]) == ("host", 1)
    assert torch_line["genome_len"] == SPLIT_GENOME and torch_line["n_reads"] == 1_440
    assert len(torch_line["digest"]) == 64
    dev = torch_line["device"]
    # on the CPU no kernel launch and no join on a card; every task through
    # the torch backend's plain version, some rechecked in f64
    assert dev["score_tasks_launches"] == 0 and dev["peak_cuda_mib"] is None
    assert dev["backend_counts"]["torch"] > 0 and dev["backend_counts"]["recheck"] > 0
    assert dev["backend_counts"]["mesh"] == dev["backend_counts"]["native"] == 0
    assert "approximate_counts" not in dev and "cuda" not in dev["join_calls"]
    assert native_line["device"]["backend_counts"]["native"] == \
        dev["backend_counts"]["torch"]
    assert "build_s" not in torch_line


def test_profile_names_the_pieces_of_polyte_split(split_runs):
    lines, text, _, _ = split_runs
    for line in lines:
        b = line["breakdown"]
        top = b["top"]
        for piece in ("concat_reads", "reference_index", "alignment", "detect_regions",
                      "split_windows", "binning", "regions", "merge",
                      "final_ref_candidates", "final_pass"):
            assert top[piece] >= 0, piece
        assert top["alignment"] > 0 and top["regions"] > 0 and top["final_pass"] > 0
        assert 0.9 <= b["named_share"] <= 1.0 + 1e-6
        regions = b["regions"]
        assert regions["calls"] == line["n_regions"]
        assert regions["first_pass_candidates"] > 0
        assert regions["iterations"] > 0 and regions["phases"]["verify"] > 0
        # the top-level phases lie inside the iterations, and the
        # verification's own (dotted) phases inside its verify phase
        phases = regions["phases"]
        assert sum(v for k, v in phases.items() if "." not in k) <= regions["iterations"] + 0.05
        assert sum(v for k, v in phases.items() if k.startswith("verify.")) \
            <= phases["verify"] + 0.05
        assert regions["branch_reduction_run"] > 0
        assert (regions["first_pass_candidates"] + regions["iterations"]
                + regions["reoverlap_candidates"]) <= regions["total"]
        assert b["final"]["calls"] == 1 and "first_pass_candidates" not in b["final"]
    # the package's functions are unwrapped again after the run
    from haploconduct_torch.ops import align
    from haploconduct_torch.workflows import polyte, polyte_split

    assert polyte_split.run_polyte is polyte.run_polyte
    assert align.align_store.__module__ == "haploconduct_torch.ops.align"
    assert align.align_store.__name__ == "align_store"
    for backend in ("torch", "native"):
        assert (f"[profile] polyte-split, backend {backend}, candidates host: "
                "top 30 by cumulative time") in text
    assert "align_store" in text and "run_polyte" in text


def test_region_threads_give_the_one_thread_digest(split_runs):
    lines, _ = _main_lines(["--workflow", "polyte-split", "--genome-len",
                            str(SPLIT_GENOME), "--backend", "torch", "--pool-size", "2"])
    (pooled,) = lines
    single = split_runs[0][0]
    assert pooled["pool_size"] == 2 and pooled["failed_regions"] == []
    assert pooled["digest"] == single["digest"]
    # every count exact under region threads, the f64 rechecks included
    assert "approximate_counts" not in pooled["device"]
    assert pooled["device"]["backend_counts"] == single["device"]["backend_counts"]
    assert pooled["device"]["backend_counts"]["recheck"] > 0


def test_small_polyte_diploid_matches_the_jax_package():
    lines, _ = _main_lines(["--workflow", "polyte", "--genome-len", str(DIPLOID_GENOME),
                            "--backend", "torch,native"])
    seqs, quals, haps = _diploid_draws(DIPLOID_GENOME)
    ref = ref_run_polyte(_ref_store(seqs, quals), RefPolyteConfig(
        hap_cov=20, insert_size=150, stddev=15, backend="native",
        min_overlap_len=60, min_overlap_len_EC=77, diploid=True, candidates="host"))
    contigs = [ref.store.seq_str(i) for i in range(len(ref.store))]
    diploid = [ref.diploid_store.seq_str(i) for i in range(len(ref.diploid_store))]
    assert contigs and diploid
    assert [(x["backend"], x["candidates"]) for x in lines] == [
        ("torch", "host"), ("native", "host"), ("torch", "auto"), ("native", "auto")]
    for line in lines:
        assert line["metric"] == "polyte 4kb diploid end-to-end"
        assert line["digest"] == torch_envelope.contig_digest(contigs)
        assert line["diploid_digest"] == torch_envelope.contig_digest(diploid)
        assert line["iterations"] == ref.iterations
        assert (line["contigs"], line["diploid_contigs"]) == (len(contigs), len(diploid))
        assert line["longest_contig"] == max(len(c) for c in contigs)
        assert line["diploid_sum_bp"] == sum(len(c) for c in diploid)
        assert line["quality"]["per_haplotype"]["n_contigs"] == len(contigs)
        assert line["diploid_quality"]["union"]["n_contigs"] == len(diploid)
        pieces = line["breakdown"]["polyte"]
        assert pieces["calls"] == 1 and pieces["first_pass_candidates"] > 0
        assert pieces["diploid_candidates"] > 0 and pieces["reoverlap_candidates"] > 0
        assert 0.9 <= line["breakdown"]["named_share"] <= 1.0 + 1e-6
        assert "pool_size" not in line and "n_regions" not in line
    # on the CPU "auto" resolves to the host engine: the same contigs
    assert lines[2]["identical_to_host"] is True and lines[3]["identical_to_host"] is True
    assert "identical_to_host" not in lines[0]


def test_options_of_the_wrong_workflow_are_refused(capsys):
    with pytest.raises(SystemExit):
        torch_envelope.main(["--workflow", "polyte", "--pool-size", "2"])
    assert "--pool-size is for --workflow polyte-split" in capsys.readouterr().err


def test_two_gloo_ranks_under_torchrun_give_the_one_process_digest(split_runs, tmp_path):
    """The script under torchrun on the CPU: regions round-robined over two
    gloo ranks and gathered; each rank prints its line with the
    one-process digest."""
    single = split_runs[0][0]
    env = dict(os.environ, PYTHONPATH=REPO, HC_TORCH_DEVICE="cpu",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.join(REPO, "torch_envelope.py"),
         "--workflow", "polyte-split", "--genome-len", str(SPLIT_GENOME),
         "--backend", "torch"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = sorted((json.loads(x) for x in proc.stdout.splitlines()
                    if x.startswith("{")), key=lambda x: x["rank"])
    assert [(x["rank"], x["world_size"]) for x in lines] == [(0, 2), (1, 2)]
    for line in lines:
        assert line["digest"] == single["digest"] and line["failed_regions"] == []
        assert line["breakdown"]["top"]["gather"] > 0
        assert line["breakdown"]["regions"]["calls"] == 1
