"""torch_envelope.py (SAVAGE at its documented operating point on the port)
against the JAX package's tools/envelope_run.py:savage_envelope: the same
reads, and on a small envelope the same stage a/b/c contigs and quality
columns as the JAX package's numpy backend; the JSON line's keys;
chip_smoke.py phase 11's input; phase 4's run, which scores on the one
device it names however many devices default_mesh() lists; and the checks
of phases 4 and 9 on the cache of the packed read matrix."""

import contextlib
import importlib.util
import inspect
import io
import json
import os

import numpy as np
import pytest

import chip_smoke
import torch_envelope
from haploconduct_tpu.utils.simulate import (mutate_sequence, random_genome,
                                             simulate_reads)
from haploconduct_tpu.workflows.savage import SavageConfig as RefSavageConfig
from haploconduct_tpu.workflows.savage import run_savage as ref_run_savage

from torch_helpers import store_arrays
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(genome_len=1000, total_cov=1334, split_num=2)


def _envelope_tool():
    spec = importlib.util.spec_from_file_location(
        "envelope_run", os.path.join(REPO, "tools", "envelope_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_draws(genome_len, total_cov, read_len=150, n_haps=4, divergence=0.03):
    """tools/envelope_run.py:savage_envelope's simulator calls, in its order,
    with the JAX package's simulator."""
    rng = np.random.default_rng(0)
    genome = random_genome(rng, genome_len)
    haps = [genome] + [mutate_sequence(genome, rng, sub_rate=divergence)
                       for _ in range(n_haps - 1)]
    seqs, quals = simulate_reads(haps, coverage=total_cov / n_haps,
                                 read_len=read_len, rng=rng, error_rate=0.002)
    return seqs, quals, haps


def test_envelope_store_draws_the_tools_reads_with_its_defaults():
    tool = inspect.signature(_envelope_tool().savage_envelope).parameters
    ours = inspect.signature(torch_envelope.savage_envelope_store).parameters
    for name, p in ours.items():
        assert tool[name].default == p.default, name

    store, haps = torch_envelope.savage_envelope_store(genome_len=1000)
    seqs, quals, want_haps = _tool_draws(1000, 10000)
    assert haps == want_haps
    assert len(store) == store.readcount_single == len(seqs) == 66_664
    assert [store.seq_str(i) for i in range(len(store))] == seqs
    assert [store.phred_str(i) for i in range(len(store))] == quals
    assert list(store.ids) == list(range(len(seqs)))
    with pytest.raises(AssertionError):
        torch_envelope.savage_envelope_store(genome_len=1000, total_cov=1000,
                                             split_num=2)


@pytest.fixture(scope="module")
def small_run():
    """The script's JSON line for the small envelope with the torch backend
    (on the CPU), and the JAX package's numpy run of the same reads."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_envelope.main([
            "--backend", "torch", "--genome-len", str(SMALL["genome_len"]),
            "--total-cov", str(SMALL["total_cov"]), "--split", str(SMALL["split_num"])])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])

    from haploconduct_tpu.core.reads import ReadStore

    seqs, quals, haps = _tool_draws(SMALL["genome_len"], SMALL["total_cov"])
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    ref = ref_run_savage(store, RefSavageConfig(split_num=SMALL["split_num"],
                                                backend="numpy", min_clique_size=4))
    return line, ref, haps


def test_small_envelope_matches_the_jax_numpy_run(small_run):
    line, ref, haps = small_run
    tool = _envelope_tool()
    for stage in "abc":
        _, contigs = ref.contigs(stage)
        assert contigs, stage
        assert line[f"stage_{stage}_contigs"] == len(contigs)
        assert line["digests"][stage] == torch_envelope.contig_digest(contigs), stage
        assert line[f"stage_{stage}_quality"] == tool.quality_metrics(
            contigs, haps, snps=stage == "c"), stage
    assert line["longest_contig"] == max(len(c) for c in ref.contigs("c")[1])


def test_json_line_carries_the_runs_record(small_run):
    line, _, _ = small_run
    assert line["metric"] == "savage 10000x-coverage patched end-to-end"
    assert (line["backend"], line["rank"], line["world_size"]) == ("torch", 0, 1)
    assert line["n_reads"] == 8_892 and line["split_num"] == 2
    assert line["coverage_per_patch"] == 667.0
    assert line["wall_s"] > 0 and set(line["digests"]) == set("abc")
    assert all(len(d) == 64 for d in line["digests"].values())
    for key in ("stage_a_s", "stage_a_candidates_s", "stage_a_gather_s",
                "stage_b_s", "stage_b_filter_s", "stage_c_s", "stage_c_filter_s"):
        assert key in line["timings"], key
    assert line["stage_a_phases"]["verify"] > 0
    assert "verify" in line["stage_b_phases"] and "verify" in line["stage_c_phases"]
    torch_part = line["torch"]
    # on the CPU no kernel launches; every task goes through the torch
    # backend's plain version, some of them rechecked in f64
    assert torch_part["score_tasks_launches"] == 0
    assert torch_part["peak_cuda_mib"] is None
    counts = torch_part["backend_counts"]
    assert counts["torch"] > 0 and counts["recheck"] > 0
    assert counts["numpy"] == counts["native"] == 0
    snp = line["stage_c_quality"]
    assert snp["snps_total"] > 0 and 0 <= snp["snps_recovered"] <= snp["snps_total"]
    mc = line["stage_c_mc001"]
    assert mc["wall_s"] > 0 and mc["n_contigs"] > 0 and "snps_recovered" in mc
    assert "card" in line and "build_s" not in line


def test_chip_smoke_phase11_input_is_the_envelope_at_two_patches():
    assert chip_smoke.PHASE11_ENVELOPE == dict(total_cov=1334, split_num=2)
    got, got_haps = chip_smoke.phase11_store()
    want, want_haps = torch_envelope.savage_envelope_store(total_cov=1334, split_num=2)
    assert len(got) == 88_932 and got_haps == want_haps and len(got_haps[0]) == 10_000
    a, b = store_arrays(got), store_arrays(want)
    assert a.keys() == b.keys()
    for key in a:
        if key in ("unit_codes", "unit_quals"):
            assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))
        else:
            assert a[key] == b[key], key


def test_chip_smoke_phase4_scores_on_its_one_device_whatever_the_mesh(monkeypatch):
    """With two devices in default_mesh(), verify routes every task through
    the mesh: phase 4's run (savage_patch_run) pins the mesh to the one
    device it names, counts every task under "torch" and none under
    "mesh", and restores default_mesh() after; phase 9 (b)'s run names two."""
    import torch

    from haploconduct_torch.parallel import mesh

    cpu = torch.device("cpu")
    two = [cpu, cpu]
    monkeypatch.setattr(mesh, "default_mesh", lambda: list(two))
    store = chip_smoke.dryrun_store()
    run = chip_smoke.savage_patch_run(torch, store, "torch", [cpu])
    assert run["counts"]["torch"] > 0
    assert run["counts"]["mesh"] == run["counts"]["native"] == run["counts"]["numpy"] == 0
    assert run["launches"] == 0 and run["peak"] == 0 and run["wall"] > 0
    assert mesh.default_mesh() == two
    meshed = chip_smoke.savage_patch_run(torch, store, "torch", two)
    assert meshed["counts"]["mesh"] == run["counts"]["torch"]
    assert meshed["counts"]["torch"] == 0
    assert chip_smoke.contig_sets(meshed["res"]) == chip_smoke.contig_sets(run["res"])
    assert mesh.default_mesh() == two


def test_chip_smoke_checks_every_cached_matrix_and_turns_the_cache_off(monkeypatch):
    """Phase 4's run under checked_cache holds every matrix of the cache
    of the packed read matrix to a fresh upload and counts them; phase 9
    (b)'s run under cache_off uploads every matrix whole; both give the
    same contigs, and HC_DEVICE_CACHE is restored after each block. A
    matrix that differs from a fresh upload fails the check."""
    import torch

    from haploconduct_torch.ops import device_cache

    monkeypatch.delenv("HC_DEVICE_CACHE", raising=False)
    cpu = torch.device("cpu")
    store = chip_smoke.dryrun_store()
    with chip_smoke.checked_cache(torch) as checked:
        on = chip_smoke.savage_patch_run(torch, store, "torch", [cpu])
    assert checked["matrices"] == on["transfers"]["iterations"] > 0
    assert on["transfers"]["reused_rows"] > 0
    assert device_cache.comb_for_devices.__module__ == device_cache.__name__
    with chip_smoke.cache_off():
        off = chip_smoke.savage_patch_run(torch, store, "torch", [cpu, cpu])
    assert "HC_DEVICE_CACHE" not in os.environ
    assert off["transfers"]["reused_rows"] == 0
    assert off["transfers"]["uploaded_bytes"] == off["transfers"]["full_bytes"] > 0
    assert chip_smoke.contig_sets(off["res"]) == chip_smoke.contig_sets(on["res"])
    assert "uploaded=" in chip_smoke.transfers_line(on["transfers"])

    def stale(codes, quals, lens_by_row, combined, devices):
        return [torch.zeros(combined.shape, dtype=torch.int16) for _ in devices]

    monkeypatch.setattr(device_cache, "comb_for_devices", stale)
    with pytest.raises(AssertionError, match="differs from a fresh upload"):
        with chip_smoke.checked_cache(torch):
            chip_smoke.savage_patch_run(torch, store, "torch", [cpu])
