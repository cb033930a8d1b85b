"""Whole runs on the CPU at a small genome, past the harness's look for a
card: sound, `correct` is true; with the timed path broken underneath,
`correct` is false, once for each fault the cells can have."""

import numpy as np
import pytest

import bench_helpers

STAGE_A = "savage-patch-667x.stage-a"
VERIFY = "savage-patch-667x.verify-it1"
POLYTE = "polyte-diploid-20x.assemble"


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def altered_answers(fn):
    """Every fifth task's mismatch count one higher and its score 1% lower,
    where the scoring call produces them."""
    def call(*args, **kwargs):
        ts = fn(*args, **kwargs)
        mism, score = ts.mismatches.copy(), ts.score.copy()
        mism[::5] += 1
        score[::5] *= 0.99
        return ts._replace(mismatches=mism, score=score)
    return call


def half_left_out(fn):
    """The second half of the tasks never scored: zeros where sums go."""
    def call(*args, **kwargs):
        ts = fn(*args, **kwargs)
        half = len(ts.score) // 2
        out = [a.copy() for a in ts]
        for a in out:
            a[half:] = 0
        return type(ts)(*out)
    return call


def altered_contigs(fn):
    """A base in the middle of every contig changed where stage a makes it."""
    def call(store, cfg):
        res = fn(store, cfg)
        cs = res.combined_store
        for i in range(len(cs)):
            u = cs.unit1[i]
            codes = cs._unit_codes[u]
            mid = len(codes) // 2
            codes[mid] = (codes[mid] + 1) % 4
        return res
    return call


def _contig_stores(res):
    """(attribute of the store, attribute of its subreads) of each contig
    set of a SAVAGE or POLYTE result."""
    if hasattr(res, "combined_store"):
        return [("combined_store", "combined_subreads")]
    return [("store", "subreads"), ("diploid_store", "diploid_subreads")]


def _assembly_fault(change):
    def fault(fn):
        def call(store, cfg, *args, **kwargs):
            res = fn(store, cfg, *args, **kwargs)
            for st, sub in _contig_stores(res):
                if getattr(res, st) is not None:
                    change(res, st, sub)
            return res
        return call
    return fault


def _drop(res, st, sub):
    """The first half of the contigs (rounded up) left out of the store."""
    from haploconduct_torch.core.reads import ReadStore

    old, new = getattr(res, st), ReadStore()
    for i in range((len(old) + 1) // 2, len(old)):
        u = old.unit1[i]
        new.add_single_codes(old.ids[i], old.unit_codes(u), old.unit_quals(u))
    new.readcount_single = len(new)
    setattr(res, st, new)


def _truncate(res, st, sub):
    """Every contig cut to its first half."""
    cs = getattr(res, st)
    for i in range(len(cs)):
        u = cs.unit1[i]
        half = max(1, len(cs._unit_codes[u]) // 2)
        cs._unit_codes[u] = cs._unit_codes[u][:half].copy()
        cs._unit_quals[u] = cs._unit_quals[u][:half].copy()


def _empty_subreads(res, st, sub):
    """No contig's reads handed on."""
    setattr(res, sub, {})


contigs_dropped = _assembly_fault(_drop)
contigs_truncated = _assembly_fault(_truncate)
subreads_emptied = _assembly_fault(_empty_subreads)


@pytest.mark.parametrize("workload", [STAGE_A, VERIFY, POLYTE])
def test_sound_runs_are_correct(workload, monkeypatch, one_thread):
    rc, line = bench_helpers.run_small(workload, 2**31 + 7, monkeypatch=monkeypatch)
    assert rc == 0 and line["correct"], line
    assert list(line["checks"]) == list(bench_helpers_limits(workload))
    assert line["attempted"] >= 1 and line["failed"] == 0


def bench_helpers_limits(workload):
    from benchlib import manifest

    return manifest.cell_file(workload)["limits"]


@pytest.mark.parametrize("workload,fault,target", [
    (STAGE_A, altered_answers, "haploconduct_torch.ops.verify.score_tasks_torch"),
    (STAGE_A, half_left_out, "haploconduct_torch.ops.verify.score_tasks_torch"),
    (STAGE_A, altered_contigs, "haploconduct_torch.workflows.savage.run_savage"),
    (STAGE_A, contigs_dropped, "haploconduct_torch.workflows.savage.run_savage"),
    (STAGE_A, contigs_truncated, "haploconduct_torch.workflows.savage.run_savage"),
    (STAGE_A, subreads_emptied, "haploconduct_torch.workflows.savage.run_savage"),
    (POLYTE, altered_answers, "haploconduct_torch.ops.verify.score_tasks_torch"),
    (POLYTE, contigs_dropped, "haploconduct_torch.workflows.polyte.run_polyte"),
    (POLYTE, contigs_truncated, "haploconduct_torch.workflows.polyte.run_polyte"),
    (POLYTE, subreads_emptied, "haploconduct_torch.workflows.polyte.run_polyte"),
    (VERIFY, altered_answers, "haploconduct_torch.ops.verify.score_tasks_torch"),
    (VERIFY, half_left_out, "haploconduct_torch.ops.verify.score_tasks_torch"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, target, monkeypatch, one_thread):
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    rc, line = bench_helpers.run_small(workload, 2**31 + 7, monkeypatch=monkeypatch)
    assert rc == 0
    failed = [k for k, v in line["checks"].items() if not v["value"] <= v["limit"]]
    assert not line["correct"] and failed, line


def test_the_control_fails_the_comparison(monkeypatch, one_thread):
    """The float32 reference in the program's place fails at least one
    number, where the program passes every one."""
    import torch

    import control
    from benchlib import judge, manifest

    bench_helpers.shrink(monkeypatch)
    row = control.readings_for_seed(VERIFY, 11, 0.1, torch.device("cpu"))
    limits = manifest.cell_file(VERIFY)["limits"]
    assert all(ok for *_, ok in judge.verdict(row["program"], limits))
    assert not all(ok for *_, ok in judge.verdict(row["control"], limits))
    assert np.isfinite(row["control"]["threshold_gap_ratio"])


def test_a_traced_run_reports_its_layers(monkeypatch, one_thread):
    """--trace 1: the per-layer metrics that have something to read, the
    traced window and the breakdown of idle time by the host span open."""
    rc, line = bench_helpers.run_small(STAGE_A, 2**31 + 7, trace=1, monkeypatch=monkeypatch)
    assert rc == 0 and line["correct"], line
    for name in ("candidates.window_pct", "iteration.graph_pct", "iteration.verify_pct",
                 "iteration.merge_pct"):
        assert 0 < line["metrics"][name]["value"] < 100
    assert line["device"]["window_s"] > 0
    assert line["breakdown"]["idle_gaps"]
