"""The readers of the verification's own phases (verify.* and score.*,
which the program opens inside run_iteration's verify phase): their
arithmetic, nothing read where the program opens no such phase, and the
traced runs that report them."""

import pytest

import bench_helpers
from benchlib import manifest

STAGE_A = "savage-patch-667x.stage-a"
VERIFY = "savage-patch-667x.verify-it1"
READERS = {
    "verify.plan_pct.assembly": ("verify.plan",),
    "verify.combine_pct.assembly": ("verify.rates", "verify.combine", "verify.select"),
    "verify.recheck_time_pct.assembly": ("verify.recheck",),
    "score_call.host_pct.assembly": ("score.prepare", "score.matrix", "score.finish"),
    "score_call.wait_pct.assembly": ("score.device",),
}
# the per-layer metrics traced stage-a runs reported before these readers
STAGE_A_BEFORE = ("candidates.window_pct", "iteration.graph_pct", "iteration.merge_pct",
                  "iteration.verify_pct", "device.idle_pct.assembly")


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_sums_its_phases_over_the_window(name):
    phases = {"verify": 9.0, "verify.plan": 1.0, "verify.score": 2.5, "verify.rates": 0.25,
              "verify.recheck": 0.5, "verify.combine": 2.0, "verify.select": 0.75,
              "score.prepare": 0.5, "score.matrix": 0.25, "score.device": 1.0,
              "score.finish": 0.5}
    reader = manifest.load_module("metrics", name)
    want = 100.0 * sum(phases[p] for p in READERS[name]) / 20.0
    assert reader.read({"window_s": 20.0, "phases": phases}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_the_phases(name):
    """A program that opens only run_iteration's phases (or none) gives
    no reading, and the reader does not raise."""
    reader = manifest.load_module("metrics", name)
    assert reader.read({"window_s": 20.0, "phases": {}}) is None
    assert reader.read({"window_s": 20.0, "phases": {"verify": 2.0, "pack": 0.1}}) is None


def test_readers_are_the_assembly_cells_and_move_their_rate():
    man = manifest.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "assembly_reads_per_s"
        assert m["source"] == "program_span" and m["unit"] == "%"
        assert m["workloads"] == ["savage-patch-667x.stage-a", "polyte-diploid-20x.assemble"]
        assert m["layer"] in ("verification", "scoring call")


def test_traced_stage_a_reports_the_phases_inside_the_verify_share(monkeypatch, one_thread):
    rc, line = bench_helpers.run_small(STAGE_A, 2**31 + 7, trace=1, monkeypatch=monkeypatch)
    assert rc == 0 and line["correct"], line
    got = line["metrics"]
    for name in STAGE_A_BEFORE + tuple(READERS):
        assert name in got, name
    split = [got[name]["value"] for name in READERS]
    assert all(v > 0 for v in split)
    # children of the iteration's verify phase: never more than it
    assert sum(split) <= got["iteration.verify_pct"]["value"] + 1e-9


def test_traced_verify_cell_reports_what_it_did(monkeypatch, one_thread):
    """verify-it1 runs no run_iteration in its window: none of these
    readers is its, and its own traced metrics are still read."""
    rc, line = bench_helpers.run_small(VERIFY, 2**31 + 7, trace=1, monkeypatch=monkeypatch)
    assert rc == 0 and line["correct"], line
    got = line["metrics"]
    assert "verify.recheck_pct" in got and "device.idle_pct.verify" in got
    assert not set(READERS) & set(got)
