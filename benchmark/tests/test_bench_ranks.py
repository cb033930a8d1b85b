"""The four-rank cell savage-sample-4rank.abc on the CPU: four gloo ranks
(this process as rank 0, three children; benchlib/ranks.py) at a small
genome, the readers of its new metrics, a dead rank, a rank whose
contigs differ, and the one-process reference."""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import bench_helpers
from benchlib import harness, judge, manifest, ranks

CELL = "savage-sample-4rank.abc"
SMALL = {"genome_len": 600, "patch_coverage": 100}
NEW_METRICS = ("ranks.gather_wait_pct", "savage.stage_bc_pct", "mesh.gather_pct")


@pytest.fixture(autouse=True)
def small(monkeypatch):
    monkeypatch.setitem(bench_helpers.SMALL, "savage-sample-4rank", SMALL)


def test_a_short_traced_window_is_correct_and_reports_the_new_metrics(monkeypatch):
    rc, line = bench_helpers.run_small(CELL, 2**31 + 11, seconds=0.1, trace=1,
                                       monkeypatch=monkeypatch)
    assert rc == 0 and line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["count"] == 4
    for name in NEW_METRICS + ("iteration.verify_pct", "candidates.window_pct"):
        assert line["metrics"][name]["value"] >= 0, name
    # rank 0 may be the slowest rank, and then waits for no other
    assert line["metrics"]["savage.stage_bc_pct"]["value"] > 0
    assert line["metrics"]["mesh.gather_pct"]["value"] > 0
    by_rank = line["readings"]["by_rank"]
    assert [len(s) for s in by_rank["stage_a_s"]] == [line["attempted"]] * 4
    assert len(by_rank["peak_bytes"]) == 4
    assert line["checks"]["rank_disagreements"] == {"value": 0, "limit": 0}
    # every verify call of rank 0: its own patch's stage a, and stages b and c
    assert line["readings"]["calls"] > 2 and line["readings"]["contigs"] > 0
    # the one-process reference: the same samples, no group, the same contigs
    import one_process

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        one_process.main(["--workload", CELL, "--seed", str(2**31 + 11), "--units", "0"])
    [one] = [json.loads(x) for x in out.getvalue().splitlines()]
    assert "stage_a_gather_wait_s" not in one["timings"]
    assert one["sha256"] == line["readings"]["sample_sha256"][0]


def _record(**timings):
    return {"window_s": 10.0, "extra": {"timings": timings}, "phases": {"verify": 2.0}}


def test_readers_give_numbers_and_none_without_the_new_keys():
    read = {n: manifest.load_module("metrics", n).read for n in NEW_METRICS}
    rec = _record(stage_a_s=5.0, stage_a_gather_wait_s=0.5, stage_b_s=1.0,
                  stage_b_filter_s=0.25, stage_c_candidates_s=0.25, stage_c_s=0.5)
    rec["phases"]["mesh.gather"] = 0.2
    assert read["ranks.gather_wait_pct"](rec) == pytest.approx(5.0)
    assert read["savage.stage_bc_pct"](rec) == pytest.approx(20.0)
    assert read["mesh.gather_pct"](rec) == pytest.approx(2.0)
    # a parent's program: no split of the gather, no mesh.gather phase
    old = _record(stage_a_s=5.0, stage_a_gather_s=0.5, stage_b_s=1.0)
    assert read["ranks.gather_wait_pct"](old) is None
    assert read["mesh.gather_pct"](old) is None
    assert read["savage.stage_bc_pct"](old) == pytest.approx(10.0)
    assert read["savage.stage_bc_pct"](_record(stage_a_s=5.0)) is None
    assert read["ranks.gather_wait_pct"]({"window_s": 1.0, "extra": {}}) is None


RUNNER = """
import sys, time
sys.path[:0] = %(path)r
import bench_helpers
from benchlib import ranks
bench_helpers.SMALL["savage-sample-4rank"] = %(small)r
send = ranks.Ranks.send

def send_then_kill(self, command):
    send(self, command)
    if command.get("k") == 1:  # the window's second sample started
        self.procs[0].kill()

ranks.Ranks.send = send_then_kill
rc, line = bench_helpers.run_small("savage-sample-4rank.abc", 5, seconds=60)
print("finished", rc, line is not None)
"""


def test_a_rank_killed_mid_window_ends_the_run_at_once_without_a_result(tmp_path):
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER % {"path": [os.path.dirname(__file__), bench_helpers.BENCH,
                                         bench_helpers.ROOT], "small": SMALL})
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(runner)], capture_output=True, text=True,
                          timeout=ranks.GROUP_TIMEOUT_S, cwd=bench_helpers.ROOT,
                          env=dict(os.environ, HC_TORCH_DEVICE="cpu"))
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert time.monotonic() - t0 < ranks.GROUP_TIMEOUT_S
    assert "finished" not in proc.stdout
    assert "benchmark: rank 1 " in proc.stderr or "sample 1 failed on rank 0" in proc.stderr


DROP_ONE = """
import runpy, sys
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.workflows import savage

run = savage.run_savage

def one_contig_fewer(*a, **k):
    res = run(*a, **k)
    store = res.stage_c.store
    kept = ReadStore()
    for i in range(len(store) - 1):
        kept.add_single_codes(int(store.ids[i]), store.unit_codes(store.unit1[i]),
                              store.unit_quals(store.unit1[i]))
    kept.readcount_single = len(store) - 1
    res.stage_c.store = kept
    return res

savage.run_savage = one_contig_fewer
runpy.run_module("benchlib.ranks", run_name="__main__")
"""


def test_a_contig_dropped_on_one_rank_reads_as_rank_disagreements(tmp_path, monkeypatch):
    (tmp_path / "drop_one.py").write_text(textwrap.dedent(DROP_ONE))
    command = ranks.child_command
    monkeypatch.setattr(ranks, "child_command", lambda rank: (
        [sys.executable, str(tmp_path / "drop_one.py")] if rank == 2 else command(rank)))
    rc, line = bench_helpers.run_small(CELL, 23, seconds=0.1, monkeypatch=monkeypatch)
    assert rc == 0 and not line["correct"]
    check = line["checks"]["rank_disagreements"]
    assert check["value"] == line["attempted"] >= 1
    # rank 0's own contigs are whole, so every other check holds
    assert all(c["value"] <= c["limit"] for n, c in line["checks"].items()
               if n != "rank_disagreements")


def test_control_and_faults_read_past_their_limits(monkeypatch):
    """control.py on the cell: the float32 control and every planted fault,
    one rank's contigs changed among them, read past a limit."""
    import control

    bench_helpers.shrink(monkeypatch)
    import torch

    row = control.readings_for_seed(CELL, 31, 0.1, torch.device("cpu"))
    limits = manifest.cell_file(CELL)["limits"]
    assert row["failed"] == 0
    assert all(row["program"][n] <= limits[n] for n in limits)
    assert row["control"]["mismatch_rate_diffs"] > limits["mismatch_rate_diffs"]
    assert set(row["faults"]) == set(judge.CONTIG_FAULTS) | {"rank_contigs_changed"}
    for fault, readings in row["faults"].items():
        assert any(readings[n] > limits[n] for n in readings if n in limits), fault


def test_the_four_chip_cell_in_the_manifest():
    man = manifest.manifest()
    entry = manifest.workload(man, CELL)
    assert entry["chips"] == 4
    fours = sum(w["chips"] == 4 for w in man["workloads"])
    assert fours <= max(1, len(man["workloads"]) // 4)
    config = manifest.config_file(man, entry["config"])
    listed = next(c for c in man["configs"] if c["name"] == entry["config"])
    assert sorted(listed["reduced"]) == sorted(config["reduced"])
    for key in config["reduced"]:
        assert config["shapes"][key] != config["published"][key]
    assert config["savage"]["split_num"] == config["shapes"]["n_patches"] == entry["chips"]
    reported = {m["name"] for m in manifest.metrics_for(man, CELL, "per_layer")}
    assert set(NEW_METRICS) <= reported
    assert manifest.cell_file(CELL)["limits"]["rank_disagreements"] == 0
    assert "4 cards" in harness.check_cards(4) or "no CUDA" in harness.check_cards(4)
