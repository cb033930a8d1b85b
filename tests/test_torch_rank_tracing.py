"""The tracing of the work across ranks: parallel/mesh.py's phase
`mesh.gather` and GATHER_STATS, parallel/distributed.py's GATHER_STATS,
and run_savage's split of its stage-a gather. Two gloo ranks on the CPU in
subprocesses under a timeout (tests/test_torch_global_mesh.py:run_ranks),
one run of the worker for the module; in one process none of it runs."""

import json

import numpy as np
import pytest
import torch

from haploconduct_torch.ops.score import score_tasks_torch
from haploconduct_torch.parallel import distributed, mesh
from haploconduct_torch.utils.log import PhaseTimer
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

from test_torch_cli_ranks import _small_store
from test_torch_global_mesh import rank_json, rank_npz, run_ranks
from test_torch_mesh import multi_segment_case
from test_torch_pipeline import STEP_KW, tiny_rows
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

RANKS = 2
SCORE_PHASES = ("score.prepare", "score.matrix", "score.device", "score.finish")
COLUMNS = ("sum_log", "counted", "mismatches", "rejected")
NEW_TIMINGS = ("stage_a_gather_wait_s", "stage_a_gather_codec_s")

BODY = """
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.utils.log import PhaseTimer
    from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                                   simulate_reads)
    from haploconduct_torch.workflows import savage

    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        args = [f[k] for k in ("codes", "quals", "lens", "row_a", "row_b", "pos")]
    with np.load(os.path.join(workdir, "step.npz")) as f:
        step_args = [f[k] for k in ("codes", "quals", "lens")]
    with open(os.path.join(workdir, "step_kw.json")) as f:
        step_kw = json.load(f)
    report, arrays = {}, {}

    def mesh_delta(fn):
        before = dict(mesh.GATHER_STATS)
        out = fn()
        return out, {k: mesh.GATHER_STATS[k] - before[k] for k in before}

    # no phase open: the gathers run and time nothing; a timer whose
    # phase closed before the call records nothing either
    closed = PhaseTimer()
    with closed("verify"):
        pass
    bare, report["score_stats"] = mesh_delta(lambda: mesh.sharded_score_tasks(*args))
    report["closed_times"] = sorted(closed.times)
    timer = PhaseTimer()
    with timer("verify"):
        timed = mesh.sharded_score_tasks(*args)
    report["score_times"] = dict(timer.times)
    for col in ("sum_log", "counted", "mismatches", "rejected"):
        arrays["bare_" + col], arrays["timed_" + col] = getattr(bare, col), getattr(timed, col)
    step_timer = PhaseTimer()
    with step_timer("verify"):
        step, report["step_stats"] = mesh_delta(
            lambda: mesh.sharded_assembly_step(None, *step_args, **step_kw))
    arrays["step_scores"] = step[0]
    report["step_edges"] = int(step[1])
    report["step_times"] = dict(step_timer.times)

    # the object gathers: a blob of 10 + 7 * rank bytes, then one indexed
    # item a rank
    before = distributed.gather_stats()
    got = distributed.allgather_bytes(bytes(range(10 + 7 * rank)))
    mid = distributed.gather_stats()
    item = {"rank": rank, "text": "x" * (3 + rank)}
    indexed = distributed.allgather_indexed([item], [rank], ranks, lambda r: r, lambda b: b)
    after = distributed.gather_stats()
    report["bytes_got"] = [len(b) for b in got]
    report["indexed"] = indexed
    report["indexed_blob"] = len(json.dumps({str(rank): item}).encode())
    report["stats"] = [before, mid, after]

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 1200)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    seqs, quals = simulate_reads(haps, coverage=15, read_len=120, rng=rng)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    g0 = distributed.gather_stats()
    res = savage.run_savage(store, savage.SavageConfig(split_num=2, backend="torch",
                                                       min_clique_size=4))
    report["savage_timings"] = res.timings
    report["savage_stats"] = [g0, distributed.gather_stats()]
    report["savage_phases"] = sorted(res.stage_b.phase_times)
    save(**arrays)
    save_json(report)
"""


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """The worker's reports, after one run of BODY on two gloo ranks."""
    tmp = tmp_path_factory.mktemp("rank_tracing")
    np.savez(tmp / "inputs.npz", **dict(zip(
        ("codes", "quals", "lens", "row_a", "row_b", "pos"), multi_segment_case())))
    np.savez(tmp / "step.npz", **dict(zip(("codes", "quals", "lens"), tiny_rows())))
    (tmp / "step_kw.json").write_text(json.dumps(STEP_KW))
    run_ranks(tmp, BODY, RANKS)
    return [(rank_json(tmp, r), rank_npz(tmp, r)) for r in range(RANKS)]


def test_mesh_gather_phase_under_an_open_timer_and_none_without(ranks_run):
    """Each gather of sharded_score_tasks and sharded_assembly_step opens
    `mesh.gather` on the open timer, the scoring call's inside its
    score.device; a timer with no phase open records nothing."""
    for report, _ in ranks_run:
        assert report["closed_times"] == ["verify"]
        for key in ("score_times", "step_times"):
            times = report[key]
            assert 0 < times["mesh.gather"] <= times["verify"]
        assert sorted(report["step_times"]) == ["mesh.gather", "verify"]
        times = report["score_times"]
        assert sorted(times) == sorted(("mesh.gather", "verify") + SCORE_PHASES), times
        assert times["mesh.gather"] <= times["score.device"]


def test_sharded_results_bit_equal_with_and_without_a_timer(ranks_run):
    args = multi_segment_case()
    one = score_tasks_torch(*args, device="cpu")
    step = mesh.sharded_assembly_step([torch.device("cpu")], *tiny_rows(), **STEP_KW)
    for report, arrays in ranks_run:
        for col in COLUMNS:
            np.testing.assert_array_equal(arrays["timed_" + col], arrays["bare_" + col])
            np.testing.assert_array_equal(arrays["bare_" + col], getattr(one, col))
        np.testing.assert_array_equal(arrays["step_scores"], step[0])
        assert report["step_edges"] == step[1]


def _score_gather_bytes(codes, lens, row_a, row_b, pos, ranks):
    """The bytes a rank receives in sharded_score_tasks over `ranks` ranks:
    every rank's header of 6 f64, then every rank's (4, most tasks) f64
    block."""
    la, lb = lens[row_a], lens[row_b]
    lanes = np.maximum(np.minimum(la - pos, lb), 0)
    held = np.diff(mesh.shard_bounds(lanes, ranks)).max()
    return ranks * 6 * 8 + ranks * 4 * int(held) * 8


def test_mesh_gather_stats_count_calls_and_exact_bytes(ranks_run):
    codes, quals, lens, row_a, row_b, pos = multi_segment_case()
    want = _score_gather_bytes(codes, lens, row_a, row_b, pos, RANKS)
    rows, width = tiny_rows()[0].shape
    nk = width - STEP_KW["k"] + 1
    per = (rows + (-rows) % RANKS) // RANKS
    # the header of 8 f64, one shard's f32 slot scores, the i64 count
    step = RANKS * (8 * 8 + per * nk * STEP_KW["expand"] * 4 + 8)
    for report, _ in ranks_run:
        assert report["score_stats"] == {"calls": 2, "bytes": want}
        assert report["step_stats"] == {"calls": 3, "bytes": step}


def test_distributed_gather_stats_count_calls_bytes_and_seconds(ranks_run):
    blobs = [report["indexed_blob"] for report, _ in ranks_run]
    for rank, (report, _) in enumerate(ranks_run):
        before, mid, after = report["stats"]
        assert report["bytes_got"] == [10 + 7 * r for r in range(RANKS)]
        assert report["indexed"] == [{"rank": r, "text": "x" * (3 + r)} for r in range(RANKS)]
        assert mid["calls"] - before["calls"] == 1
        assert mid["bytes"] - before["bytes"] == sum(10 + 7 * r for r in range(RANKS))
        assert mid["wait_s"] > before["wait_s"] and mid["codec_s"] == before["codec_s"]
        assert after["calls"] - mid["calls"] == 1
        assert after["bytes"] - mid["bytes"] == sum(blobs)
        assert after["wait_s"] > mid["wait_s"] and after["codec_s"] > mid["codec_s"]


def test_run_savage_splits_its_stage_a_gather_over_ranks(ranks_run):
    """Over two ranks run_savage records the gather's wait and codec
    seconds beside stage_a_gather_s, three object gathers a run (stage a's
    patches, then the classes of each of the two abundance filters, each
    rank having classified half of the 300 reads), and stage b's
    verification opens mesh.gather inside run_iteration's verify."""
    for report, _ in ranks_run:
        timings = report["savage_timings"]
        assert all(k in timings for k in NEW_TIMINGS + ("stage_a_gather_s",)), timings
        assert all(timings[k] >= 0 for k in NEW_TIMINGS + ("filter_gather_wait_s",))
        assert timings["filter_reads"] == 2 * 300
        assert timings["filter_reads_classified"] == 2 * 150
        g0, g1 = report["savage_stats"]
        assert g1["calls"] - g0["calls"] == 3 and g1["bytes"] > g0["bytes"]
        assert "mesh.gather" in report["savage_phases"]


def test_one_process_runs_none_of_it():
    """In one process: run_savage has no split of its gather, the gathers
    count nothing and open no phase, and a plain device list gathers
    nothing."""
    stats, mesh_stats = distributed.gather_stats(), dict(mesh.GATHER_STATS)
    res = run_savage(_small_store(), SavageConfig(split_num=2, backend="torch",
                                                  min_clique_size=4))
    assert "stage_a_gather_s" in res.timings
    assert not any(k in res.timings for k in NEW_TIMINGS + ("filter_gather_wait_s",))
    # both filters classify every read themselves
    assert res.timings["filter_reads_classified"] == res.timings["filter_reads"] == 2 * 300
    assert distributed.allgather_bytes(b"abc") == [b"abc"]
    assert distributed.allgather_indexed([1], [0], 1, str, int) == [1]
    timer = PhaseTimer()
    with timer("verify"):
        mesh.sharded_score_tasks(*multi_segment_case(), mesh=[torch.device("cpu")] * 2)
    assert sorted(timer.times) == sorted(("verify",) + SCORE_PHASES)
    assert distributed.gather_stats() == stats and mesh.GATHER_STATS == mesh_stats
