"""The phases haploconduct_torch's verification opens on its PhaseTimer:
verify.* inside ops/verify.py:verify_overlaps and score.* inside the
scoring call (parallel/mesh.py:sharded_score_tasks, which
ops/score.py:score_tasks_torch calls with a mesh of one entry), on the
timer whose phase is open on the thread, on one device and over a mesh of
two; results bit-identical with and without them."""

import threading

import numpy as np
import pytest
import torch

from haploconduct_torch.assemble import iteration
from haploconduct_torch.assemble.stages import StageParams, run_stage
from haploconduct_torch.ops.verify import BACKEND_COUNTS, verify_overlaps
from haploconduct_torch.parallel import mesh
from haploconduct_torch.utils.config import Settings
from haploconduct_torch.utils.log import PhaseTimer, nested_phase

from test_score import build_random_store, random_overlaps
from torch_helpers import dryrun_overlaps, dryrun_store, port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

VERIFY_PHASES = ("verify.plan", "verify.score", "verify.rates", "verify.recheck",
                 "verify.combine", "verify.select")
SCORE_PHASES = ("score.prepare", "score.matrix", "score.device", "score.finish")
# every phase run_iteration opens itself (assemble/iteration.py)
ITERATION_PHASES = {"pack", "verify", "insert", "labelling", "graph_cleanup",
                    "branch_reduction", "cliques", "superreads", "fno", "next_store"}
SETTINGS = dict(edge_threshold=0.5, ov_threshold=0.2, backend="torch", exact=True)


def single_case():
    """The dry run's single-end store and its k-mer candidates."""
    store = dryrun_store()
    return port_store(store), dryrun_overlaps(store)


def paired_case():
    """Single and paired reads, overlaps of every S/P case."""
    rng = np.random.default_rng(4)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    return port_store(store), random_overlaps(rng, store, 150)


# a case's inputs and the entries of the mesh its verification scores over
CASES = {"single": (single_case, 1), "paired": (paired_case, 1),
         "paired-mesh": (paired_case, 2)}


def load_case(case, monkeypatch):
    """The case's store and overlaps; default_mesh() is the case's mesh of
    CPU entries where it has more than one."""
    build, entries = CASES[case]
    if entries > 1:
        monkeypatch.setattr(mesh, "default_mesh", lambda: [torch.device("cpu")] * entries)
    return build()


def result_bytes(res):
    return (res.edges.tobytes(), np.asarray(res.nonedge_mask).tobytes(),
            res.scored.tobytes(), res.n_tasks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_records_every_phase_and_parents_hold_their_children(case, monkeypatch):
    store, ov = load_case(case, monkeypatch)
    route = "mesh" if CASES[case][1] > 1 else "torch"
    before = dict(BACKEND_COUNTS)
    timer = PhaseTimer()
    with timer("verify"):
        res = verify_overlaps(store, store.pack(), ov, Settings(**SETTINGS))
    assert res.n_tasks > 0
    assert BACKEND_COUNTS[route] - before[route] == res.n_tasks
    t = timer.times
    for name in VERIFY_PHASES + SCORE_PHASES:
        assert t.get(name, 0.0) > 0.0, (name, t)
    assert "mesh.gather" not in t  # a plain device list gathers nothing
    assert t["verify"] >= sum(t[p] for p in VERIFY_PHASES)
    assert t["verify.score"] >= sum(t[p] for p in SCORE_PHASES)
    assert PhaseTimer.current() is None


@pytest.mark.parametrize("mode", ["none", "closed", "open", "annotate"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_result_is_bit_identical_with_and_without_phases(case, mode, monkeypatch):
    """No timer, a timer whose phase closed before the call (it times
    nothing), a timer whose phase is open on the thread (run_iteration's
    way), and one that also annotates profiler ranges."""
    store, ov = load_case(case, monkeypatch)
    packed, s = store.pack(), Settings(**SETTINGS)
    want = result_bytes(verify_overlaps(store, packed, ov, s))
    timer = PhaseTimer(annotate=mode == "annotate")
    if mode in ("none", "closed"):
        if mode == "closed":
            with timer("before"):
                pass
        got = verify_overlaps(store, packed, ov, s)
    else:
        with timer("verify"):
            got = verify_overlaps(store, packed, ov, s)
    assert result_bytes(got) == want
    names = {k for k in timer.times if "." in k}
    if mode in ("none", "closed"):
        assert not names
    else:
        assert set(VERIFY_PHASES + SCORE_PHASES) <= names


def test_open_timer_is_per_thread_and_restored():
    """A timer is current only on the thread whose phase is open, and the
    outer timer is current again when an inner one's phase closes."""
    outer, inner = PhaseTimer(), PhaseTimer()
    seen = {}
    with outer("a"):
        t = threading.Thread(target=lambda: seen.update(other=PhaseTimer.current()))
        t.start()
        t.join()
        with inner("b"):
            seen["inner"] = PhaseTimer.current()
        seen["outer"] = PhaseTimer.current()
    assert seen == {"other": None, "inner": inner, "outer": outer}
    assert PhaseTimer.current() is None
    # with no phase open a nested phase times nothing
    with nested_phase("verify.plan"):
        pass
    assert "verify.plan" not in outer.times and "verify.plan" not in inner.times


def test_stage_phase_times_hold_the_nested_phases_through_a_four_argument_wrapper(
        monkeypatch):
    """run_iteration calls verify_overlaps with four positional arguments
    (a wrapper that takes exactly those still works) and the phases reach
    the stage's phase_times through its open verify phase, beside the same
    top-level phases as a run without the wrapper."""
    store = port_store(dryrun_store())
    ov = dryrun_overlaps(dryrun_store())
    p = StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                    original_readcount=len(store), backend="torch")
    plain = run_stage(p, store, ov)
    calls = []
    verify = iteration.verify_overlaps

    def four(store, packed, ov, s):
        calls.append(len(ov))
        return verify(store, packed, ov, s)

    monkeypatch.setattr(iteration, "verify_overlaps", four)
    wrapped = run_stage(p, store, ov)
    assert calls
    top = {k for k in wrapped.phase_times if "." not in k}
    assert top == {k for k in plain.phase_times if "." not in k}
    assert top <= ITERATION_PHASES
    assert set(VERIFY_PHASES + SCORE_PHASES) <= set(wrapped.phase_times)
    # phase_times are rounded to 4 places: seven roundings of at most 5e-5
    assert (wrapped.phase_times["verify"] + 3.5e-4
            >= sum(wrapped.phase_times[k] for k in VERIFY_PHASES))
    assert ([wrapped.store.seq_str(i) for i in range(len(wrapped.store))]
            == [plain.store.seq_str(i) for i in range(len(plain.store))])
