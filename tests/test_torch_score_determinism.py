"""The plain scoring version (haploconduct_torch/ops/score.py:
score_tasks_plain) gives the same bits whatever the intra-op thread count,
however the tasks are cut into calls, and in a process's first call as in
its second. Each lane's p and log p are gathered from tables computed once
(lane_tables) and the lanes summed in a fixed order (lane_sum), so no
torch exp, log or reduction order of the call decides a bit. Inputs: the
multi-segment case of tests/test_torch_mesh.py (tasks of up to three
512-lane segments). The join's plain version (haploconduct_torch/ops/
join_verify.py:join_verify_plain) is held the same way on
tests/test_torch_pipeline.py's overlapping rows: its lanes come from the
same table, summed by lane_sum, and its exp is fixed_exp."""

import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from haploconduct_torch.ops import join_verify, score
from haploconduct_torch.ops.score import pack_for_device, score_tasks_plain

from test_torch_mesh import multi_segment_case
from test_torch_pipeline import overlapping_rows
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
# a process's first call on a sub-batch of this many tasks is where the
# thread-dependent lanes showed (one intra-op thread's share of them)
FIRST_CUT = 300


def _columns(args):
    codes, quals, lens, row_a, row_b, pos = args
    comb = pack_for_device(codes, quals, "cpu")
    cols = [torch.from_numpy(c.astype(np.int32)) for c in (lens, row_a, row_b, pos)]
    return comb, cols


def _plain(comb, cols, thresh, span=slice(None)):
    lens, row_a, row_b, pos = cols
    return [c.numpy().copy() for c in score_tasks_plain(
        comb, lens, row_a[span], row_b[span], pos[span], thresh)]


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()


def _off_by_one_ulp(fn):
    """fn, with the first half of its floating outputs moved one ulp up."""
    def moved(x, *a, **k):
        out = fn(x, *a, **k)
        if out.is_floating_point() and out.numel() > 1:
            half = out.reshape(-1)[: out.numel() // 2]
            half.copy_(torch.nextafter(half, torch.full_like(half, float("inf"))))
        return out
    return moved


def _at_threads(threads, fn, *args):
    """fn(*args) with torch on `threads` intra-op threads."""
    saved = torch.get_num_threads()
    try:
        torch.set_num_threads(threads)
        return fn(*args)
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def start_threads():
    """The process's thread count; the module's tests run on one thread
    unless they set their own count. The suite runs in several worker
    processes on shared cores, where idle intra-op threads spin against
    the other workers: a step of this module's small ops then took up to
    hundreds of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield n
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(start_threads):
    """The multi-segment case and its bits at the process's thread count."""
    comb, cols = _columns(multi_segment_case())
    return comb, cols, {th: _at_threads(start_threads, _plain, comb, cols, th)
                        for th in (0.0, 0.3)}


@pytest.mark.parametrize("threads", [1, 2, 3, 7])
@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_bits_equal_under_every_thread_count(case, threads, thresh):
    comb, cols, want = case
    _assert_bits(_at_threads(threads, _plain, comb, cols, thresh), want[thresh])


@pytest.mark.parametrize("batch", [1, 7, 100, FIRST_CUT, 511])
def test_bits_equal_over_sub_batches(case, batch):
    comb, cols, want = case
    n = cols[1].shape[0]
    parts = [_plain(comb, cols, 0.3, slice(s, s + batch)) for s in range(0, n, batch)]
    _assert_bits([np.concatenate(c) for c in zip(*parts)], want[0.3])


def test_lanes_do_not_depend_on_how_torch_takes_exp_and_log(case, monkeypatch):
    """torch's exp and log on the CPU once gave one intra-op thread's share
    of a process's first call values up to 5e-6 away from later calls'.
    Emulated here: both move the first half of their outputs one ulp; the
    plain version's bits must not move."""
    comb, cols, want = case
    if hasattr(score, "lane_tables"):  # computed anew under the patch
        score.lane_tables.cache_clear()
    monkeypatch.setattr(torch, "exp", _off_by_one_ulp(torch.exp))
    monkeypatch.setattr(torch, "log", _off_by_one_ulp(torch.log))
    for thresh in (0.0, 0.3):
        _assert_bits(_plain(comb, cols, thresh), want[thresh])


def _join(args):
    return [c.numpy().copy() for c in join_verify.join_verify_plain(*args)]


@pytest.fixture(scope="module")
def join_case(start_threads):
    """The overlapping rows and their bits at the process's thread count."""
    comb, lens, t_rid, t_pos, left, count, nk = overlapping_rows()
    args = (comb, lens, t_rid, t_pos, left, count, 0, nk, 8, 30, 0.97)
    want = _at_threads(start_threads, _join, args)
    assert np.any(want[0] > 0) and want[1][0] > 0
    return args, want


@pytest.mark.parametrize("threads", [1, 2, 3, 7])
def test_join_bits_equal_under_every_thread_count(join_case, threads):
    args, want = join_case
    _assert_bits(_at_threads(threads, _join, args), want)


@pytest.mark.parametrize("kmers_a_step", [37, 333, 4096])
def test_join_bits_equal_over_steps(join_case, kmers_a_step, monkeypatch):
    """The plain version's steps of PLAIN_LANES lanes, cut to 37, 333 and
    4,096 query k-mers a step (the case has 41,400)."""
    args, want = join_case
    comb, nk, expand = args[0], args[7], args[8]
    monkeypatch.setattr(join_verify, "PLAIN_LANES", kmers_a_step * expand * comb.shape[1])
    _assert_bits(_join(args), want)


def test_join_does_not_depend_on_how_torch_takes_exp_and_log(join_case, monkeypatch):
    args, want = join_case
    score.lane_tables.cache_clear()  # computed anew under the patch
    monkeypatch.setattr(torch, "exp", _off_by_one_ulp(torch.exp))
    monkeypatch.setattr(torch, "log", _off_by_one_ulp(torch.log))
    _assert_bits(_join(args), want)


def test_fixed_exp_is_f64_exp_rounded_to_f32():
    x = np.random.default_rng(5).uniform(-40.0, 0.0, 100_000).astype(np.float32)
    x[:3] = (0.0, -1e-30, -39.5)
    want = np.exp(x.astype(np.float64)).astype(np.float32)
    got = score.fixed_exp(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


FRESH = textwrap.dedent("""
    import hashlib, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[2])
    from haploconduct_torch.ops.score import pack_for_device, score_tasks_plain

    z = np.load(sys.argv[1])
    comb = pack_for_device(z["codes"], z["quals"], "cpu")
    lens, ra, rb, pos = (torch.from_numpy(z[k].astype(np.int32))
                         for k in ("lens", "row_a", "row_b", "pos"))
    cut = int(sys.argv[3])
    for _ in range(2):
        sums = score_tasks_plain(comb, lens, ra[:cut], rb[:cut], pos[:cut], 0.0)
        print(hashlib.sha256(b"".join(c.numpy().tobytes() for c in sums)).hexdigest())
""")


def test_first_and_second_call_of_fresh_processes(case, tmp_path):
    """Eight fresh processes (the default thread count, one at a time):
    each one's first and second call give the bits of this process's
    call."""
    comb, cols, _ = case
    codes, quals, lens, row_a, row_b, pos = multi_segment_case()
    path = tmp_path / "case.npz"
    np.savez(path, codes=codes, quals=quals, lens=lens, row_a=row_a, row_b=row_b,
             pos=pos)
    expect = hashlib.sha256(b"".join(
        c.tobytes() for c in _plain(comb, cols, 0.0, slice(0, FIRST_CUT)))).hexdigest()
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    for run in range(8):
        proc = subprocess.run([sys.executable, "-c", FRESH, str(path), str(REPO),
                               str(FIRST_CUT)], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == [expect, expect], f"run {run}"
