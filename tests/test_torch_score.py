"""haploconduct_torch/ops/score.py against the JAX package's scorers
(xla_segment_body, segment_tasks, score_tasks_jax) and the f64 oracle
(score_tasks_numpy), on the same inputs made from numpy seeds. On the CPU
the scoring kernel's wrapper takes its plain version, score_tasks_plain;
the card tests (tests/test_torch_kernel.py) hold the kernel to it.

Tolerances: integer columns (counted, mismatches, rejected) are exact
everywhere. Task scores against the f64 oracle and the XLA scorer: the
JAX suite's atol 2e-4, and its kb-width drift bound RECHECK_MARGIN / 4.
sum_log, an f32 sum over each 512-lane segment added in f64: atol 2e-4
plus rtol 3.1e-5, the worst-case error of a 512-term f32 sum
(512 * 2^-24 = 3.05e-5 of sum|x|, and sum|x| = |sum_log| since every
log p < 0). The same bound holds per subtask against the XLA body."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haploconduct_tpu.ops import pallas_score
from haploconduct_tpu.ops.pallas_score import pack_for_pallas
from haploconduct_tpu.ops.score import (RECHECK_MARGIN, score_tasks_jax,
                                        score_tasks_numpy, xla_segment_body)
from haploconduct_tpu.ops.verify import plan_tasks
from haploconduct_torch.ops import kernels
from haploconduct_torch.ops import score as tscore
from haploconduct_torch.ops.score import (pack_for_device, score_tasks,
                                          score_tasks_plain, score_tasks_torch,
                                          segment_scores_torch)

from test_score import build_random_store, random_overlaps
from torch_helpers import far_threshold, random_matrix, random_tasks, subtask_columns
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

# (R, W, min row length, tasks, slack of pos below len_a, lowest row_a)
SHAPES = {
    "reads": (400, 150, 150, 3000, 90, 0),
    "kb_contigs": (16, 2600, 1500, 48, 700, 0),
}
# score_tasks_plain's cases: SAVAGE's 150 bp reads, kb contigs over 512
# lanes, more than 2^16 rows, and phreds up to 255 (above the kernel's
# table: such lanes take its inline branch)
PLAIN_CASES = {
    "reads_150bp": (400, 150, 150, 2000, 90, 0),
    "kb_contigs": (16, 2600, 1500, 48, 700, 0),
    "rows_over_2^16": ((1 << 16) + 64, 24, 16, 512, 12, (1 << 16) - 448),
    "quals_to_255": (200, 150, 100, 1000, 60, 0),
}


def _assert_task_scores_equal_ints(got, ref):
    np.testing.assert_array_equal(got.counted, ref.counted)
    np.testing.assert_array_equal(got.mismatches, ref.mismatches)
    np.testing.assert_array_equal(got.rejected, ref.rejected)


def _cpu_columns(codes, quals, lens, row_a, row_b, pos):
    return (pack_for_device(codes, quals, "cpu"),
            *(torch.from_numpy(np.asarray(c, np.int32)) for c in (lens, row_a, row_b, pos)))


def test_pack_for_device_matches_pack_for_pallas():
    """The same code | qual << 3 words; rows padded with PAD words to a
    multiple of 8 words (16 bytes) instead of the TPU's 128 + slack."""
    store, _ = build_random_store(np.random.default_rng(0))
    packed = store.pack()
    R, W = packed.codes.shape
    comb = pack_for_device(packed.codes, packed.quals, "cpu")
    rw = -(-W // 8) * 8
    assert comb.dtype == torch.int16 and tuple(comb.shape) == (R, rw)
    np.testing.assert_array_equal(
        comb.numpy()[:, :W], pack_for_pallas(packed.codes, packed.quals)[:R, :W])
    assert (comb.numpy()[:, W:] == 5).all()


def test_segment_tasks_matches_reference():
    rng = np.random.default_rng(13)
    lens = rng.integers(0, 3000, 64).astype(np.int64)
    row_a, row_b, pos = random_tasks(rng, lens, 500, 100)
    L = np.where(pos >= lens[row_a], 0, np.minimum(lens[row_a] - pos, lens[row_b]))
    got = tscore.segment_tasks(row_a, row_b, pos, L)
    want = pallas_score.segment_tasks(row_a, row_b, pos, L)
    assert tscore.SEG == pallas_score.SEG
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("thresh", ["zero", "far"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_segment_scores_match_xla_body(shape, thresh):
    R, W, lmin, B, slack, _ = SHAPES[shape]
    rng = np.random.default_rng(10)
    codes, quals, lens = random_matrix(rng, R, W, lmin)
    cols = subtask_columns(lens, *random_tasks(rng, lens, B, slack))
    th = 0.0 if thresh == "zero" else far_threshold()
    ref = xla_segment_body(th)(jnp.asarray(pack_for_pallas(codes, quals)),
                               *(jnp.asarray(c) for c in cols))
    got = segment_scores_torch(pack_for_device(codes, quals, "cpu"),
                               *(torch.from_numpy(c) for c in cols), th)
    for j in (1, 2, 3):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(ref[j]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=3.1e-5, atol=1e-4)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    if thresh == "far":
        assert int(got[3].sum()) > 0  # the threshold is exercised


def test_segment_scores_plain_chunks_agree():
    """The plain version's chunking over the subtask stream changes no
    result (PLAIN_CHUNK boundaries fall inside this stream)."""
    rng = np.random.default_rng(12)
    codes, quals, lens = random_matrix(rng, 64, 150, 100)
    cols = [torch.from_numpy(c) for c in
            subtask_columns(lens, *random_tasks(rng, lens, 1000, 50))]
    comb = pack_for_device(codes, quals, "cpu")
    whole = segment_scores_torch(comb, *cols, 0.0)
    old = tscore.PLAIN_CHUNK
    try:
        tscore.PLAIN_CHUNK = 97
        chunked = segment_scores_torch(comb, *cols, 0.0)
    finally:
        tscore.PLAIN_CHUNK = old
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("thresh", ["zero", "far"])
@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_score_tasks_plain_matches_jax_and_oracle(case, thresh):
    R, W, lmin, B, slack, lo = PLAIN_CASES[case]
    rng = np.random.default_rng(30)
    codes, quals, lens = random_matrix(rng, R, W, lmin)
    if case == "quals_to_255":
        quals = np.where(codes < 5, rng.integers(0, 256, quals.shape), 0).astype(np.uint8)
    row_a, row_b, pos = random_tasks(rng, lens, B, slack, lo)
    # degenerate tasks among them: pos at and past len_a
    pos[:3] = lens[row_a[:3]] + np.arange(3)
    th = 0.0 if thresh == "zero" else far_threshold()
    sum_log, counted, mism, rej = score_tasks_plain(
        *_cpu_columns(codes, quals, lens, row_a, row_b, pos), th)
    assert sum_log.dtype == torch.float64 and counted.dtype == torch.int32
    oracle = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos, mismatch_thresh=th)
    np.testing.assert_array_equal(counted.numpy(), oracle.counted)
    np.testing.assert_array_equal(mism.numpy(), oracle.mismatches)
    np.testing.assert_array_equal(rej.numpy() > 0, oracle.rejected)
    np.testing.assert_allclose(sum_log.numpy(), oracle.sum_log, atol=2e-4, rtol=3.1e-5)
    assert (counted.numpy()[:3] == 0).all()
    if th > 0:
        assert oracle.rejected.any()  # the threshold is exercised
    got = score_tasks_torch(codes, quals, lens, row_a, row_b, pos, mismatch_thresh=th)
    xla = score_tasks_jax(codes, quals, lens, row_a, row_b, pos, mismatch_thresh=th)
    _assert_task_scores_equal_ints(got, oracle)
    _assert_task_scores_equal_ints(got, xla)
    np.testing.assert_array_equal(got.mismatch_rate, oracle.mismatch_rate)
    np.testing.assert_allclose(got.score, oracle.score, atol=2e-4)
    np.testing.assert_allclose(got.score, xla.score, atol=2e-4)


def test_score_tasks_plain_adds_segments_in_f64():
    """A task's sum is its segments' f32 sums added in f64: the plain
    version equals the per-subtask body summed with np.add.reduceat."""
    rng = np.random.default_rng(31)
    codes, quals, lens = random_matrix(rng, 16, 2600, 1500)
    row_a, row_b, pos = random_tasks(rng, lens, 40, 700)
    comb, lens_t, *cols = _cpu_columns(codes, quals, lens, row_a, row_b, pos)
    L = np.where(pos >= lens[row_a], 0, np.minimum(lens[row_a] - pos, lens[row_b]))
    *sub_cols, bounds = tscore.segment_tasks(row_a, row_b, pos, L)
    assert len(sub_cols[0]) > 2 * len(row_a)  # tasks of several segments
    sub = segment_scores_torch(comb, *(torch.from_numpy(c) for c in sub_cols), 0.0)
    want = np.add.reduceat(sub[0].numpy().astype(np.float64), bounds)
    got = score_tasks_plain(comb, lens_t, *cols, 0.0)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("kw", [{}, {"mismatch_thresh": "far", "min_read_len": 45}],
                         ids=["default", "thresh_minlen"])
def test_score_tasks_torch_matches_jax_and_oracle(kw):
    """Mirror of tests/test_score.py:test_jax_matches_oracle."""
    kw = dict(kw)
    if kw.get("mismatch_thresh") == "far":
        kw["mismatch_thresh"] = far_threshold()
    rng = np.random.default_rng(1)
    store, _ = build_random_store(rng, n_single=20, n_paired=10)
    packed = store.pack()
    ov = random_overlaps(rng, store, 400)
    plan, _ = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens_by_row, plan.row_first,
            plan.row_second, plan.pos)
    ts64 = score_tasks_numpy(*args, **kw)
    tsj = score_tasks_jax(*args, **kw, batch_size=128)
    tst = score_tasks_torch(*args, **kw, device="cpu")
    _assert_task_scores_equal_ints(tst, ts64)
    _assert_task_scores_equal_ints(tst, tsj)
    np.testing.assert_array_equal(tst.mismatch_rate, ts64.mismatch_rate)
    np.testing.assert_allclose(tst.score, ts64.score, atol=2e-4)
    np.testing.assert_allclose(tst.score, tsj.score, atol=2e-4)


def test_score_tasks_torch_drift_at_kb_widths():
    """Mirror of tests/test_score.py:test_jax_segmented_drift_at_kb_widths:
    f32 sums stay per 512-lane segment, so multi-kb tasks keep their
    drift from the f64 oracle inside the recheck budget."""
    rng = np.random.default_rng(23)
    R, W = 64, 6200
    codes = np.full((R, W), 4, np.int8)
    quals = np.zeros((R, W), np.uint8)
    lens = rng.integers(4000, W + 1, R).astype(np.int64)
    for i in range(R):
        codes[i, :lens[i]] = rng.integers(0, 4, lens[i])
        quals[i, :lens[i]] = rng.integers(2, 41, lens[i])
    B = 256
    row_a = rng.integers(0, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = np.array([rng.integers(0, max(1, lens[a] - 2000)) for a in row_a],
                   np.int64)
    tt = score_tasks_torch(codes, quals, lens, row_a, row_b, pos)
    to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos)
    np.testing.assert_array_equal(tt.counted, to.counted)
    np.testing.assert_array_equal(tt.mismatches, to.mismatches)
    drift = np.max(np.abs(tt.score - to.score))
    assert drift < RECHECK_MARGIN / 4, drift


def test_score_tasks_torch_degenerate_tasks():
    """pos >= len_a, min_read_len unmet, all-N windows and an empty task
    list score exactly as the oracle leaves them."""
    rng = np.random.default_rng(4)
    codes, quals, lens = random_matrix(rng, 8, 40, 10)
    codes[3, :] = 4  # an all-N row
    lens[3] = 40
    row_a = np.array([0, 1, 3, 2, 5], np.int64)
    row_b = np.array([1, 3, 4, 2, 6], np.int64)
    pos = np.array([lens[0], 0, 0, 1, 2], np.int64)
    for kw in ({}, {"min_read_len": 30}):
        tt = score_tasks_torch(codes, quals, lens, row_a, row_b, pos, **kw)
        to = score_tasks_numpy(codes, quals, lens, row_a, row_b, pos, **kw)
        _assert_task_scores_equal_ints(tt, to)
        np.testing.assert_array_equal(tt.mismatch_rate, to.mismatch_rate)
        np.testing.assert_array_equal(tt.score == 0.0, to.score == 0.0)
        np.testing.assert_allclose(tt.score, to.score, atol=2e-4)
    empty = score_tasks_torch(codes, quals, lens, row_a[:0], row_b[:0], pos[:0])
    assert all(len(a) == 0 for a in empty)


@pytest.mark.parametrize("bad", ["neg_pos", "row_range", "len_over_width"])
def test_score_tasks_torch_rejects_bad_input(bad):
    """The kernel gathers without bounds checks, so its host side refuses
    what it cannot score."""
    rng = np.random.default_rng(5)
    codes, quals, lens = random_matrix(rng, 6, 30, 10)
    row_a, row_b, pos = np.array([0, 1]), np.array([2, 3]), np.array([0, 1])
    if bad == "neg_pos":
        pos = np.array([0, -1])
    elif bad == "row_range":
        row_b = np.array([2, 6])
    else:
        lens = lens.copy()
        lens[4] = 31
    with pytest.raises(ValueError):
        score_tasks_torch(codes, quals, lens, row_a, row_b, pos)


def test_cuda_device_raises_without_cuda():
    """Asked for the card on a host without one, scoring raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rng = np.random.default_rng(6)
    codes, quals, lens = random_matrix(rng, 6, 30, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_tasks_torch(codes, quals, lens, np.array([0]), np.array([1]),
                          np.array([0]), device="cuda")


def test_cpu_tensors_take_the_plain_version():
    """The wrapper takes the plain version only for a tensor on the CPU,
    without counting a launch; the kernel itself refuses a CPU tensor."""
    rng = np.random.default_rng(7)
    codes, quals, lens = random_matrix(rng, 16, 60, 30)
    cols = _cpu_columns(codes, quals, lens, *random_tasks(rng, lens, 50, 10))
    before = kernels.score_tasks_cuda.launches
    got = score_tasks(*cols, 0.0)
    want = score_tasks_plain(*cols, 0.0)
    assert kernels.score_tasks_cuda.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kernels.score_tasks_cuda(*cols, 0.0)
