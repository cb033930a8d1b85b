"""The hand-written CUDA scoring kernel on the card, against its plain
PyTorch version and the f64 oracle: integer columns equal, sum_log within
rtol 1e-4 / atol 1e-3. Every test here needs a CUDA card and skips
without one. This file imports no jax, so on a machine without jax run it
alone, past the root conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

from haploconduct_tpu.ops.score import score_tasks_numpy
from haploconduct_tpu.ops.verify import plan_tasks
from haploconduct_torch.ops import kernels
from haploconduct_torch.ops.score import (pack_for_device, score_tasks_torch,
                                          segment_scores_torch)

from test_score import build_random_store, random_overlaps
from torch_helpers import (cuda_device, far_threshold, random_matrix,  # noqa: F401
                           random_tasks, subtask_columns)

CARD_SHAPES = {
    # (R, W, min row length, tasks, slack, lowest row_a)
    "envelope_reads": (20_000, 150, 150, 400_000, 90, 0),
    "kb_contigs": (64, 6200, 4000, 1024, 2000, 0),
    "rows_over_2^16": ((1 << 16) + 512, 64, 40, 4096, 34, (1 << 16) + 512 - 4096),
    "wide_9kb": (1600, 9000, 800, 1024, 100, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(cuda_device, shape):
    R, W, lmin, B, slack, lo = CARD_SHAPES[shape]
    rng = np.random.default_rng(20)
    codes, quals, lens = random_matrix(rng, R, W, lmin)
    cols = [torch.from_numpy(c).to(cuda_device) for c in
            subtask_columns(lens, *random_tasks(rng, lens, B, slack, lo))]
    comb = pack_for_device(codes, quals, cuda_device)
    for th in (0.0, far_threshold()):
        before = kernels.score_segments_cuda.launches
        got = kernels.score_segments_cuda(comb, *cols, th)
        want = segment_scores_torch(comb, *cols, th)
        torch.cuda.synchronize()
        assert kernels.score_segments_cuda.launches == before + 1
        for j in (1, 2, 3):
            assert torch.equal(got[j], want[j])
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_score_tasks_torch_on_card_matches_oracle(cuda_device):
    rng = np.random.default_rng(1)
    store, _ = build_random_store(rng, n_single=20, n_paired=10)
    packed = store.pack()
    ov = random_overlaps(rng, store, 400)
    plan, _ = plan_tasks(store, packed, ov)
    lens_by_row = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens_by_row, plan.row_first,
            plan.row_second, plan.pos)
    before = kernels.score_segments_cuda.launches
    tst = score_tasks_torch(*args, device=cuda_device)
    assert kernels.score_segments_cuda.launches == before + 1
    ts64 = score_tasks_numpy(*args)
    np.testing.assert_array_equal(tst.counted, ts64.counted)
    np.testing.assert_array_equal(tst.mismatches, ts64.mismatches)
    np.testing.assert_array_equal(tst.rejected, ts64.rejected)
    np.testing.assert_allclose(tst.score, ts64.score, atol=2e-4)


@pytest.mark.cuda
def test_kernel_empty_stream_and_bad_columns(cuda_device):
    comb = torch.zeros((4, 8), dtype=torch.int16, device=cuda_device)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    before = kernels.score_segments_cuda.launches
    out = kernels.score_segments_cuda(comb, empty, empty, empty, empty, 0.0)
    assert all(o.shape == (0,) for o in out)
    assert kernels.score_segments_cuda.launches == before
    col64 = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.score_segments_cuda(comb, col64, col64, col64, col64, 0.0)
