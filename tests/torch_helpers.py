"""Shared inputs and fixtures for the haploconduct_torch tests.

The two packages share no classes: a test builds the reference's objects
and the port's from the same numpy inputs (`port_store` carries a
reference ReadStore across as plain arrays) and compares arrays, strings
and contigs, never objects."""

import numpy as np
import pytest
import torch

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.utils.simulate import (
    mutate_sequence, random_genome, simulate_reads)
from haploconduct_torch.core.arrays import store_from_arrays


@pytest.fixture(autouse=True, scope="module")
def torch_on_cpu():
    """The torch backend runs on the CPU only when asked (HC_TORCH_DEVICE=cpu,
    the counterpart of the reference tests' JAX_PLATFORMS=cpu): every test
    module that runs it imports this fixture, which asks for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HC_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip where there is none (decided at run time,
    never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_matrix(rng, R, W, lmin, lmax=None):
    """(R, W) codes/quals: random bases and phreds 2-40 over each row's
    random length, pad beyond it."""
    lens = rng.integers(lmin, (lmax or W) + 1, R).astype(np.int64)
    codes = rng.integers(0, 4, (R, W)).astype(np.int8)
    quals = rng.integers(2, 41, (R, W)).astype(np.uint8)
    pad = np.arange(W)[None, :] >= lens[:, None]
    codes[pad] = 5
    quals[pad] = 0
    return codes, quals, lens


def random_tasks(rng, lens, B, slack, row_a_lo=0):
    R = len(lens)
    row_a = rng.integers(row_a_lo, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = (rng.random(B) * np.maximum(1, lens[row_a] - slack)).astype(np.int64)
    return row_a, row_b, pos


def store_arrays(store) -> dict:
    """The plain arrays of a ReadStore (either package's): unit codes and
    quals, ids, unit1/unit2 and the single-end read count."""
    return dict(
        unit_codes=[store.unit_codes(u) for u in range(store.n_units)],
        unit_quals=[store.unit_quals(u) for u in range(store.n_units)],
        ids=list(store.ids), unit1=list(store.unit1), unit2=list(store.unit2),
        readcount_single=store.readcount_single)


def port_store(store):
    """The port's ReadStore holding the same reads as `store`."""
    return store_from_arrays(**store_arrays(store))


def subtask_columns(lens, row_a, row_b, pos):
    """The four int32 subtask columns of segment_tasks for these tasks."""
    from haploconduct_tpu.ops.pallas_score import segment_tasks

    L = np.minimum(lens[row_a] - pos, lens[row_b])
    L = np.where(pos >= lens[row_a], 0, L)
    return segment_tasks(row_a, row_b, pos, L)[:4]


def far_threshold() -> float:
    """A mismatch threshold in the middle of the widest gap between the
    per-lane probabilities phreds 2-40 can give: no f32 rounding moves a
    lane across it, so `rejected` must agree exactly."""
    q = np.arange(2, 41, dtype=np.float32)
    p1 = np.exp(q * np.float32(-np.log(10.0) / 10.0))[:, None]
    p2 = p1.T
    pm = (1 - p1) * (1 - p2) + p1 * p2 / 3
    px = (p1 * (1 - p2) + p2 * (1 - p1)) / 3 + (2 / 9) * p1 * p2
    ps = np.unique(np.concatenate([pm.ravel(), px.ravel()]))
    ps = ps[(ps > 0.01) & (ps < 0.9)]
    i = int(np.argmax(np.diff(ps)))
    return float((ps[i] + ps[i + 1]) / 2)


def dryrun_store():
    """The multi-chip dry run's stage store: 160 reads of 150 bp from a
    2 kb genome, phreds 20-40."""
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 2000))
    store = ReadStore()
    for i in range(160):
        start = int(rng.integers(0, len(genome) - 150 + 1))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(20, 41, 150))
        store.add_single(i, genome[start:start + 150], qual)
    store.readcount_single = 160
    return store


def dryrun_overlaps(store):
    from haploconduct_tpu.io.sfo import sfo_to_overlaps
    from haploconduct_tpu.ops.kmer import find_overlap_candidates

    seqs = [store.unit_codes(u) for u in range(store.n_units)]
    sfo = find_overlap_candidates(seqs, min_overlap_len=80, k=16)
    return sfo_to_overlaps(sfo, len(store), 0)


def multi_strain_reads(seed=5):
    """Two strains of a 1.5 kb genome at 3% divergence, 60x each."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, 1500)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    return simulate_reads(haps, coverage=60, read_len=150, rng=rng,
                          error_rate=0.002)


def make_store(seqs, quals):
    store = ReadStore()
    for i, (s, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, s, q)
    store.readcount_single = len(store.ids)
    return store
