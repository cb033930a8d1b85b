"""haploconduct_torch/ops/abundance.py (_em_torch, estimate_abundance) and
utils/log.py against the JAX package. The EM runs 500 f32 steps like the
reference's jax EM, so it is held to the f64 host EM at rtol 1e-4 with an
identical tpm > 0 keep-set."""

import numpy as np
import pytest
import torch

from haploconduct_tpu.core.reads import encode_seq, revcomp_str
from haploconduct_tpu.ops.abundance import PseudoIndex, _em_device, _em_numpy
from haploconduct_tpu.ops.abundance import estimate_abundance as ref_estimate
from haploconduct_torch.assemble.stages import StageResult
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.ops.abundance import _em_torch, estimate_abundance
from haploconduct_torch.utils.log import PhaseTimer
from haploconduct_torch.workflows.savage import _freq_filter

from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


def _random_seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, n))


def _reads_from(rng, seq, n, read_len=60):
    out = []
    for _ in range(n):
        start = int(rng.integers(0, len(seq) - read_len + 1))
        r = seq[start:start + read_len]
        out.append(encode_seq(revcomp_str(r) if rng.random() < 0.5 else r))
    return out


def _em_problem(seed=2):
    """Three contigs sharing a region, one ghost with no reads."""
    rng = np.random.default_rng(seed)
    shared = _random_seq(rng, 200)
    contigs = [_random_seq(rng, 300) + shared, _random_seq(rng, 300) + shared,
               _random_seq(rng, 400), _random_seq(rng, 350)]
    reads = (_reads_from(rng, contigs[0][:300], 200) + _reads_from(rng, contigs[1][:300], 50)
             + _reads_from(rng, shared, 100) + _reads_from(rng, contigs[2], 80))
    index = PseudoIndex([str(i) for i in range(4)], [encode_seq(c) for c in contigs])
    counts, members, _ = index.classify_all(reads)
    keys = list(counts)
    M = np.zeros((len(keys), 4), np.float32)
    for c, key in enumerate(keys):
        M[c, members[key]] = 1.0
    cnt = np.array([counts[k] for k in keys], np.float64)
    eff = np.maximum(index.lengths.astype(np.float64) - 60.0 + 1.0, 1.0)
    return M, cnt, eff


def test_em_torch_matches_numpy_and_jax_em():
    M, cnt, eff = _em_problem()
    a_t = _em_torch(M, cnt, eff, 500)
    a_n = _em_numpy(M, cnt, eff, 500)
    a_d = _em_device(M, cnt, eff, 500)
    assert a_t.dtype == np.float64 and a_t.shape == (4,)
    np.testing.assert_allclose(a_t, a_n, rtol=1e-4)
    np.testing.assert_allclose(a_t, a_d, rtol=1e-4)
    np.testing.assert_array_equal(a_t > 0, a_n > 0)
    np.testing.assert_array_equal(a_t > 0, a_d > 0)
    assert a_t[3] == 0.0 and np.all(a_t[:3] > 0)


@pytest.mark.parametrize("backend", ["torch", "numpy", "native"])
def test_estimate_abundance_matches_reference(backend):
    """Mirror of tests/test_abundance.py:test_em_recovers_abundance_ratio,
    each twin backend against the reference's f64 host EM."""
    rng = np.random.default_rng(1)
    a = _random_seq(rng, 500)
    b = _random_seq(rng, 500)
    ghost = _random_seq(rng, 500)
    reads = _reads_from(rng, a, 300) + _reads_from(rng, b, 100)
    contigs = [encode_seq(a), encode_seq(b), encode_seq(ghost)]
    ref = ref_estimate(["a", "b", "g"], contigs, reads, fragment_len=60.0, backend="numpy")
    got = estimate_abundance(["a", "b", "g"], contigs, reads, fragment_len=60.0,
                             backend=backend)
    assert got.n_pseudoaligned == ref.n_pseudoaligned == 400
    np.testing.assert_allclose(got.tpm, ref.tpm, rtol=1e-4)
    np.testing.assert_array_equal(got.tpm > 0, ref.tpm > 0)
    assert got.tpm[0] / got.tpm[1] == pytest.approx(3.0, rel=0.05)


def test_freq_filter_drops_zero_tpm_contig_with_torch_em():
    """Mirror of tests/test_abundance.py:test_savage_freq_filter_drops_zero_tpm_contig
    through the port's filter with the torch EM, on the port's own store."""
    rng = np.random.default_rng(6)
    a = _random_seq(rng, 400)
    ghost = _random_seq(rng, 400)
    contigs = ReadStore()
    contigs.add_single(0, a, "I" * len(a))
    contigs.add_single(7, ghost, "I" * len(ghost))
    contigs.readcount_single = 2
    reads = ReadStore()
    for i in range(50):
        start = int(rng.integers(0, len(a) - 60))
        reads.add_single(i, a[start:start + 60], "I" * 60)
    reads.readcount_single = 50
    res = StageResult(store=contigs, subreads={0: {}, 7: {}},
                      overlap_lines=[], iterations=1)
    out = _freq_filter(res, reads, fragment_len=60.0, backend="torch")
    assert [int(out.store.ids[i]) for i in range(len(out.store))] == [0]
    assert set(out.subreads) == {0}


def test_phase_timer_spans_in_torch_profiler():
    from torch.profiler import ProfilerActivity, profile

    timer = PhaseTimer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer("verify"):
            torch.ones(4).sum()
        with timer("verify"):
            pass
    assert "verify" in {e.name for e in prof.events()}
    assert set(timer.times) == {"verify"} and timer.times["verify"] > 0.0
