"""haploconduct_torch/ops/abundance.py (_em_torch, estimate_abundance) and
utils/log.py against the JAX package. The torch EM runs the f64 host EM's
500 steps in torch ops: it is held to the reference's f32 device EM at
rtol 1e-4 with an identical tpm > 0 keep-set where that EM does not
underflow, and to the f64 host EMs at rtol 1e-9 with an identical keep-set
where it does (a contig whose reads are all shared with a stronger one)."""

import numpy as np
import pytest
import torch

from haploconduct_tpu.core.reads import encode_seq, revcomp_str
from haploconduct_tpu.ops.abundance import PseudoIndex, _em_device, _em_numpy
from haploconduct_torch.ops.abundance import _em_numpy as port_em_numpy
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


@pytest.mark.parametrize("counts", [[100, 150], [100, 233], [100, 300]])
def test_em_torch_keeps_a_shadowed_contig_like_the_f64_em(counts):
    """Contig 1's reads all lie in contig 0's class too, so its mass decays
    geometrically: after 500 steps it is below f32's range (an f32 EM gives
    0.0 and the filter drops it) but positive in f64."""
    M = np.array([[1, 1], [1, 0]], np.float32)
    cnt = np.array(counts, np.float64)
    eff = np.ones(2)
    got = _em_torch(M, cnt, eff, 500)
    for want in (port_em_numpy(M, cnt, eff, 500), _em_numpy(M, cnt, eff, 500)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        np.testing.assert_array_equal(got > 0, want > 0)
    assert got.dtype == np.float64 and 0.0 < got[1] < 1e-190


def _shadowed_panel(seed=4):
    """Contig 0 = X + Y, contig 1 = Y alone; most reads from X: every read
    that contig 1 explains, contig 0 explains too."""
    rng = np.random.default_rng(seed)
    x, y = _random_seq(rng, 400), _random_seq(rng, 200)
    contigs = [x + y, y]
    reads = _reads_from(rng, x, 300) + _reads_from(rng, y, 50)
    return contigs, reads


def test_abundance_and_filter_keep_a_shadowed_contig_like_numpy():
    contigs, reads = _shadowed_panel()
    codes = [encode_seq(c) for c in contigs]
    got = estimate_abundance(["0", "1"], codes, reads, fragment_len=60.0,
                             backend="torch")
    want = estimate_abundance(["0", "1"], codes, reads, fragment_len=60.0,
                              backend="numpy")
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(got.tpm > 0, want.tpm > 0)
    assert np.all(want.tpm > 0) and got.tpm[1] < 1e-20 * got.tpm[0]

    store = ReadStore()
    for i, c in zip((3, 8), contigs):
        store.add_single(i, c, "I" * len(c))
    store.readcount_single = 2
    read_store = ReadStore()
    for i, r in enumerate(reads):
        read_store.add_single_codes(i, r, np.full(len(r), 40, np.uint8))
    read_store.readcount_single = len(reads)
    kept = {}
    for backend in ("torch", "numpy"):
        res = StageResult(store=store, subreads={3: {}, 8: {}},
                          overlap_lines=[], iterations=1)
        out = _freq_filter(res, read_store, fragment_len=60.0, backend=backend)
        kept[backend] = [out.store.seq_str(i) for i in range(len(out.store))]
    assert kept["torch"] == kept["numpy"] == contigs


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
