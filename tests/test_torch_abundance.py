"""haploconduct_torch/ops/abundance.py (_em_torch, estimate_abundance) and
utils/log.py against the JAX package. The torch EM runs the f64 host EM's
500 steps in torch ops: it is held to the reference's f32 device EM at
rtol 1e-4 with an identical tpm > 0 keep-set where that EM does not
underflow, and to the f64 host EMs at rtol 1e-9 with an identical keep-set
where it does (a contig whose reads are all shared with a stronger one).
SAVAGE's filter over several ranks: each classifies a contiguous slice of
the reads and the slices' classes merge, in rank order, into one pass's."""

import json

import numpy as np
import pytest
import torch

from haploconduct_tpu.core.reads import ReadStore as RefReadStore
from haploconduct_tpu.core.reads import encode_seq, revcomp_str
from haploconduct_tpu.assemble.stages import StageResult as RefStageResult
from haploconduct_tpu.io.subreads import subreads_from_text as ref_subreads_from_text
from haploconduct_tpu.io.subreads import subreads_to_text as ref_subreads_to_text
from haploconduct_tpu.workflows.savage import _freq_filter as ref_freq_filter
from haploconduct_tpu.ops.abundance import PseudoIndex, _em_device, _em_numpy
from haploconduct_torch.ops.abundance import _em_numpy as port_em_numpy
from haploconduct_tpu.ops.abundance import estimate_abundance as ref_estimate
from haploconduct_torch.assemble.stages import StageResult
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.ops.abundance import (
    PseudoIndex as PortPseudoIndex, _em_torch, estimate_abundance, merge_classes,
    store_unit_seqs)
from haploconduct_torch.parallel.distributed import (
    allgather_classes, decode_store_subreads, encode_store_subreads)
from haploconduct_torch.utils.log import PhaseTimer
from haploconduct_torch.workflows import savage
from haploconduct_torch.workflows.savage import _freq_filter

from test_torch_global_mesh import rank_json, run_ranks
from test_torch_global_workflows import savage_store
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


@pytest.fixture(scope="module")
def filter_input(torch_on_cpu):  # noqa: F811
    """The inputs of SAVAGE's filter after stage b, as run_savage hands them
    over on two strains of a 1.2 kb genome at 15x each (300 reads of 120 bp)
    in 2 patches: the stage's 30 contigs, of which the filter drops 16, and
    the sample's reads, as the JSON of parallel/distributed.py."""
    calls = []

    def capture(res, read_store, fragment_len, *a, **k):
        calls.append({"stage": encode_store_subreads(res.store, res.subreads),
                      "reads": encode_store_subreads(read_store, None),
                      "fragment_len": fragment_len})
        return real(res, read_store, fragment_len, *a, **k)

    real = savage._freq_filter
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(savage, "_freq_filter", capture)
        savage.run_savage(savage_store(1200, 15), savage.SavageConfig(
            split_num=2, backend="torch", min_clique_size=4))
    return json.loads(json.dumps(calls[0]))


def _port_filter_args(blob):
    store, sub = decode_store_subreads(blob["stage"])
    reads, _ = decode_store_subreads(blob["reads"])
    res = StageResult(store=store, subreads=sub, overlap_lines=[], iterations=1)
    return res, reads, blob["fragment_len"]


@pytest.mark.parametrize("cuts", [(), (0.5,), (0.0, 0.3), (0.25, 0.5, 0.75),
                                  (0.1, 0.1, 0.4, 0.4, 0.9, 1.0)])
def test_slices_merged_in_order_are_one_classify_all_pass(filter_input, cuts):
    """1, 2, 3, 4 and 7 contiguous slices of the filter's reads, some empty,
    each classified and carried through allgather_classes' blob (one
    process: its encoding and decoding alone), merged in slice order: the
    class order, counts, members and n_aligned of one pass."""
    res, reads, _ = _port_filter_args(filter_input)
    index = PortPseudoIndex([str(i) for i in res.store.ids],
                            [res.store.unit_codes(u) for u in res.store.unit1])
    seqs = store_unit_seqs(reads)
    bounds = [0] + [int(round(c * len(seqs))) for c in cuts] + [len(seqs)]
    parts = []
    for lo, hi in zip(bounds, bounds[1:]):
        [part] = allgather_classes(*index.classify_all(seqs[lo:hi]))
        parts.append(part)
    counts, members, n_aligned = merge_classes(parts)
    want_counts, want_members, want_aligned = index.classify_all(seqs)
    assert len(want_counts) > 1 and want_aligned > 0
    assert list(counts.items()) == list(want_counts.items())
    assert list(members) == list(want_members)
    for key, mem in want_members.items():
        assert members[key].dtype == mem.dtype == np.int32
        np.testing.assert_array_equal(members[key], mem)
    assert n_aligned == want_aligned


FILTER_BODY = """
    from haploconduct_torch.assemble.stages import StageResult
    from haploconduct_torch.parallel.distributed import (
        decode_store_subreads, encode_store_subreads)
    from haploconduct_torch.workflows.savage import _freq_filter

    with open(os.path.join(workdir, "filter.json")) as f:
        blob = json.load(f)
    store, sub = decode_store_subreads(blob["stage"])
    reads, _ = decode_store_subreads(blob["reads"])
    res = StageResult(store=store, subreads=sub, overlap_lines=[], iterations=1)
    timings = {}
    out = _freq_filter(res, reads, blob["fragment_len"], "torch", timings)
    save_json({"kept": encode_store_subreads(out.store, out.subreads),
               "timings": timings, "collectives": collectives})
"""


def test_two_rank_filter_keeps_the_one_process_and_reference_contigs(tmp_path, filter_input):
    """_freq_filter on two gloo ranks with the same stage result and reads:
    each rank classifies its half of the reads, the ranks gather their
    classes, and each keeps the contigs, ids and subreads of the
    one-process call and of the JAX package's filter (its f64 host EM)."""
    res, reads, fragment_len = _port_filter_args(filter_input)
    timings = {}
    one = _freq_filter(res, reads, fragment_len, "torch", timings)
    assert timings == {"filter_reads": 300, "filter_reads_classified": 300}
    want = json.loads(json.dumps(encode_store_subreads(one.store, one.subreads)))
    assert 0 < len(want["singles"]) < len(res.store)

    ref_store = RefReadStore()
    for rid, seq, phred in filter_input["stage"]["singles"]:
        ref_store.add_single(int(rid), seq, phred)
    ref_store.readcount_single = len(ref_store.ids)
    ref_reads = RefReadStore()
    for rid, seq, phred in filter_input["reads"]["singles"]:
        ref_reads.add_single(int(rid), seq, phred)
    ref_reads.readcount_single = len(ref_reads.ids)
    ref = ref_freq_filter(
        RefStageResult(store=ref_store, overlap_lines=[], iterations=1,
                       subreads=ref_subreads_from_text(filter_input["stage"]["subreads"])),
        ref_reads, fragment_len, "numpy")
    assert [[int(ref.store.ids[i]), ref.store.seq_str(i), ref.store.phred_str(i)]
            for i in range(len(ref.store))] == want["singles"]
    assert ref_subreads_to_text(ref.subreads) == want["subreads"]

    (tmp_path / "filter.json").write_text(json.dumps(filter_input))
    run_ranks(tmp_path, FILTER_BODY, 2, timeout=120)
    for rank, (lo, hi) in enumerate([(0, 150), (150, 300)]):
        got = rank_json(tmp_path, rank)
        assert got["kept"] == want
        assert got["timings"]["filter_reads"] == 300
        assert got["timings"]["filter_reads_classified"] == hi - lo
        assert got["timings"]["filter_gather_wait_s"] >= 0.0
        assert "all_gather_object" in got["collectives"]
