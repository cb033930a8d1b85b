"""The port's k-mer sort-join (haploconduct_torch/ops/kmer_device.py) against
the JAX package's jnp join on jax-CPU: the SFO arrays must be bit-equal on
every input, including hash groups of more than `expand` = 32 entries
(where the stable table order decides which candidates exist) and of more
than `max_group` = 512 (which are dropped)."""

import numpy as np
import pytest

from haploconduct_tpu.core.reads import encode_seq
from haploconduct_tpu.ops.kmer_device import \
    find_overlap_candidates_device as jax_join
from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
from haploconduct_torch.ops import kmer_device
from haploconduct_torch.ops.kmer_device import find_overlap_candidates_device
from haploconduct_torch.workflows.polyte import single_end_candidates

from torch_helpers import make_store, port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes on shared cores: torch's
    many small CPU ops here run on one thread, so idle intra-op threads do
    not spin against the other workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_sfo_equal(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    for f in want.dtype.names:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def tandem_repeat_seqs(seed=3):
    """Low-complexity sequences: ten copies of a 20 bp tandem repeat make
    hash groups of 33-512 table entries, four poly-A runs a group of more
    than 512; random sequences, N codes and lengths 150-259 around them."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 20).astype(np.int8)
    seqs = []
    for i in range(24):
        length = int(rng.integers(150, 260))
        if i < 10:
            s = np.tile(unit, length // 20 + 2)[i % 20:i % 20 + length].copy()
        elif i < 14:
            s = np.zeros(length, np.int8)
        else:
            s = rng.integers(0, 4, length).astype(np.int8)
        if i % 4 == 1:
            s[rng.integers(0, length, 2)] = 4  # N
        seqs.append(s)
    return seqs


def test_join_matches_jax_on_reads(monkeypatch):
    """The input of tests/test_workflows.py:test_device_kmer_join_matches_host
    (error_rate 0.02, verify on); chunked expansion gives the same array."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 3000)
    seqs_s, _ = simulate_reads([genome], coverage=8, read_len=180, rng=rng,
                               error_rate=0.003)
    seqs = [encode_seq(s) for s in seqs_s]
    kw = dict(min_overlap_len=90, k=15, expand=32, max_group=512,
              error_rate=0.02, verify=True)
    want = jax_join(seqs, **kw)
    assert len(want) > 0
    assert_sfo_equal(find_overlap_candidates_device(seqs, **kw), want)
    monkeypatch.setattr(kmer_device, "CHUNK_SLOTS", 64)
    assert_sfo_equal(find_overlap_candidates_device(seqs, **kw), want)


@pytest.mark.parametrize("verify", [False, True])
def test_join_matches_jax_on_large_hash_groups(verify):
    seqs = tandem_repeat_seqs()
    for mol, err in ((40, 0.0), (100, 0.05)):
        kw = dict(min_overlap_len=mol, error_rate=err, verify=verify)
        want = jax_join(seqs, **kw)
        got = find_overlap_candidates_device(seqs, **kw)
        assert len(want) > 0
        assert_sfo_equal(got, want)
    # both guards really cut here: a wider expansion and a larger group
    # bound each find more candidates
    kw = dict(min_overlap_len=40, verify=verify)
    base = len(find_overlap_candidates_device(seqs, **kw))
    assert len(find_overlap_candidates_device(seqs, expand=64, **kw)) > base
    assert len(find_overlap_candidates_device(seqs, max_group=4096, **kw)) > base


def test_join_matches_jax_with_n_codes_and_unequal_lengths():
    rng = np.random.default_rng(8)
    genome = random_genome(rng, 2500)
    seqs = []
    for _ in range(70):
        length = int(rng.integers(60, 400))
        start = int(rng.integers(0, len(genome) - length))
        s = encode_seq(genome[start:start + length])
        s[rng.random(length) < 0.004] = 4
        seqs.append(s)
    kw = dict(min_overlap_len=50, error_rate=0.0, verify=True)
    want = jax_join(seqs, **kw)
    assert len(want) > 0
    assert_sfo_equal(find_overlap_candidates_device(seqs, **kw), want)


@pytest.mark.parametrize("chunk_slots", [1, 33, 1000])
def test_chunked_expansion_matches_unchunked(monkeypatch, chunk_slots):
    seqs = tandem_repeat_seqs(seed=4)
    kw = dict(min_overlap_len=40, verify=False)
    whole = find_overlap_candidates_device(seqs, **kw)
    monkeypatch.setattr(kmer_device, "CHUNK_SLOTS", chunk_slots)
    assert_sfo_equal(find_overlap_candidates_device(seqs, **kw), whole)


def test_single_end_candidates_device_matches_host():
    """Mirror of tests/test_workflows.py:test_single_end_candidates_engine_equality
    through the twin: on an exact pass over contigs, the torch join gives
    the host engine's verified overlaps; the join's call is counted."""
    rng = np.random.default_rng(9)
    genome = random_genome(rng, 4000)
    store = port_store(make_store(*simulate_reads([genome], coverage=6, read_len=400,
                                                  rng=rng, error_rate=0.0)))
    before = kmer_device.JOIN_CALLS.get("cpu", 0)
    host = single_end_candidates(store, 50, 0.0, engine="host")
    assert kmer_device.JOIN_CALLS.get("cpu", 0) == before
    dev = single_end_candidates(store, 50, 0.0, engine="device")
    assert kmer_device.JOIN_CALLS["cpu"] == before + 1
    assert len(host) == len(dev) > 0
    for f in host.dtype.names:
        np.testing.assert_array_equal(host[f], dev[f])


def test_auto_engine_stays_on_host_without_a_card():
    from haploconduct_torch.workflows.polyte import _resolve_engine

    assert _resolve_engine("auto", 100, 0.0, 500) == "host"  # no CUDA here
    assert _resolve_engine("device", 100, 0.02, 500) == "device"
    assert _resolve_engine("host", 100, 0.0, 500) == "host"


def test_join_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    seqs = [encode_seq("ACGT" * 20)] * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        find_overlap_candidates_device(seqs, 30, device=torch.device("cuda"))
