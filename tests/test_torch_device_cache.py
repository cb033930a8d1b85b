"""haploconduct_torch/ops/device_cache.py against the JAX package's
ops/device_cache.py: on the same numpy inputs the twin's cache must make
the reference's decisions (which rows are reused from which old row,
which are re-sent, when a call uploads everything), count them in
TRANSFER_STATS exactly as the reference counts them, and return the
matrix a fresh pack would give, bit for bit."""

import inspect
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from haploconduct_tpu.core.reads import ReadStore, revcomp_codes
from haploconduct_tpu.ops import device_cache as ref_dc
from haploconduct_torch.ops import device_cache as dc
from haploconduct_torch.ops.score import pack_for_device, pack_host, score_tasks_torch
from haploconduct_torch.parallel import mesh

from torch_helpers import (dryrun_overlaps, dryrun_store, make_store,
                           multi_strain_reads, port_store, random_matrix,
                           random_tasks)
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def _store(units):
    store = ReadStore()
    for i, (codes, quals) in enumerate(units):
        store.add_single_codes(i, np.asarray(codes, np.int8), np.asarray(quals, np.uint8))
    store.readcount_single = len(units)
    return store


def _unit(rng, n):
    return rng.integers(0, 4, n).astype(np.int8), rng.integers(10, 40, n).astype(np.uint8)


def _inputs(store):
    """(codes, quals, lens_by_row, combined) of a store: the arguments
    score_tasks_torch hands the cache."""
    packed = port_store(store).pack()
    lens = np.concatenate([packed.lens, packed.lens]).astype(np.int64)
    return packed.codes, packed.quals, lens, pack_host(packed.codes, packed.quals)


def _reset():
    ref_dc.reset_stats()
    dc.reset_stats()


def _feed_both(sequence, ref_cache=None, cache=None):
    """Feed each (codes, quals, lens_by_row, combined) to the reference's
    cache and the twin's: after every call TRANSFER_STATS equal the
    reference's, and both matrices equal a fresh pack. Returns the twin's
    stats after each call."""
    ref_cache = ref_cache or ref_dc.CombCache()
    cache = cache or dc.CombCache()
    _reset()
    after = []
    for codes, quals, lens, combined in sequence:
        want = ref_cache.get(codes, quals, lens, combined)
        got = cache.get(codes, quals, lens, combined, device="cpu")
        assert dc.TRANSFER_STATS == ref_dc.TRANSFER_STATS
        np.testing.assert_array_equal(np.asarray(want), combined)
        assert got.dtype == torch.int16 and got.device.type == "cpu"
        assert torch.equal(got, pack_for_device(codes, quals, "cpu"))
        after.append(dict(dc.TRANSFER_STATS))
    return after


def _mixed_units(rng):
    """The reference test's second case: 12 units, then 6 forwarded, one
    stored reverse-complemented and 4 longer consensus units, then the
    first 4 of those."""
    units = [_unit(rng, 30 + i) for i in range(12)]
    nxt = [units[i] for i in range(6)]
    nxt.append((revcomp_codes(units[6][0]), units[6][1][::-1]))
    nxt += [_unit(rng, 80 + i) for i in range(4)]
    return [units, nxt, nxt[:4]]


CASES = {
    # tests/test_device_cache.py:42-87, the same stores
    "identical_second_iteration": (lambda rng: [[_unit(rng, 40) for _ in range(10)]] * 2, 0),
    "mixed_width_growth_and_flip": (_mixed_units, 1),
    "disabled": (lambda rng: [[_unit(rng, 25) for _ in range(6)]] * 2, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases_match_the_reference(case, monkeypatch):
    make, seed = CASES[case]
    if case == "disabled":
        monkeypatch.setenv("HC_DEVICE_CACHE", "0")
    stores = make(np.random.default_rng(seed))
    after = _feed_both([_inputs(_store(units)) for units in stores])
    first = after[0]
    if case == "identical_second_iteration":
        assert after[1]["reused_rows"] == 20
        assert after[1]["uploaded_bytes"] == first["full_bytes"]
    elif case == "mixed_width_growth_and_flip":
        assert after[1]["reused_rows"] >= 14
        assert after[1]["uploaded_bytes"] < after[1]["full_bytes"]
    else:
        assert after[1]["reused_rows"] == 0
        assert after[1]["uploaded_bytes"] == 2 * first["full_bytes"]


def _capture_stage_a(monkeypatch):
    """The (codes, quals, lens_by_row, combined) of every verify call of
    the port's stage a on the dry-run store (torch backend, CPU)."""
    from haploconduct_torch.assemble.stages import StageParams, run_stage

    seen = []
    orig = dc.comb_for_devices

    def record(codes, quals, lens, combined, devices):
        seen.append((codes.copy(), quals.copy(), np.array(lens), combined.copy()))
        return orig(codes, quals, lens, combined, devices)

    monkeypatch.setattr(dc, "comb_for_devices", record)
    store = dryrun_store()
    run_stage(StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                          original_readcount=len(store), backend="torch"),
              port_store(store), dryrun_overlaps(store))
    monkeypatch.setattr(dc, "comb_for_devices", orig)
    return seen


def test_stage_a_sequence_matches_the_reference(monkeypatch):
    """Every matrix a tiny stage a hands to verify, fed to both caches:
    equal stats and exact matrices at every call, some rows reused."""
    seen = _capture_stage_a(monkeypatch)
    assert len(seen) >= 4
    after = _feed_both(seen)
    assert after[-1]["reused_rows"] > 0
    assert after[-1]["uploaded_bytes"] < after[-1]["full_bytes"]


def _reference_match(old, new):
    """The reference's reuse sets (device_cache.py:83-95) from its own keys."""
    keymap = {k: r for r, k in enumerate(ref_dc._row_keys(*old))}
    reuse_old, reuse_new, changed = [], [], []
    for r, key in enumerate(ref_dc._row_keys(*new)):
        if key in keymap:
            reuse_old.append(keymap[key])
            reuse_new.append(r)
        else:
            changed.append(r)
    return reuse_old, reuse_new, changed


def _random_stores(data):
    """Three stores over a pool of units: duplicates of a unit, its reverse
    complement, the unit with its last base changed, palindromes (a unit
    equal to its own reverse complement) and fresh units of other
    lengths."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    pool = [_unit(rng, int(rng.integers(3, 40))) for _ in range(8)]
    half = _unit(rng, 5)
    pool.append((np.concatenate([half[0], revcomp_codes(half[0])]),
                 np.concatenate([half[1], half[1][::-1]])))
    stores = []
    for _ in range(3):
        units = []
        for _ in range(data.draw(st.integers(1, 14))):
            kind = data.draw(st.sampled_from(["same", "revcomp", "tail", "fresh"]))
            c, q = pool[data.draw(st.integers(0, len(pool) - 1))]
            if kind == "revcomp":
                c, q = revcomp_codes(c), q[::-1].copy()
            elif kind == "tail":
                c = c.copy()
                c[-1] = (c[-1] + 1) % 4
            elif kind == "fresh":
                c, q = _unit(rng, int(rng.integers(1, 60)))
            units.append((c, q))
        stores.append(_store(units))
    return stores


@pytest.mark.parametrize("keys", ["hashed", "prefix", "colliding", "bytes"])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_random_stores_reuse_the_reference_rows(keys, data):
    """Random stores with duplicate rows and reverse-complement twins: the
    twin reuses exactly the reference's rows: with its hashed keys; with a
    hash of a row's first 4 words, so that a unit and its changed tail
    collide; with a hash under which every row of one length collides;
    and with the reference's bytes keys (int16 codes)."""
    stores = [_inputs(s) for s in _random_stores(data)]
    if keys == "bytes":
        stores = [(c.astype(np.int16), q, lens, comb) for c, q, lens, comb in stores]
    with pytest.MonkeyPatch.context() as mp:
        if keys == "prefix":
            full = dc._row_hash
            mp.setattr(dc, "_row_hash", lambda words, lens: full(words[:, :4].copy(), lens))
        if keys == "colliding":
            mp.setattr(dc, "_row_hash", lambda words, lens: lens.astype(np.uint64))
        for old, new in zip(stores, stores[1:]):
            got = dc._Rows(*new).match(dc._Rows(*old))
            want = _reference_match(old[:3], new[:3])
            assert [list(g) for g in got] == list(want)
        _feed_both(stores)


def test_cache_on_and_off_give_the_same_contigs(monkeypatch):
    """SAVAGE a -> b -> c on the torch backend, with the cache and with
    HC_DEVICE_CACHE=0: byte-identical contigs; the cache reused rows, the
    run without it uploaded every byte."""
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    store = port_store(make_store(*multi_strain_reads()))
    contigs, stats = {}, {}
    for env in ("1", "0"):
        monkeypatch.setenv("HC_DEVICE_CACHE", env)
        dc.reset_stats()
        res = run_savage(store, SavageConfig(split_num=2, backend="torch"))
        contigs[env] = [res.contigs(s) for s in "abc"]
        stats[env] = dict(dc.TRANSFER_STATS)
    assert contigs["1"] == contigs["0"] and contigs["1"][2][1]
    assert stats["1"]["reused_rows"] > 0
    assert stats["1"]["uploaded_bytes"] < stats["1"]["full_bytes"]
    assert stats["0"]["reused_rows"] == 0
    assert stats["0"]["uploaded_bytes"] == stats["0"]["full_bytes"] > 0
    assert stats["0"]["iterations"] == stats["1"]["iterations"]


def test_two_threads_alternating_stores_get_their_own_matrices():
    """Two threads, each alternating between two stores of its own that
    share 5 of their 6 units, call comb_for_devices in lockstep: every
    matrix is the thread's exact pack, and every call after a thread's
    first reuses the 10 rows it shares with that thread's last call."""
    rng = np.random.default_rng(7)
    stores = {}
    for t in range(2):
        units = [_unit(rng, 20 + 3 * t + i) for i in range(6)]
        stores[t] = [_inputs(_store(units)),
                     _inputs(_store(units[:5] + [_unit(rng, 50 + t)]))]
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(t):
        try:
            for i in range(6):
                barrier.wait()
                codes, quals, lens, combined = stores[t][i % 2]
                got = dc.comb_for_devices(codes, quals, lens, combined, ["cpu"])[0]
                if not np.array_equal(got.numpy(), combined):
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    dc.reset_stats()
    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert dc.TRANSFER_STATS["iterations"] == 12
    assert dc.TRANSFER_STATS["reused_rows"] == 2 * 5 * 10
    assert dc.TRANSFER_STATS["changed_rows"] == 2 * (12 + 5 * 2)


def test_mesh_of_two_cpu_entries_keeps_one_matrix():
    """sharded_score_tasks over [cpu, cpu]: one cached matrix for the one
    distinct device, reused by the next call; the same sums as one call
    without the cache."""
    rng = np.random.default_rng(3)
    codes, quals, lens = random_matrix(rng, 60, 96, 20)
    row_a, row_b, pos = random_tasks(rng, np.tile(lens, 1), 400, 10)
    dc.reset_stats()
    first = mesh.sharded_score_tasks(codes, quals, lens, row_a, row_b, pos,
                                     mesh=[torch.device("cpu")] * 2)
    again = mesh.sharded_score_tasks(codes, quals, lens, row_a, row_b, pos,
                                     mesh=[torch.device("cpu")] * 2)
    assert dc.TRANSFER_STATS["iterations"] == 2
    assert dc.TRANSFER_STATS["reused_rows"] == 60
    assert dc.TRANSFER_STATS["uploaded_bytes"] == codes.shape[0] * 96 * 2
    one = score_tasks_torch(codes, quals, lens, row_a, row_b, pos, device="cpu")
    for col in ("sum_log", "counted", "mismatches", "rejected"):
        np.testing.assert_array_equal(getattr(first, col), getattr(one, col))
        np.testing.assert_array_equal(getattr(again, col), getattr(one, col))


def test_score_tasks_torch_takes_its_matrix_from_the_cache(monkeypatch):
    """A second call on the same matrix uploads nothing; its scores are the
    first call's; with HC_DEVICE_CACHE=0 it uploads everything again."""
    rng = np.random.default_rng(5)
    codes, quals, lens = random_matrix(rng, 40, 64, 16)
    tasks = random_tasks(rng, lens, 300, 8)
    dc.reset_stats()
    one = score_tasks_torch(codes, quals, lens, *tasks, device="cpu")
    two = score_tasks_torch(codes, quals, lens, *tasks, device="cpu")
    full = pack_host(codes, quals).nbytes
    assert dc.TRANSFER_STATS == {"full_bytes": 2 * full, "uploaded_bytes": full,
                                 "iterations": 2, "reused_rows": 40, "changed_rows": 40}
    monkeypatch.setenv("HC_DEVICE_CACHE", "0")
    three = score_tasks_torch(codes, quals, lens, *tasks, device="cpu")
    assert dc.TRANSFER_STATS["uploaded_bytes"] == 2 * full
    for col in ("sum_log", "counted", "mismatches", "rejected"):
        np.testing.assert_array_equal(getattr(one, col), getattr(two, col))
        np.testing.assert_array_equal(getattr(one, col), getattr(three, col))


def test_turned_off_keeps_nothing_and_restarts_cold(monkeypatch):
    rng = np.random.default_rng(9)
    args = _inputs(_store([_unit(rng, 30) for _ in range(5)]))
    cache = dc.CombCache()
    cache.get(*args, device="cpu")
    monkeypatch.setenv("HC_DEVICE_CACHE", "0")
    cache.get(*args, device="cpu")
    assert cache.comb_dev is None and cache.rows is None
    monkeypatch.delenv("HC_DEVICE_CACHE")
    dc.reset_stats()
    got = cache.get(*args, device="cpu")
    assert dc.TRANSFER_STATS["reused_rows"] == 0
    assert torch.equal(got, torch.from_numpy(args[3]))


def test_assemble_reference_numpy_is_the_reference_function():
    assert inspect.getsource(dc.assemble_reference_numpy) == \
        inspect.getsource(ref_dc.assemble_reference_numpy)


def test_assemble_reference_numpy_models_the_cache():
    """The reference's numpy model of the assembly, on the twin's reuse
    sets, rebuilds the new matrix from the old one."""
    rng = np.random.default_rng(1)
    old, new, _ = (_inputs(_store(u)) for u in _mixed_units(rng))
    reuse_old, reuse_new, changed = dc._Rows(*new).match(dc._Rows(*old))
    out = dc.assemble_reference_numpy(old[3], reuse_old, reuse_new, changed, new[3])
    np.testing.assert_array_equal(out, new[3])


def test_every_reference_module_has_a_counterpart():
    """Every module of the JAX package has a file of the same path in the
    port, but for ops/pallas_score.py, whose kernel is csrc/score_tasks.cu
    and whose host side is ops/score.py."""
    ref = {p.relative_to(REPO / "haploconduct_tpu")
           for p in (REPO / "haploconduct_tpu").rglob("*.py")}
    port = {p.relative_to(REPO / "haploconduct_torch")
            for p in (REPO / "haploconduct_torch").rglob("*.py")}
    assert ref - port == {Path("ops/pallas_score.py")}
    assert (REPO / "haploconduct_torch/csrc/score_tasks.cu").exists()
