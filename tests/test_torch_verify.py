"""haploconduct_torch/ops/verify.py and ops/autoback.py against the JAX
package's verify_overlaps. The twin's torch backend runs the kernel's plain
version here; its edge decisions must be those of the f64 oracle after the
recheck machinery, exactly as the reference's device paths are held."""

import numpy as np
import pytest
import torch

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.overlaps import make_overlaps
from haploconduct_tpu.ops.score import RECHECK_MARGIN, score_tasks_jax, score_tasks_numpy
from haploconduct_tpu.ops.verify import combine_scores, plan_tasks
from haploconduct_tpu.ops.verify import verify_overlaps as ref_verify
from haploconduct_tpu.utils.config import Settings
from haploconduct_torch.ops import autoback
from haploconduct_torch.ops.verify import BACKEND_COUNTS, RECHECK_STATS
from haploconduct_torch.ops.verify import verify_overlaps as port_verify
from haploconduct_torch.utils.config import Settings as PortSettings

from test_score import build_random_store, random_overlaps
from torch_helpers import port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


def verify_overlaps(store, packed, ov, s):
    """The port's verify_overlaps on its own objects, built from the same
    reads and settings as the reference's `store` and `s` (the packed
    matrices are the port's pack of the same reads)."""
    pstore = port_store(store)
    return port_verify(pstore, pstore.pack(), ov, PortSettings(**vars(s)))


def _assert_same_decisions(r_ref, r_got):
    assert len(r_ref.edges) == len(r_got.edges)
    np.testing.assert_array_equal(r_ref.nonedge_mask, r_got.nonedge_mask)
    np.testing.assert_array_equal(r_ref.edges["v1"], r_got.edges["v1"])
    np.testing.assert_array_equal(r_ref.edges["v2"], r_got.edges["v2"])


@pytest.mark.parametrize("backend", ["torch", "native", "numpy"])
def test_verify_backends_agree(backend):
    """Mirror of tests/test_score.py:test_verify_backends_agree."""
    rng = np.random.default_rng(4)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    kw = dict(edge_threshold=0.5, ov_threshold=0.2)
    r64 = ref_verify(store, packed, ov, Settings(backend="numpy", **kw))
    before = dict(BACKEND_COUNTS)
    got = verify_overlaps(store, packed, ov, Settings(backend=backend, exact=True, **kw))
    _assert_same_decisions(r64, got)
    assert got.n_tasks == r64.n_tasks
    scored = BACKEND_COUNTS[backend] - before[backend]
    if backend == "native" and scored == 0:  # extension unavailable
        assert BACKEND_COUNTS["numpy"] - before["numpy"] == got.n_tasks
    else:
        assert scored == got.n_tasks
    np.testing.assert_allclose(got.scored["score"], r64.scored["score"], atol=2e-4)


def test_torch_verify_scores_match_xla_path():
    """Per-task torch scores inside verify agree with the reference's XLA
    scorer (called directly: under the 8 virtual CPU devices the
    reference's backend="jax" would take the mesh path instead)."""
    rng = np.random.default_rng(8)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    plan, meta = plan_tasks(store, packed, ov)
    lens = np.concatenate([packed.lens, packed.lens])
    args = (packed.codes, packed.quals, lens, plan.row_first, plan.row_second, plan.pos)
    tsj = score_tasks_jax(*args)
    got = verify_overlaps(store, packed, ov,
                          Settings(edge_threshold=0.5, ov_threshold=0.2,
                                   backend="torch", exact=False))
    s = Settings(edge_threshold=0.5, ov_threshold=0.2, backend="numpy")
    want = combine_scores(ov, plan, meta,
                          tsj._replace(score=np.minimum(tsj.score, 1.0)), s)
    np.testing.assert_allclose(got.scored["score"], want["score"], atol=2e-4)


def test_mismatch_rate_exact_on_torch_path():
    """Mirror of tests/test_score.py:test_mismatch_rate_exact_on_device_path."""
    rng = np.random.default_rng(11)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 150)
    kw = dict(edge_threshold=0.5, ov_threshold=0.2)
    r64 = ref_verify(store, packed, ov, Settings(backend="numpy", **kw))
    rt = verify_overlaps(store, packed, ov, Settings(backend="torch", exact=True, **kw))
    np.testing.assert_array_equal(r64.scored["mismatch_rate"], rt.scored["mismatch_rate"])


def test_combined_pe_score_recheck_near_threshold():
    """Mirror of tests/test_score.py:test_combined_pe_score_recheck_near_threshold
    on the torch backend: a combined paired score sitting on ov_threshold
    is rechecked in f64 and decided exactly as the oracle decides it."""
    L, pos, ovlen = 60, 20, 40
    base = ("ACGTTGCAACGGATCCTAGGATCCGGTTAACCGGATATCG" * 2)[:L]
    y1 = base[pos:] + base[:pos]
    y2_mis = list(base[pos:] + base[:pos])
    y2_mis[5] = "A" if y2_mis[5] != "A" else "C"
    y2 = "".join(y2_mis)
    q = "I" * L
    store = ReadStore()
    store.add_paired(0, base, q, base, q)
    store.add_paired(1, y1, q, y2, q)
    packed = store.pack()
    ov = make_overlaps(
        id1=np.array([0]), id2=np.array([1]),
        pos1=np.array([pos]), pos2=np.array([pos]),
        len1=np.array([ovlen]), len2=np.array([ovlen]),
        perc1=np.array([100 * ovlen // L]), perc2=np.array([100 * ovlen // L]),
    )
    ov["type1"] = b"p"
    ov["type2"] = b"p"
    ov["ord"] = b"1"

    plan, _ = plan_tasks(store, packed, ov)
    lens = np.concatenate([packed.lens, packed.lens])
    ts = score_tasks_numpy(packed.codes, packed.quals, lens,
                           plan.row_first, plan.row_second, plan.pos)
    s1, s2 = ts.score[plan.t1_of[0]], ts.score[plan.t2_of[0]]
    combined = 0.5 * (s1 + s2)
    assert abs(s1 - combined) > 2 * RECHECK_MARGIN
    assert abs(s2 - combined) > 2 * RECHECK_MARGIN

    for delta in (0.0, 1e-9, -1e-9, 5e-7, -5e-7):
        kw = dict(edge_threshold=0.5, ov_threshold=float(combined + delta))
        r64 = ref_verify(store, packed, ov, Settings(backend="numpy", **kw))
        rt = verify_overlaps(store, packed, ov, Settings(backend="torch", exact=True, **kw))
        assert RECHECK_STATS["overlaps"] >= 1
        np.testing.assert_array_equal(r64.nonedge_mask, rt.nonedge_mask)
        np.testing.assert_array_equal(r64.scored["score"], rt.scored["score"])


def test_unattainable_threshold_skips_recheck():
    """Mirror of tests/test_score.py:test_unattainable_threshold_skips_recheck."""
    rng = np.random.default_rng(11)
    store, _ = build_random_store(rng, n_single=14, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 200)
    s64 = Settings(edge_threshold=1.0, ov_threshold=0.0, merge_contigs=0.02,
                   backend="numpy")
    r64 = ref_verify(store, packed, ov, s64)
    before = BACKEND_COUNTS["recheck"]
    rt = verify_overlaps(store, packed, ov, s64.derive(backend="torch"))
    assert RECHECK_STATS["tasks"] == 0 and RECHECK_STATS["overlaps"] == 0
    assert BACKEND_COUNTS["recheck"] == before
    _assert_same_decisions(r64, rt)


def test_auto_backend_resolution(monkeypatch):
    """auto is the kernel on the card; without a card it raises, and the
    host engines run only when named (HC_BACKEND or the backend itself)."""
    monkeypatch.delenv("HC_BACKEND", raising=False)
    if torch.cuda.is_available():
        assert autoback.resolve_backend() == "torch"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            autoback.resolve_backend()
    for env in autoback.BACKENDS:
        monkeypatch.setenv("HC_BACKEND", env)
        assert autoback.resolve_backend() == env
    monkeypatch.setenv("HC_BACKEND", "jax")  # not a backend of the port
    if torch.cuda.is_available():
        assert autoback.resolve_backend() == "torch"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            autoback.resolve_backend()


def test_auto_backend_verify_and_unknown_backend(monkeypatch):
    rng = np.random.default_rng(9)
    store, _ = build_random_store(rng, n_single=8, n_paired=4)
    packed = store.pack()
    ov = random_overlaps(rng, store, 60)
    monkeypatch.setenv("HC_BACKEND", "torch")
    before = BACKEND_COUNTS["torch"]
    res = verify_overlaps(store, packed, ov, Settings(backend="auto"))
    assert BACKEND_COUNTS["torch"] - before == res.n_tasks
    with pytest.raises(ValueError):
        verify_overlaps(store, packed, ov, Settings(backend="jax"))


def test_recheck_count_is_exact_when_two_threads_verify_at_once(monkeypatch):
    """Two verify calls on region threads, both inside their f64 recheck at
    the same moment (a barrier in the oracle's first call on each thread),
    add to BACKEND_COUNTS["recheck"] exactly what the two calls add one
    after the other."""
    import threading

    from haploconduct_torch.ops import verify as V

    calls = []
    for seed in (4, 6):
        rng = np.random.default_rng(seed)
        store, _ = build_random_store(rng, n_single=10, n_paired=6)
        ov = random_overlaps(rng, store, 150)
        pstore = port_store(store)
        packed = pstore.pack()
        ts = score_tasks_numpy(*_task_args(store, store.pack(), ov))
        on = np.sort(ts.score[(ts.score > 0.05) & (ts.score < 0.95)])
        # thresholds on scores the tasks give, so some tasks sit on them
        s = PortSettings(backend="torch", exact=True,
                         edge_threshold=float(on[len(on) // 2]),
                         ov_threshold=float(on[len(on) // 4 + seed]))
        calls.append((pstore, packed, ov, s))

    before = BACKEND_COUNTS["recheck"]
    alone = []
    for pstore, packed, ov, s in calls:
        port_verify(pstore, packed, ov, s)
        alone.append(RECHECK_STATS["tasks"])
    sequential = BACKEND_COUNTS["recheck"] - before
    assert sequential == sum(alone) and min(alone) > 0 and alone[0] != alone[1]

    barrier = threading.Barrier(2, timeout=60)
    local = threading.local()
    oracle = V.score_tasks_numpy

    def meeting_oracle(*args, **kw):
        if not getattr(local, "met", False):
            local.met = True
            barrier.wait()
        return oracle(*args, **kw)

    monkeypatch.setattr(V, "score_tasks_numpy", meeting_oracle)
    errors = []

    def run(call):
        try:
            port_verify(*call)
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    before = BACKEND_COUNTS["recheck"]
    threads = [threading.Thread(target=run, args=(c,)) for c in calls]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert BACKEND_COUNTS["recheck"] - before == sequential
    assert RECHECK_STATS["tasks"] in alone


def _task_args(store, packed, ov):
    plan, _ = plan_tasks(store, packed, ov)
    lens = np.concatenate([packed.lens, packed.lens])
    return packed.codes, packed.quals, lens, plan.row_first, plan.row_second, plan.pos
