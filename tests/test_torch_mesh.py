"""haploconduct_torch/parallel/mesh.py against the JAX package's mesh
(tests/test_mesh.py, on the root conftest's 8 virtual CPU devices). The
port shards over `mesh=[cpu] * k`, k = 2 and 3 so that shards are
uneven; each CPU shard runs the kernel's plain version. A task is scored
whole by one shard, so the sharded sums are bit-equal to one
score_tasks_torch call."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from haploconduct_tpu.assemble.stages import StageParams as RefStageParams
from haploconduct_tpu.assemble.stages import run_stage as ref_run_stage
from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.sfo import sfo_to_overlaps
from haploconduct_tpu.ops.kmer import find_overlap_candidates
from haploconduct_tpu.ops.score import score_tasks_numpy
from haploconduct_tpu.ops.verify import verify_overlaps as ref_verify
from haploconduct_tpu.parallel.mesh import make_mesh
from haploconduct_tpu.parallel.mesh import sharded_score_tasks as ref_sharded
from haploconduct_tpu.utils.config import Settings
from haploconduct_tpu.utils.simulate import (mutate_sequence, random_genome,
                                              simulate_reads)
from haploconduct_torch.assemble.stages import StageParams, run_stage
from haploconduct_torch.ops.score import score_tasks_torch
from haploconduct_torch.ops.verify import BACKEND_COUNTS
from haploconduct_torch.ops.verify import verify_overlaps as port_verify
from haploconduct_torch.parallel import devices, distributed, mesh
from haploconduct_torch.parallel.mesh import sharded_score_tasks
from haploconduct_torch.utils.config import Settings as PortSettings

from test_score import build_random_store, random_overlaps
from torch_helpers import port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [2, 3]
INTS = ("counted", "mismatches", "rejected")


def cpus(k):
    return [torch.device("cpu")] * k


def _assert_sharded(codes, quals, lens, row_a, row_b, pos, k, thresh, mesh_ref):
    args = (codes, quals, lens, row_a, row_b, pos)
    lanes = np.minimum(lens[row_a] - pos, lens[row_b])
    bounds = mesh.shard_bounds(np.where(pos >= lens[row_a], 0, lanes), k)
    assert np.all(np.diff(bounds) > 0)  # k non-empty shards
    got = sharded_score_tasks(*args, mismatch_thresh=thresh, mesh=cpus(k))
    oracle = score_tasks_numpy(*args, mismatch_thresh=thresh)
    for name in INTS:
        np.testing.assert_array_equal(getattr(got, name), getattr(oracle, name))
        np.testing.assert_array_equal(getattr(got, name), getattr(mesh_ref, name))
    np.testing.assert_allclose(got.sum_log, oracle.sum_log, rtol=1e-4, atol=1e-3)
    one = score_tasks_torch(*args, mismatch_thresh=thresh, device="cpu")
    for name in one._fields:  # bit-equal: the same plain sums per task
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name))


def multi_segment_case():
    """tests/test_mesh.py:20's inputs: tasks of several 512-lane segments."""
    rng = np.random.default_rng(7)
    R, W = 96, 1400
    codes = np.full((R, W), 5, np.int8)
    quals = np.zeros((R, W), np.uint8)
    lens = rng.integers(200, W + 1, R).astype(np.int64)
    for i in range(R):
        codes[i, :lens[i]] = rng.integers(0, 4, lens[i])
        quals[i, :lens[i]] = rng.integers(2, 41, lens[i])
    B = 512
    row_a = rng.integers(0, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = np.array([rng.integers(0, max(1, lens[a] - 50)) for a in row_a], np.int64)
    return codes, quals, lens, row_a, row_b, pos


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_sharded_score_tasks_matches_oracle_exactly(k, thresh):
    """Mirror of tests/test_mesh.py:test_sharded_score_tasks_matches_oracle_exactly."""
    args = multi_segment_case()
    mesh_ref = ref_sharded(*args, mismatch_thresh=thresh)
    _assert_sharded(*args, k, thresh, mesh_ref)


@pytest.mark.parametrize("k", SHARDS)
def test_sharded_score_tasks_beyond_row_cap(k):
    """Mirror of tests/test_mesh.py:test_sharded_score_tasks_beyond_row_cap:
    R = 2^16 + 512 rows, tasks on rows above 2^16."""
    rng = np.random.default_rng(17)
    R, W = (1 << 16) + 512, 64
    codes = rng.integers(0, 4, (R, W)).astype(np.int8)
    quals = rng.integers(2, 41, (R, W)).astype(np.uint8)
    lens = rng.integers(40, W + 1, R).astype(np.int64)
    B = 4096
    row_a = rng.integers(R - 4096, R, B).astype(np.int64)
    row_b = rng.integers(0, R, B).astype(np.int64)
    pos = rng.integers(0, 30, B).astype(np.int64)
    args = (codes, quals, lens, row_a, row_b, pos)
    mesh_ref = ref_sharded(*args, mesh=make_mesh(2))
    _assert_sharded(*args, k, 0.0, mesh_ref)


def test_sharded_score_tasks_edges():
    """No tasks; fewer tasks than devices (empty shards are skipped); the
    checks of score_tasks_torch; no device."""
    args = multi_segment_case()
    codes, quals, lens, row_a, row_b, pos = args
    empty = sharded_score_tasks(codes, quals, lens, row_a[:0], row_b[:0], pos[:0],
                                mesh=cpus(2))
    assert all(len(c) == 0 for c in empty)
    got = sharded_score_tasks(codes, quals, lens, row_a[:2], row_b[:2], pos[:2],
                              mesh=cpus(5))
    want = score_tasks_numpy(codes, quals, lens, row_a[:2], row_b[:2], pos[:2])
    np.testing.assert_array_equal(got.counted, want.counted)
    with pytest.raises(ValueError, match="row ids"):
        sharded_score_tasks(codes, quals, lens, row_a + len(lens), row_b, pos,
                            mesh=cpus(2))
    with pytest.raises(ValueError, match="positions"):
        sharded_score_tasks(codes, quals, lens, row_a, row_b, pos - 10**6,
                            mesh=cpus(2))
    with pytest.raises(ValueError, match="device"):
        sharded_score_tasks(*args, mesh=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sharded_score_tasks(*args, mesh=["cpu", "cuda"])


def test_shard_bounds_balance_lanes():
    lanes = np.array([10, 0, 10, 10, 30, 0, 20, 20])  # 100 lanes
    np.testing.assert_array_equal(mesh.shard_bounds(lanes, 1), [0, 8])
    np.testing.assert_array_equal(mesh.shard_bounds(lanes, 2), [0, 5, 8])
    np.testing.assert_array_equal(mesh.shard_bounds(lanes, 4), [0, 4, 5, 7, 8])
    np.testing.assert_array_equal(mesh.shard_bounds(np.zeros(3, int), 2), [0, 1, 3])
    np.testing.assert_array_equal(mesh.shard_bounds(np.array([7]), 3), [0, 0, 1, 1])


def test_default_devices_rank_own_card_under_process_group(monkeypatch):
    """The CPU only when asked (HC_TORCH_DEVICE=cpu), card or not; without
    a card and unasked, an error that names how to ask. One process: every
    visible card. A process group of more than one rank: default_devices()
    is the rank's own card only; the mesh spans the ranks, one entry a
    rank in rank order, and inside rank_local() (where ranks verify
    different streams) it is the rank's own card again."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert devices.default_devices() == [torch.device("cpu")]
    monkeypatch.delenv("HC_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="HC_TORCH_DEVICE=cpu"):
        devices.default_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert devices.default_devices() == [torch.device("cuda", i) for i in range(4)]
    assert mesh.default_mesh() == devices.default_devices()
    assert devices.default_device() == torch.device("cuda", 0)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert devices.default_devices() == [torch.device("cuda", 2)]
    assert mesh.make_mesh() == mesh.default_mesh() == [
        mesh.RankDevice(0, torch.device("cuda")), mesh.RankDevice(1, torch.device("cuda", 2))]
    assert mesh.device_count() == 2
    with mesh.rank_local():
        assert mesh.make_mesh() == [torch.device("cuda", 2)]
        assert mesh.device_count() == 1
    monkeypatch.setenv("HC_TORCH_DEVICE", "cpu")
    assert devices.default_devices() == [torch.device("cpu")]
    monkeypatch.setenv("HC_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="HC_TORCH_DEVICE"):
        devices.default_devices()


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("thresholds", [(0.5, 0.2), (0.05, 0.04)])
def test_verify_overlaps_routes_through_mesh(k, thresholds, monkeypatch):
    """Mirror of tests/test_mesh.py:test_verify_overlaps_routes_through_mesh:
    the torch backend goes through the mesh when default_mesh() names
    more than one device, and decides as the JAX package's mesh route.
    The mirror's thresholds (0.5, 0.2) accept no edge on these random
    reads; (0.05, 0.04) accept some and sit among the scores."""
    rng = np.random.default_rng(8)
    store, _ = build_random_store(rng, n_single=10, n_paired=6)
    packed = store.pack()
    ov = random_overlaps(rng, store, 120)
    kw = dict(edge_threshold=thresholds[0], ov_threshold=thresholds[1])
    want = ref_verify(store, packed, ov, Settings(backend="jax", exact=True, **kw))
    monkeypatch.setattr(mesh, "default_mesh", lambda: cpus(k))
    before = dict(BACKEND_COUNTS)
    pstore = port_store(store)
    got = port_verify(pstore, pstore.pack(), ov,
                      PortSettings(backend="torch", exact=True, **kw))
    assert BACKEND_COUNTS["mesh"] - before["mesh"] == got.n_tasks > 0
    assert BACKEND_COUNTS["torch"] == before["torch"]
    np.testing.assert_array_equal(got.nonedge_mask, want.nonedge_mask)
    np.testing.assert_array_equal(got.scored["mismatch_rate"],
                                  want.scored["mismatch_rate"])
    assert want.nonedge_mask.any() and got.edges.dtype == want.edges.dtype
    assert len(got.edges) == len(want.edges)
    if thresholds[0] < 0.5:
        assert len(want.edges) > 0
    for f in got.edges.dtype.names:
        if f != "score":
            np.testing.assert_array_equal(got.edges[f], want.edges[f])
            np.testing.assert_array_equal(got.scored[f], want.scored[f])
    # the two packages add f32 lanes in different orders: scores agree to
    # the suite's f32 tolerance, and every decision exactly
    np.testing.assert_allclose(got.scored["score"], want.scored["score"], atol=2e-4)


@pytest.fixture(scope="module")
def stage_case():
    """tests/test_mesh.py:96's store and candidates, and the JAX package's
    stage a through its 8-device mesh."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 3000)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.01)]
    seqs, quals = simulate_reads(haps, coverage=25, read_len=150, rng=rng,
                                 error_rate=0.003)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    ov = sfo_to_overlaps(find_overlap_candidates(sseqs, min_overlap_len=90, k=20,
                                                 error_rate=0.01), len(store), 0)
    kw = dict(stage="a", min_overlap_len=90, edge_threshold=0.97,
              original_readcount=len(store))
    ref = ref_run_stage(RefStageParams(backend="jax", **kw), store, ov)
    return store, ov, kw, [ref.store.seq_str(i) for i in range(len(ref.store))]


@pytest.mark.parametrize("k", SHARDS)
def test_full_stage_mesh_byte_identical(k, stage_case, monkeypatch):
    """Mirror of tests/test_mesh.py:test_full_stage_mesh_vs_oracle_byte_identical:
    run_stage through the port's mesh route gives the JAX package's mesh
    stage, contig for contig, byte for byte."""
    store, ov, kw, want = stage_case
    monkeypatch.setattr(mesh, "default_mesh", lambda: cpus(k))
    before = BACKEND_COUNTS["mesh"]
    res = run_stage(StageParams(backend="torch", **kw), port_store(store), ov)
    assert BACKEND_COUNTS["mesh"] > before
    got = [res.store.seq_str(i) for i in range(len(res.store))]
    assert got == want and want


GLOO_WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    import torch.distributed as dist
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.io.sfo import sfo_to_overlaps
    from haploconduct_torch.ops import verify as V
    from haploconduct_torch.ops.kmer import find_overlap_candidates
    from haploconduct_torch.parallel import distributed, mesh
    from haploconduct_torch.utils.config import Settings
    from haploconduct_torch.utils.simulate import random_genome, simulate_reads

    assert distributed.maybe_initialize() and distributed.process_count() == 2
    rank = distributed.process_index()
    assert mesh.default_mesh() == [mesh.RankDevice(r, torch.device("cpu"))
                                   for r in range(2)]
    collectives = []
    for name in ("all_gather_object", "all_gather", "all_reduce", "broadcast",
                 "broadcast_object_list", "barrier", "gather", "scatter",
                 "reduce", "all_to_all", "send", "recv"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **k):
            collectives.append(_name)
            return _fn(*a, **k)
        setattr(dist, name, counted)

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 2500)
    seqs, quals = simulate_reads([genome], coverage=25, read_len=150,
                                 rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    ov = sfo_to_overlaps(find_overlap_candidates(sseqs, min_overlap_len=80, k=20,
                                                 error_rate=0.01), len(store), 0)

    # verify: the torch backend against the f64 oracle
    packed = store.pack()
    s_torch = Settings(min_overlap_len=80, edge_threshold=0.97, backend="torch")
    vr_np = V.verify_overlaps(store, packed, ov, s_torch.derive(backend="numpy"))
    kw = dict(stage="a", min_overlap_len=80, edge_threshold=0.97,
              original_readcount=len(store))
    with mesh.rank_local():  # each rank on its own device, no collective
        assert mesh.default_mesh() == [torch.device("cpu")]
        if rank == 1:  # calls the other rank does not make
            V.verify_overlaps(store, packed, ov[: len(ov) // 3], s_torch)
        before = V.BACKEND_COUNTS["torch"]
        vr_own = V.verify_overlaps(store, packed, ov, s_torch)
        assert V.BACKEND_COUNTS["torch"] - before == vr_own.n_tasks > 0, V.BACKEND_COUNTS
        res_own = run_stage(StageParams(backend="torch", **kw), store, ov)
    assert V.BACKEND_COUNTS["mesh"] == 0, V.BACKEND_COUNTS
    assert collectives == [], collectives
    # the same calls on both ranks: through the mesh that spans them
    before = dict(V.BACKEND_COUNTS)
    vr = V.verify_overlaps(store, packed, ov, s_torch)
    assert V.BACKEND_COUNTS["mesh"] - before["mesh"] == vr.n_tasks, V.BACKEND_COUNTS
    assert V.BACKEND_COUNTS["torch"] == before["torch"] and collectives
    for got in (vr, vr_own):
        for f in ("v1", "v2", "pos1", "mismatch_rate"):
            assert np.array_equal(got.edges[f], vr_np.edges[f]), f
        assert np.array_equal(got.nonedge_mask, vr_np.nonedge_mask)
        assert np.allclose(got.edges["score"], vr_np.edges["score"], atol=2e-3)
    assert np.array_equal(vr.scored, vr_own.scored)

    # a whole stage: torch == oracle, through the mesh and on one device
    before = V.BACKEND_COUNTS["mesh"]
    res = run_stage(StageParams(backend="torch", **kw), store, ov)
    assert V.BACKEND_COUNTS["mesh"] > before, V.BACKEND_COUNTS
    res_np = run_stage(StageParams(backend="numpy", **kw), store, ov)
    recs = [res.store.seq_str(i) for i in range(len(res.store))]
    assert recs == [res_np.store.seq_str(i) for i in range(len(res_np.store))]
    assert recs == [res_own.store.seq_str(i) for i in range(len(res_own.store))]
    assert recs
    with open(sys.argv[1], "w") as f:
        f.write("\\n".join(recs))
    dist.destroy_process_group()
""")


def test_two_process_gloo_scorer_and_stage(tmp_path):
    """Mirror of tests/test_distributed.py:test_two_process_global_mesh_scorer_and_stage
    on two gloo ranks: both run verify_overlaps and run_stage with the torch
    backend on the same store, first inside mesh.rank_local(), each on its
    own device with no collective (rank 1 makes extra verify calls, which
    the mesh that spans the ranks would wait on), then outside it, through
    that mesh (every task counted under "mesh"). Both agree with the f64
    oracle, with each other and with the JAX package's oracle stage."""
    worker = tmp_path / "worker.py"
    worker.write_text(GLOO_WORKER % {"repo": REPO})
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    outs = [tmp_path / f"contigs{r}.txt" for r in range(2)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   CUDA_VISIBLE_DEVICES="", HC_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(worker), str(outs[rank])],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        finally:
            p.kill()
        errs.append(err.decode()[-2000:])
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 2500)
    seqs, quals = simulate_reads([genome], coverage=25, read_len=150,
                                 rng=rng, error_rate=0.002)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    sseqs = [store.unit_codes(u) for u in range(store.n_units)]
    ov = sfo_to_overlaps(find_overlap_candidates(sseqs, min_overlap_len=80, k=20,
                                                 error_rate=0.01), len(store), 0)
    ref = ref_run_stage(RefStageParams(stage="a", min_overlap_len=80,
                                       edge_threshold=0.97,
                                       original_readcount=len(store),
                                       backend="numpy"), store, ov)
    want = "\n".join(ref.store.seq_str(i) for i in range(len(ref.store)))
    assert want and outs[0].read_text() == want
    assert outs[1].read_text() == want
