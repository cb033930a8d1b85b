"""haploconduct_torch/parallel/mesh.py over a mesh that spans ranks, the
twin of the JAX package's global mesh (parallel/mesh.py:_make_global and
_fetch_global; tests/test_distributed.py). Each case runs two or three
gloo ranks on the CPU (HC_TORCH_DEVICE=cpu) in subprocesses with a
timeout, so a rank that waits in a collective fails the test instead of
stalling the suite. Every rank passes the same full arrays and must
return what one process's call returns, bit for bit."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from haploconduct_tpu.assemble.stages import StageParams as RefStageParams
from haploconduct_tpu.assemble.stages import run_stage as ref_run_stage
from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.io.sfo import sfo_to_overlaps
from haploconduct_tpu.ops.kmer import find_overlap_candidates
from haploconduct_tpu.parallel.mesh import make_mesh as ref_make_mesh
from haploconduct_tpu.parallel.mesh import sharded_score_tasks as ref_sharded
from haploconduct_tpu.utils.simulate import random_genome, simulate_reads
from haploconduct_torch.ops.score import score_tasks_torch
from haploconduct_torch.parallel import distributed, mesh

from test_torch_mesh import multi_segment_case
from test_torch_pipeline import STEP_KW, odd_rows_with_n, tiny_rows
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300
COLUMNS = ("sum_log", "counted", "mismatches", "rejected")

# every worker: no jax and no JAX package, the gloo group from the
# environment, and each collective of torch.distributed counted by name
PREAMBLE = textwrap.dedent("""
    import json
    import os
    import sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.modules["haploconduct_tpu"] = None
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import torch
    import torch.distributed as dist
    from chip_smoke import count_collectives
    from haploconduct_torch.ops import verify as V
    from haploconduct_torch.parallel import distributed, mesh

    assert distributed.maybe_initialize()
    rank, ranks = distributed.process_index(), distributed.process_count()
    workdir = sys.argv[1]
    collectives = count_collectives(dist)
    assert mesh.device_count() == ranks
    assert mesh.default_mesh() == [mesh.RankDevice(r, torch.device("cpu"))
                                   for r in range(ranks)]

    def save(**arrays):
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)

    def save_json(obj):
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(obj, f)
""")


def run_ranks(tmp_path, body: str, ranks: int = 2, timeout: float = RANK_TIMEOUT):
    """Run PREAMBLE + body as `ranks` gloo ranks on the CPU with tmp_path as
    their working directory, each leaving the group at its end; raises
    with every rank's error output unless all exit 0 within `timeout`
    seconds together."""
    worker = tmp_path / "worker.py"
    worker.write_text(PREAMBLE % {"repo": REPO} + textwrap.dedent(body)
                      + "distributed.shutdown()\n")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="",
                   HC_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(worker), str(tmp_path)],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            errs.append(err.decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * ranks, f"rank exit codes {codes}:\n" + "\n".join(errs)


def rank_npz(tmp_path, rank):
    with np.load(tmp_path / f"rank{rank}.npz") as f:
        return dict(f)


def rank_json(tmp_path, rank):
    return json.loads((tmp_path / f"rank{rank}.json").read_text())


def twin_store():
    """tests/test_distributed.py's SCORER_WORKER store and candidates."""
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
    return store, ov


TWIN_BODY = """
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.io.sfo import sfo_to_overlaps
    from haploconduct_torch.ops.kmer import find_overlap_candidates
    from haploconduct_torch.utils.config import Settings
    from haploconduct_torch.utils.simulate import random_genome, simulate_reads

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

    # verify_overlaps through the mesh that spans the ranks vs the oracle
    packed = store.pack()
    s_mesh = Settings(min_overlap_len=80, edge_threshold=0.97, backend="torch")
    vr_np = V.verify_overlaps(store, packed, ov, s_mesh.derive(backend="numpy"))
    before = dict(V.BACKEND_COUNTS)
    vr = V.verify_overlaps(store, packed, ov, s_mesh)
    assert V.BACKEND_COUNTS["mesh"] - before["mesh"] == vr.n_tasks > 0, V.BACKEND_COUNTS
    assert V.BACKEND_COUNTS["torch"] == before["torch"], V.BACKEND_COUNTS
    assert collectives
    for f in ("v1", "v2", "pos1", "mismatch_rate"):
        assert np.array_equal(vr.edges[f], vr_np.edges[f]), f
    assert np.array_equal(vr.nonedge_mask, vr_np.nonedge_mask)
    assert np.allclose(vr.edges["score"], vr_np.edges["score"], atol=2e-3)

    # a full stage through the mesh == the oracle's
    kw = dict(stage="a", min_overlap_len=80, edge_threshold=0.97,
              original_readcount=len(store))
    before = V.BACKEND_COUNTS["mesh"]
    res = run_stage(StageParams(backend="torch", **kw), store, ov)
    assert V.BACKEND_COUNTS["mesh"] > before, V.BACKEND_COUNTS
    res_np = run_stage(StageParams(backend="numpy", **kw), store, ov)
    recs = [res.store.seq_str(i) for i in range(len(res.store))]
    assert recs == [res_np.store.seq_str(i) for i in range(len(res_np.store))]
    save_json({"contigs": recs, "mesh_tasks": V.BACKEND_COUNTS["mesh"],
               "scored": vr.scored["score"].tolist()})
"""


@pytest.mark.parametrize("ranks", [2, 3])
def test_global_mesh_scorer_and_stage_over_ranks(ranks, tmp_path):
    """Twin of tests/test_distributed.py:test_two_process_global_mesh_scorer_and_stage
    on two (and three) gloo ranks: verify_overlaps and a full run_stage
    with the torch backend route through the mesh that spans the ranks
    (every task counted under "mesh" on each rank), decide as the f64
    oracle, and every rank's contigs and scores are equal and equal the
    JAX package's single-process oracle stage."""
    run_ranks(tmp_path, TWIN_BODY, ranks)
    store, ov = twin_store()
    ref = ref_run_stage(RefStageParams(stage="a", min_overlap_len=80,
                                       edge_threshold=0.97,
                                       original_readcount=len(store),
                                       backend="numpy"), store, ov)
    want = [ref.store.seq_str(i) for i in range(len(ref.store))]
    got = [rank_json(tmp_path, r) for r in range(ranks)]
    assert want and all(g["contigs"] == want for g in got)
    assert got[0]["mesh_tasks"] > 0
    assert all(g["mesh_tasks"] == got[0]["mesh_tasks"] for g in got)
    assert all(g["scored"] == got[0]["scored"] for g in got)


SCORER_BODY = """
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        args = [f[k] for k in ("codes", "quals", "lens", "row_a", "row_b", "pos")]
    out = {}
    for thresh in (0.0, 0.3):
        ts = mesh.sharded_score_tasks(*args, mismatch_thresh=thresh)
        for col in ("sum_log", "counted", "mismatches", "rejected"):
            out[f"{col}_{thresh}"] = getattr(ts, col)
    for i, col in enumerate(mesh.sharded_verify(None, *args, mismatch_thresh=0.3)):
        out[f"verify_{i}"] = col
    few = mesh.sharded_score_tasks(*args[:3], *(c[:2] for c in args[3:]))
    out["few_sum_log"], out["few_counted"] = few.sum_log, few.counted
    assert V.BACKEND_COUNTS["mesh"] == 0  # no verify_overlaps here
    out["gathers"] = np.array(collectives.count("all_gather"))
    save(**out)
"""


@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_score_tasks_over_ranks_is_one_call(ranks, tmp_path):
    """sharded_score_tasks and sharded_verify over the default mesh of 2
    and 3 gloo ranks (3: shards of unequal task counts) on
    tests/test_torch_mesh.py's multi-segment tasks, and 2 tasks over the
    ranks (a rank with none): every rank's four columns bit-equal to one
    score_tasks_torch call, the integer columns equal to the JAX
    package's mesh, and each call two gathers (its header, its block)."""
    args = multi_segment_case()
    np.savez(tmp_path / "inputs.npz", **dict(zip(
        ("codes", "quals", "lens", "row_a", "row_b", "pos"), args)))
    run_ranks(tmp_path, SCORER_BODY, ranks)
    for rank in range(ranks):
        got = rank_npz(tmp_path, rank)
        for thresh in (0.0, 0.3):
            one = score_tasks_torch(*args, mismatch_thresh=thresh, device="cpu")
            want = ref_sharded(*args, mismatch_thresh=thresh, mesh=ref_make_mesh(2))
            for col in COLUMNS:
                np.testing.assert_array_equal(got[f"{col}_{thresh}"], getattr(one, col))
                if col != "sum_log":
                    np.testing.assert_array_equal(got[f"{col}_{thresh}"],
                                                  getattr(want, col))
        verify = mesh.sharded_verify([torch.device("cpu")], *args, mismatch_thresh=0.3)
        for i, col in enumerate(verify):
            np.testing.assert_array_equal(got[f"verify_{i}"], col)
        codes, quals, lens, row_a, row_b, pos = args
        few = score_tasks_torch(codes, quals, lens, row_a[:2], row_b[:2], pos[:2],
                                device="cpu")
        np.testing.assert_array_equal(got["few_sum_log"], few.sum_log)
        np.testing.assert_array_equal(got["few_counted"], few.counted)
        assert int(got["gathers"]) == 2 * 4


STEP_BODY = """
    with open(os.path.join(workdir, "step_kw.json")) as f:
        kw = json.load(f)
    out = {}
    for case in ("tiny", "odd"):
        with np.load(os.path.join(workdir, f"{case}.npz")) as f:
            codes, quals, lens = f["codes"], f["quals"], f["lens"]
        before = len(collectives)
        scores, n_edges = mesh.sharded_assembly_step(None, codes, quals, lens, **kw)
        # the header's gather, the scores' and the count's sum
        assert collectives[before:] == ["all_gather", "all_gather", "all_reduce"], \\
            collectives[before:]
        out[f"{case}_scores"], out[f"{case}_edges"] = scores, np.array(n_edges)
        with mesh.rank_local():  # this rank's device alone: every row, no collective
            own = mesh.sharded_assembly_step(None, codes, quals, lens, **kw)
        assert len(collectives) == before + 3
        out[f"{case}_own_edges"] = np.array(own[1])
    save(**out)
"""


@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_assembly_step_over_ranks_is_one_device(ranks, tmp_path):
    """sharded_assembly_step over the default mesh of 2 and 3 gloo ranks on
    __graft_entry__'s tiny workload (and its odd-row cut, which pads rows):
    each rank launches the join on its own query rows, and every rank's
    slot scores are bit-equal to one device's and its count, summed over
    the ranks, equal to one device's."""
    (tmp_path / "step_kw.json").write_text(json.dumps(STEP_KW))
    cases = {"tiny": tiny_rows(), "odd": odd_rows_with_n()}
    for name, (codes, quals, lens) in cases.items():
        np.savez(tmp_path / f"{name}.npz", codes=codes, quals=quals, lens=lens)
    run_ranks(tmp_path, STEP_BODY, ranks)
    for name, (codes, quals, lens) in cases.items():
        one = mesh.sharded_assembly_step([torch.device("cpu")], codes, quals, lens,
                                         **STEP_KW)
        assert one[1] > 0
        for rank in range(ranks):
            got = rank_npz(tmp_path, rank)
            np.testing.assert_array_equal(got[f"{name}_scores"], one[0])
            assert int(got[f"{name}_edges"]) == int(got[f"{name}_own_edges"]) == one[1]


MISMATCH_BODY = """
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        args = [f[k] for k in ("codes", "quals", "lens", "row_a", "row_b", "pos")]
    cut = len(args[3]) - 1 if rank == 1 else len(args[3])  # rank 1 drops a task
    try:
        mesh.sharded_score_tasks(*args[:3], *(c[:cut] for c in args[3:]))
    except RuntimeError as exc:
        assert "same call on every rank" in str(exc), exc
        save_json({"raised": True, "collectives": collectives})
    else:
        save_json({"raised": False})
"""


def test_ranks_that_pass_different_streams_raise(tmp_path):
    """A call over the mesh that spans ranks checks first that every rank
    cut the same stream (a gather of a small header): when rank 1 passes
    one task fewer, both ranks raise, and neither waits on the other."""
    np.savez(tmp_path / "inputs.npz", **dict(zip(
        ("codes", "quals", "lens", "row_a", "row_b", "pos"), multi_segment_case())))
    run_ranks(tmp_path, MISMATCH_BODY, 2, timeout=120)
    for rank in range(2):
        assert rank_json(tmp_path, rank) == {"raised": True,
                                             "collectives": ["all_gather"]}


def test_rank_local_scope_and_mesh_entries(monkeypatch):
    """Under a process group of 3 ranks the default mesh is one RankDevice
    a rank in rank order; rank_local() nests, holds for the thread that
    enters it only, and restores the spanning mesh on exit, also after an
    exception; a mesh that names ranks in some entries only, or a rank
    outside the group, raises before any collective."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    spanning = [mesh.RankDevice(r, cpu) for r in range(3)]
    assert mesh.default_mesh() == spanning and mesh.device_count() == 3
    assert mesh.make_mesh(2, axis="data") == spanning[:2]
    seen = {}
    with mesh.rank_local():
        with mesh.rank_local():
            assert mesh.default_mesh() == [cpu]
        assert mesh.device_count() == 1
        other = threading.Thread(target=lambda: seen.update(mesh=mesh.default_mesh()))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    assert seen["mesh"] == spanning
    with pytest.raises(KeyError):
        with mesh.rank_local():
            raise KeyError("inside")
    assert mesh.default_mesh() == spanning
    args = multi_segment_case()
    with pytest.raises(ValueError, match="every entry or in none"):
        mesh.sharded_score_tasks(*args, mesh=[spanning[0], cpu])
    with pytest.raises(ValueError, match="outside"):
        mesh.sharded_score_tasks(*args, mesh=[mesh.RankDevice(3, cpu)])
    with pytest.raises(ValueError, match="every entry or in none"):
        mesh.sharded_assembly_step([cpu, spanning[1]], *tiny_rows(), **STEP_KW)
