"""haploconduct_torch/parallel/mesh.py's last device paths against the JAX
package's (on the root conftest's virtual CPU mesh), and where the torch
backend runs.

- `sharded_assembly_step`, the fused k-mer join + verification (the
  join_verify kernel's plain version here): the zero pattern of the slot
  scores (decided by exact integers) equal to the reference's, scores
  within atol 1e-5 (both sum log p in f32, in other orders), the slot
  count equal except for slots within 1e-5 of the threshold.
- `sharded_verify`: integer columns and the mismatch rate equal, score
  within atol 1e-5 (the reference sums a task's W lanes in one f32 sum,
  the port f32 sums of at most 512 lanes added in f64).
- Any sharding gives one device's results bit for bit.
- Without a card, every entry point of the torch backend raises unless
  HC_TORCH_DEVICE=cpu asks for the CPU, and then runs the plain versions.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_workload
from haploconduct_tpu.ops.kmer import _kmer_hashes
from haploconduct_tpu.parallel.mesh import make_mesh as ref_make_mesh
from haploconduct_tpu.parallel.mesh import sharded_assembly_step as ref_step
from haploconduct_tpu.parallel.mesh import sharded_verify as ref_verify
from haploconduct_torch.cli import main
from haploconduct_torch.ops import abundance, kernels, kmer_device
from haploconduct_torch.ops.join_verify import (join_verify, join_verify_plain,
                                                kmer_queries)
from haploconduct_torch.ops.kmer_device import kmer_hashes, kmer_table
from haploconduct_torch.ops.score import pack_for_device, score_tasks_torch
from haploconduct_torch.ops.verify import verify_overlaps
from haploconduct_torch.parallel import mesh
from haploconduct_torch.utils.config import Settings
from haploconduct_torch.workflows.polyte import single_end_candidates

from test_torch_mesh import multi_segment_case
from torch_helpers import dryrun_overlaps, dryrun_store, far_threshold, port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

STEP_KW = dict(k=13, expand=8, edge_threshold=0.9, min_overlap_len=24)


def cpus(k):
    return [torch.device("cpu")] * k


def tiny_rows():
    """__graft_entry__._tiny_workload's packed matrix (64 reads of 96 bp,
    width 128, forward and reverse-complement rows) with one length per
    row."""
    packed = _tiny_workload()[0]
    return packed.codes, packed.quals, np.concatenate([packed.lens, packed.lens])


def odd_rows_with_n():
    """The tiny matrix cut to an odd row count (so two devices pad a row),
    with N bases in some rows."""
    codes, quals, lens = tiny_rows()
    codes, quals, lens = codes[:125].copy(), quals[:125].copy(), lens[:125].copy()
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 125, 40)
    cols = (rng.random(40) * lens[rows]).astype(np.int64)
    codes[rows, cols] = 4
    return codes, quals, lens


def assert_step_matches(got, want, threshold):
    (gs, gn), (ws, wn) = got, want
    assert gs.shape == ws.shape and gs.dtype == ws.dtype == np.float32
    np.testing.assert_array_equal(gs == 0, ws == 0)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    near = int(np.sum(np.abs(ws - threshold) < 1e-5))
    assert abs(gn - wn) <= near


@pytest.mark.parametrize("case", [tiny_rows, odd_rows_with_n])
def test_sharded_assembly_step_matches_jax(case):
    codes, quals, lens = case()
    want = ref_step(ref_make_mesh(2), codes, quals, lens.astype(np.int32), **STEP_KW)
    got = mesh.sharded_assembly_step(cpus(2), codes, quals, lens, **STEP_KW)
    assert_step_matches(got, want, STEP_KW["edge_threshold"])
    assert want[1] > 0 and np.any(want[0] == 0)


@pytest.mark.parametrize("case", [tiny_rows, odd_rows_with_n])
def test_sharded_assembly_step_any_sharding_is_one_device(case):
    codes, quals, lens = case()
    one = mesh.sharded_assembly_step(cpus(1), codes, quals, lens, **STEP_KW)
    for k in (2, 3):
        got = mesh.sharded_assembly_step(cpus(k), codes, quals, lens, **STEP_KW)
        np.testing.assert_array_equal(got[0], one[0])
        assert got[1] == one[1]


def test_kmer_table_is_the_references_host_table():
    """The table of forward k-mers built with torch (ops/kmer_device.py)
    is the one the reference builds on the host with ops/kmer.py:
    _kmer_hashes and a stable argsort: N and pad windows alike invalid."""
    codes, _, _ = odd_rows_with_n()
    k = 13
    nk = codes.shape[1] - k + 1
    h = np.concatenate([_kmer_hashes(row, k)[:nk] for row in codes])
    h32 = np.where(h >= 0, h, np.int64(2**31 - 1)).astype(np.int32)
    order = np.argsort(h32, kind="stable")
    tkey, t_rid, t_pos = kmer_table(kmer_hashes(torch.from_numpy(codes), k).reshape(-1), nk)
    np.testing.assert_array_equal(tkey.numpy(), h32[order])
    np.testing.assert_array_equal(t_rid.numpy(), order // nk)
    np.testing.assert_array_equal(t_pos.numpy(), order % nk)


def test_join_verify_dispatch_and_inputs():
    """A CPU tensor takes the plain version and counts no launch; the
    kernel's wrapper refuses a CPU tensor; bad inputs are refused."""
    codes, quals, lens = tiny_rows()
    comb = pack_for_device(codes, quals, "cpu")
    lens32 = torch.from_numpy(lens.astype(np.int32))
    nk = codes.shape[1] - 12
    tkey, t_rid, t_pos = kmer_table(kmer_hashes(comb[:, :128] & 7, 13).reshape(-1), nk)
    left, count = kmer_queries(comb, 128, 13, tkey, 10, 20)
    args = (comb, lens32, t_rid, t_pos, left, count, 10, nk, 8, 24, 0.9)
    before = kernels.join_verify_cuda.launches
    got = join_verify(*args)
    assert kernels.join_verify_cuda.launches == before
    for a, b in zip(got, join_verify_plain(*args)):
        assert torch.equal(a, b)
    assert got[0].shape == (10 * nk * 8,) and int(got[1]) > 0
    with pytest.raises(ValueError):
        kernels.join_verify_cuda(*args)
    for bad in (dict(k=16), dict(expand=0)):
        with pytest.raises(ValueError):
            mesh.sharded_assembly_step(cpus(1), codes, quals, lens, **dict(STEP_KW, **bad))
    with pytest.raises(ValueError, match="one length"):
        mesh.sharded_assembly_step(cpus(1), codes, quals, lens[:64], **STEP_KW)


@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_sharded_verify_matches_jax(thresh):
    """tests/test_mesh.py:24-34's W = 1400 stream (tasks of several
    512-lane segments), on two devices of each package."""
    args = multi_segment_case()
    want = ref_verify(ref_make_mesh(2), *args, mismatch_thresh=thresh)
    got = mesh.sharded_verify(cpus(2), *args, mismatch_thresh=thresh)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    # random reads: every task scores at threshold 0, and 0.3 rejects each
    assert np.all(got[0] > 0) if thresh == 0 else np.all(got[0] == 0)


def test_sharded_verify_any_sharding_is_one_device():
    args = multi_segment_case()
    th = far_threshold()
    one = mesh.sharded_verify(cpus(1), *args, mismatch_thresh=th, min_read_len=300)
    got = mesh.sharded_verify(cpus(3), *args, mismatch_thresh=th, min_read_len=300)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o)


def test_make_mesh():
    assert mesh.make_mesh() == mesh.default_mesh() == [torch.device("cpu")]
    assert mesh.make_mesh(1) == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="need 2 devices"):
        mesh.make_mesh(2)


ENTRY_POINTS = ["em_torch", "engine_device", "join_default_device",
                "score_tasks_torch", "sharded_assembly_step", "sharded_verify",
                "verify_overlaps"]


def _entry_call(name):
    """An entry point of the torch backend, called with no device named."""
    codes, quals, lens = tiny_rows()
    tasks = np.array([0, 3]), np.array([1, 2]), np.array([5, 0])
    store = port_store(dryrun_store())
    seqs = [store.unit_codes(u) for u in range(30)]
    return {
        "em_torch": lambda: abundance._em_torch(np.eye(3, dtype=np.float32),
                                                np.ones(3), np.ones(3), 5),
        "engine_device": lambda: single_end_candidates(store, 80, 0.0, engine="device"),
        "join_default_device": lambda: kmer_device.find_overlap_candidates_device(seqs, 80),
        "score_tasks_torch": lambda: score_tasks_torch(codes, quals, lens, *tasks),
        "sharded_assembly_step": lambda: mesh.sharded_assembly_step(
            None, codes, quals, lens, **STEP_KW),
        "sharded_verify": lambda: mesh.sharded_verify(None, codes, quals, lens, *tasks),
        "verify_overlaps": lambda: verify_overlaps(
            store, store.pack(), dryrun_overlaps(dryrun_store()), Settings(backend="torch")),
    }[name]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_needs_a_card_or_the_cpu_asked_for(entry, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    call = _entry_call(entry)
    monkeypatch.delenv("HC_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="HC_TORCH_DEVICE=cpu"):
        call()
    monkeypatch.setenv("HC_TORCH_DEVICE", "cpu")
    assert call() is not None


def test_cli_device_option(tmp_path, monkeypatch):
    """--device cpu asks for the CPU as HC_TORCH_DEVICE=cpu does; without
    it, and without a card, the torch backend stops with an error."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    store = dryrun_store()
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{store.seq_str(i)}\n+\n{store.phred_str(i)}\n"
                          for i in range(len(store))))
    args = ["savage", "-s", str(fq), "--split", "1", "--no_stage_b", "--no_stage_c",
            "--backend", "torch", "-o", str(tmp_path / "o")]
    monkeypatch.delenv("HC_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="HC_TORCH_DEVICE=cpu"):
        main(args)
    assert main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / "o" / "contigs_stage_a.fasta").read_text().count(">") > 0


def test_chip_smoke_tiny_workload_is_the_dry_runs():
    """chip_smoke.py phase 10 rebuilds the dry run's tiny workload without
    the JAX package: the same matrices and task stream."""
    import chip_smoke

    packed, lens, row_a, row_b, pos = _tiny_workload(n_tasks=64)
    got = chip_smoke.tiny_workload(n_tasks=64)
    np.testing.assert_array_equal(got[0], packed.codes)
    np.testing.assert_array_equal(got[1], packed.quals)
    np.testing.assert_array_equal(got[2], lens)
    for g, w in zip(got[3:], (row_a, row_b, pos)):
        np.testing.assert_array_equal(g, w)
