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
- The reference's API: the same names, parameters and defaults for the
  mesh's entry points and `phred_probs`, each called as the reference's
  callers call it.
- Without a card, every entry point of the torch backend raises unless
  HC_TORCH_DEVICE=cpu asks for the CPU, and then runs the plain versions.
"""

import inspect

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_workload
from haploconduct_tpu.ops import score as ref_score
from haploconduct_tpu.parallel import mesh as ref_mesh
from haploconduct_tpu.ops.kmer import _kmer_hashes
from haploconduct_tpu.parallel.mesh import make_mesh as ref_make_mesh
from haploconduct_tpu.parallel.mesh import sharded_assembly_step as ref_step
from haploconduct_tpu.parallel.mesh import sharded_verify as ref_verify
from haploconduct_torch.cli import main
from haploconduct_torch.ops import abundance, kernels, kmer_device
from haploconduct_torch.ops.join_verify import (join_verify, join_verify_plain,
                                                kmer_queries, slot_diagonals)
from haploconduct_torch.ops.kmer_device import kmer_hashes, kmer_table
from haploconduct_torch.ops import score
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


def overlapping_rows(R=300, W=150, genome_len=1500, seed=23, k=13):
    """Rows cut from a short random genome, so that many k-mers of a row
    land on one partner at one shift, with a few N bases: the join's
    inputs over every row, on the CPU."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    lens = rng.integers(W - 30, W + 1, R).astype(np.int32)
    codes = np.full((R, W), 5, np.int8)
    quals = np.zeros((R, W), np.uint8)
    for i, n in enumerate(lens):
        start = int(rng.integers(0, genome_len - n + 1))
        codes[i, :n] = genome[start:start + n]
        quals[i, :n] = rng.integers(20, 41, n)
    codes[(rng.random((R, W)) < 0.002) & (codes < 4)] = 4
    comb = pack_for_device(codes, quals, "cpu")
    nk = W - k + 1
    tkey, t_rid, t_pos = kmer_table(kmer_hashes(comb[:, :W] & 7, k).reshape(-1), nk)
    left, count = kmer_queries(comb, W, k, tkey, 0, R)
    return comb, torch.from_numpy(lens), t_rid, t_pos, left, count, nk


def test_join_verify_plain_scores_a_diagonal_alike():
    """What the join_verify kernel rests on when it scores each distinct
    diagonal of a row once: the plain version, which scores every slot on
    its own, gives every slot of one diagonal (r, rb, shift) the same
    score bit for bit, and 0 to every invalid slot. The input really has
    duplicates: fewer than a quarter as many diagonals as valid slots."""
    comb, lens, t_rid, t_pos, left, count, nk = overlapping_rows()
    expand = 8
    scores, _ = join_verify_plain(comb, lens, t_rid, t_pos, left, count, 0, nk,
                                  expand, 30, 0.97)
    scores = scores.numpy().reshape(-1, expand)
    q = torch.arange(left.shape[0])
    r, rb, shift, valid = slot_diagonals(t_rid, t_pos, left, count, q, 0, nk, expand)
    valid = valid.numpy()
    key = ((r[:, None] * len(lens) + rb) * nk + shift).numpy()[valid]
    assert np.all(scores[~valid] == 0)
    bits = scores[valid].view(np.int32)
    order = np.argsort(key, kind="stable")
    key, bits = key[order], bits[order]
    same = key[1:] == key[:-1]
    np.testing.assert_array_equal(bits[1:][same], bits[:-1][same])
    assert np.unique(key).size < valid.sum() / 4
    assert np.any(bits != 0)


@pytest.mark.parametrize("tile", [None, 2048, 100])
def test_chip_smoke_diagonal_counts(tile):
    """chip_smoke.py phase 10 (b)'s count of the valid slots and of the
    distinct diagonals the kernel scores a tile of a row, with their
    lanes, against a count slot by slot; tiles of 100 slots split rows,
    so they leave repeats that whole rows do not."""
    import chip_smoke

    comb, lens, t_rid, t_pos, left, count, nk = overlapping_rows(R=60)
    expand = 8
    got = chip_smoke.diagonal_counts(torch, lens, t_rid, t_pos, left, count, nk,
                                     expand, tile=tile)
    q = torch.arange(left.shape[0])
    r, rb, shift, valid = (t.numpy() for t in slot_diagonals(
        t_rid, t_pos, left, count, q, 0, nk, expand))
    seen = set()
    for qi, d in zip(*np.nonzero(valid)):
        slot = (qi % nk) * expand + d
        seen.add((r[qi], 0 if tile is None else slot // tile, rb[qi, d], shift[qi, d]))
    lanes = sum(max(0, min(int(lens[a]) - s, int(lens[b]))) for a, _, b, s in seen)
    assert got == (int(valid.sum()), len(seen), lanes)
    if tile is not None and tile < nk * expand:
        assert got[1] > chip_smoke.diagonal_counts(
            torch, lens, t_rid, t_pos, left, count, nk, expand)[1]


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


REFERENCE_API = [(ref_mesh, mesh, "make_mesh"), (ref_mesh, mesh, "device_count"),
                 (ref_mesh, mesh, "sharded_score_tasks"), (ref_mesh, mesh, "sharded_verify"),
                 (ref_mesh, mesh, "sharded_assembly_step"),
                 (ref_score, score, "phred_probs")]


@pytest.mark.parametrize("ref_mod, port_mod, name", REFERENCE_API,
                         ids=[n for *_, n in REFERENCE_API])
def test_reference_api_names_and_defaults(ref_mod, port_mod, name):
    """A caller written to the reference's API finds the same function,
    parameter names (in order) and defaults in the port."""
    want = inspect.signature(getattr(ref_mod, name)).parameters
    got = inspect.signature(getattr(port_mod, name)).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default for p in want.values()]


@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_sharded_score_tasks_reference_keywords(thresh):
    """sharded_score_tasks called by keyword as the reference's callers
    call it (unit_lens_by_row=, mesh=), on two devices of each package:
    integer columns and mismatch rates equal, sum_log within rtol 1e-4 /
    atol 1e-3 and scores within 1e-5 (f32 segment sums in other orders)."""
    codes, quals, lens, row_a, row_b, pos = multi_segment_case()
    kw = dict(codes=codes, quals=quals, unit_lens_by_row=lens, row_a=row_a,
              row_b=row_b, pos=pos, mismatch_thresh=thresh, min_read_len=300)
    want = ref_mesh.sharded_score_tasks(**kw, mesh=ref_make_mesh(2))
    got = mesh.sharded_score_tasks(**kw, mesh=cpus(2))
    for name in ("counted", "mismatches", "rejected", "mismatch_rate"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.sum_log, want.sum_log, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.score, want.score, rtol=0, atol=1e-5)
    assert np.any(want.score > 0) if thresh == 0 else not np.any(want.score > 0)


def test_mesh_keyword_of_verify_and_step():
    """sharded_verify(mesh=...) and sharded_assembly_step(mesh=...) by
    keyword give what the positional calls give."""
    codes, quals, lens, row_a, row_b, pos = multi_segment_case()
    by_kw = mesh.sharded_verify(mesh=cpus(2), codes=codes, quals=quals,
                                lens_by_row=lens, row_a=row_a, row_b=row_b, pos=pos)
    for g, w in zip(by_kw, mesh.sharded_verify(cpus(2), codes, quals, lens,
                                               row_a, row_b, pos)):
        np.testing.assert_array_equal(g, w)
    codes, quals, lens = tiny_rows()
    got = mesh.sharded_assembly_step(mesh=cpus(2), codes=codes, quals=quals,
                                     lens=lens, **STEP_KW)
    want = mesh.sharded_assembly_step(cpus(2), codes, quals, lens, **STEP_KW)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 0


def test_make_mesh_axis_and_device_count(monkeypatch):
    """make_mesh takes the reference's axis name, which names the port's
    one axis and changes nothing; device_count() is the default mesh's
    length, here the CPU asked for, and follows default_mesh()."""
    assert mesh.make_mesh(1, axis="data") == mesh.make_mesh(axis="data") == cpus(1)
    assert mesh.device_count() == len(mesh.default_mesh()) == 1
    monkeypatch.setattr(mesh, "default_mesh", lambda: cpus(3))
    assert mesh.device_count() == 3
    assert mesh.make_mesh(2, axis="data") == cpus(2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("qtype", [np.uint8, np.int64, np.int32])
def test_phred_probs_is_the_references(qtype, dtype):
    """Bit for bit, through the uint8 table and the direct expression."""
    q = np.arange(256).astype(qtype)
    got = score.phred_probs(q, dtype)
    want = ref_score.phred_probs(q, dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


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
