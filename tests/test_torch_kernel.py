"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions on the same card. The scoring kernel (and the f64 oracle):
integer columns equal; sum_log within rtol 1e-4 / atol 1e-3 of the plain
version (both add f32 segment sums of at most 512 lanes in f64, in other
orders within a segment). The join_verify kernel: the zero pattern of the
slot scores equal (decided by exact integers), scores within 1e-5 (f32
sums of log p in other orders), the slot count equal but for slots within
1e-5 of the threshold, at widths of one tile a row and of several, with
phreds past its table, rows whose slots are all invalid and a shard that
starts past row 0. The cache of the packed read matrix
(ops/device_cache.py): each matrix it assembles on the card equal to a
fresh upload, alone, through a mesh and from two threads. Every test
here needs a CUDA card and skips
without one. This file imports no jax, so on a machine without jax run it
alone, past the root conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

from haploconduct_torch.ops import kernels
from haploconduct_torch.ops.join_verify import join_verify_plain, kmer_queries
from haploconduct_torch.ops.kmer_device import kmer_hashes, kmer_table
from haploconduct_torch.ops.score import (pack_for_device, score_tasks_numpy,
                                          score_tasks_plain, score_tasks_torch)
from haploconduct_torch.parallel.mesh import sharded_assembly_step, sharded_score_tasks

from torch_helpers import (cuda_device, far_threshold, random_matrix,  # noqa: F401
                           random_tasks)

CARD_SHAPES = {
    # (R, W, min row length, tasks, slack, lowest row_a)
    "envelope_reads": (20_000, 150, 150, 400_000, 90, 0),
    "kb_contigs": (64, 6200, 4000, 1024, 2000, 0),
    "rows_over_2^16": ((1 << 16) + 512, 64, 40, 4096, 34, (1 << 16) + 512 - 4096),
    "wide_9kb": (1600, 9000, 800, 1024, 100, 0),
    # tasks of 0 to 9,000 lanes in one launch
    "mixed_lengths": (400, 9000, 0, 4096, 0, 0),
    # phreds above the kernel's table take its inline branch
    "quals_to_255": (2000, 150, 100, 20_000, 60, 0),
}


def card_case(shape, device):
    R, W, lmin, B, slack, lo = CARD_SHAPES[shape]
    rng = np.random.default_rng(20)
    codes, quals, lens = random_matrix(rng, R, W, lmin)
    if shape == "quals_to_255":
        quals = np.where(codes < 5, rng.integers(0, 256, quals.shape), 0).astype(np.uint8)
    row_a, row_b, pos = random_tasks(rng, lens, B, slack, lo)
    pos[:3] = lens[row_a[:3]] + np.arange(3)  # degenerate tasks
    cols = [torch.from_numpy(np.asarray(c, np.int32)).to(device)
            for c in (lens, row_a, row_b, pos)]
    return (codes, quals, lens, row_a, row_b, pos,
            pack_for_device(codes, quals, device), cols)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 32])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(cuda_device, shape, group):
    *_, comb, cols = card_case(shape, cuda_device)
    for th in (0.0, far_threshold()):
        before = kernels.score_tasks_cuda.launches
        got = kernels.score_tasks_cuda(comb, *cols, th, group=group)
        want = score_tasks_plain(comb, *cols, th)
        torch.cuda.synchronize()
        assert kernels.score_tasks_cuda.launches == before + 1
        assert got[0].dtype == torch.float64
        for j in (1, 2, 3):
            assert torch.equal(got[j], want[j])
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-3)
        if th > 0:
            assert int(got[3].sum()) > 0  # the threshold is exercised


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["envelope_reads", "kb_contigs", "quals_to_255"])
def test_score_tasks_torch_on_card_matches_oracle(cuda_device, shape):
    codes, quals, lens, row_a, row_b, pos, *_ = card_case(shape, cuda_device)
    keep = slice(0, 3000)  # the oracle's (B, W) temporaries stay small
    args = (codes, quals, lens, row_a[keep], row_b[keep], pos[keep])
    before = kernels.score_tasks_cuda.launches
    tst = score_tasks_torch(*args, device=cuda_device)
    assert kernels.score_tasks_cuda.launches == before + 1
    ts64 = score_tasks_numpy(*args)
    np.testing.assert_array_equal(tst.counted, ts64.counted)
    np.testing.assert_array_equal(tst.mismatches, ts64.mismatches)
    np.testing.assert_array_equal(tst.rejected, ts64.rejected)
    np.testing.assert_allclose(tst.score, ts64.score, atol=2e-4)


@pytest.mark.cuda
def test_kernel_empty_stream_and_bad_columns(cuda_device):
    comb = torch.zeros((4, 8), dtype=torch.int16, device=cuda_device)
    lens = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    before = kernels.score_tasks_cuda.launches
    out = kernels.score_tasks_cuda(comb, lens, empty, empty, empty, 0.0)
    assert all(o.shape == (0,) for o in out)
    assert kernels.score_tasks_cuda.launches == before
    col64 = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.score_tasks_cuda(comb, lens, col64, col64, col64, 0.0)
    col = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # rows not a multiple of 8 words
        kernels.score_tasks_cuda(comb[:, :6].contiguous(), lens, col, col, col, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["envelope_reads", "kb_contigs"])
def test_sharded_score_tasks_on_cards_matches_one_call(cuda_device, shape):
    """parallel/mesh.py on the card: two shards on one card, and every
    visible card when there are several, launch the kernel once a shard
    and give one call's per-task columns bit for bit (each task is summed
    whole by one launch)."""
    codes, quals, lens, row_a, row_b, pos, *_ = card_case(shape, cuda_device)
    args = (codes, quals, lens, row_a, row_b, pos)
    lists = [[cuda_device, cuda_device]]
    if torch.cuda.device_count() > 1:
        lists.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    for th in (0.0, far_threshold()):
        one = score_tasks_torch(*args, mismatch_thresh=th, device=cuda_device)
        for devices in lists:
            before = kernels.score_tasks_cuda.launches
            got = sharded_score_tasks(*args, mismatch_thresh=th, mesh=devices)
            assert kernels.score_tasks_cuda.launches == before + len(devices)
            for name in one._fields:
                np.testing.assert_array_equal(getattr(got, name), getattr(one, name))


JOIN_SHAPES = {
    # (rows, width, shortest row, genome length, phreds, rows the CPU checks)
    "reads_150": (6000, 150, 120, 20_000, (20, 40), 400),
    "contigs_2kb": (240, 2000, 800, 30_000, (20, 40), 6),
    # phreds above the kernel's table take its inline branch
    "reads_quals_to_255": (2000, 150, 120, 8_000, (2, 255), 400),
    # every third row all N: each of its slots is invalid
    "all_n_rows": (2000, 150, 120, 8_000, (20, 40), 400),
    # a shard of query rows that starts past row 0
    "shard_row0": (2000, 150, 120, 8_000, (20, 40), 400),
}
SHARD_ROWS = (700, 1300)
JOIN_KW = dict(expand=8, min_overlap_len=30, edge_threshold=0.97)


def join_case(shape, device, k=13):
    """Rows cut from a random genome (so they share k-mers), a few N
    bases, random phreds; the kernel's inputs over every row."""
    R, W, lmin, genome_len, (qmin, qmax), _ = JOIN_SHAPES[shape]
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    lens = rng.integers(lmin, W + 1, R).astype(np.int32)
    codes = np.full((R, W), 5, np.int8)
    quals = np.zeros((R, W), np.uint8)
    for i, n in enumerate(lens):
        start = int(rng.integers(0, genome_len - n + 1))
        codes[i, :n] = genome[start:start + n]
        quals[i, :n] = rng.integers(qmin, qmax + 1, n)
    codes[(rng.random((R, W)) < 0.002) & (codes < 4)] = 4
    if shape == "all_n_rows":
        codes[::3][codes[::3] < 4] = 4
    comb = pack_for_device(codes, quals, device)
    nk = W - k + 1
    tkey, t_rid, t_pos = kmer_table(kmer_hashes(comb[:, :W] & 7, k).reshape(-1), nk)
    row0, row1 = SHARD_ROWS if shape == "shard_row0" else (0, R)
    left, count = kmer_queries(comb, W, k, tkey, row0, row1)
    lens_d = torch.from_numpy(lens).to(device)
    return (codes, quals, lens), (comb, lens_d, t_rid, t_pos, left, count, row0, nk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(JOIN_SHAPES))
def test_join_verify_matches_plain_on_card(cuda_device, shape):
    _, args = join_case(shape, cuda_device)
    kw = JOIN_KW
    before = kernels.join_verify_cuda.launches
    got = kernels.join_verify_cuda(*args, kw["expand"], kw["min_overlap_len"],
                                   kw["edge_threshold"])
    want = join_verify_plain(*args, kw["expand"], kw["min_overlap_len"],
                             kw["edge_threshold"])
    torch.cuda.synchronize()
    assert kernels.join_verify_cuda.launches == before + 1
    gs, ws = got[0].cpu().numpy(), want[0].cpu().numpy()
    np.testing.assert_array_equal(gs == 0, ws == 0)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    near = int(np.sum(np.abs(ws - kw["edge_threshold"]) < 1e-5))
    assert abs(int(got[1]) - int(want[1])) <= near
    assert int(want[1]) > 0 and np.any(ws == 0)
    if shape == "all_n_rows":
        by_row = gs.reshape(-1, args[-1] * kw["expand"])
        assert not np.any(by_row[::3]) and np.any(by_row[1::3])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["reads_150", "contigs_2kb"])
def test_sharded_assembly_step_on_cards(cuda_device, shape):
    """One launch a shard; two shards on one card, and every visible card
    when there are several, give one device's scores bit for bit; the CPU
    (the plain version) agrees to the stated tolerance."""
    (codes, quals, lens), _ = join_case(shape, cuda_device)
    kw = dict(JOIN_KW, k=13)
    one = sharded_assembly_step([cuda_device], codes, quals, lens, **kw)
    lists = [[cuda_device, cuda_device]]
    if torch.cuda.device_count() > 1:
        lists.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    for devices in lists:
        before = kernels.join_verify_cuda.launches
        got = sharded_assembly_step(devices, codes, quals, lens, **kw)
        assert kernels.join_verify_cuda.launches == before + len(devices)
        np.testing.assert_array_equal(got[0], one[0])
        assert got[1] == one[1]
    n = JOIN_SHAPES[shape][-1]  # the CPU's plain version checks the first rows
    cpu = sharded_assembly_step([torch.device("cpu")], codes[:n], quals[:n], lens[:n], **kw)
    part = sharded_assembly_step([cuda_device], codes[:n], quals[:n], lens[:n], **kw)
    np.testing.assert_array_equal(part[0] == 0, cpu[0] == 0)
    np.testing.assert_allclose(part[0], cpu[0], rtol=0, atol=1e-5)


def _cache_inputs():
    """Four iterations' (codes, quals, lens_by_row) for the cache of the
    packed read matrix: 3,000 reads; then 2,400 of them forwarded, 200
    stored reverse-complemented and 400 longer units (the width grows);
    the first matrix again; its first 1,000 units (the width shrinks)."""
    from haploconduct_torch.core.reads import ReadStore, revcomp_codes

    rng = np.random.default_rng(8)

    def unit(n):
        return rng.integers(0, 4, n).astype(np.int8), rng.integers(2, 41, n).astype(np.uint8)

    units = [unit(int(n)) for n in rng.integers(100, 151, 3000)]
    nxt = (units[:2400] + [(revcomp_codes(c), q[::-1].copy()) for c, q in units[2400:2600]]
           + [unit(int(n)) for n in rng.integers(200, 301, 400)])
    out = []
    for us in (units, nxt, units, units[:1000]):
        store = ReadStore()
        for i, (c, q) in enumerate(us):
            store.add_single_codes(i, c, q)
        store.readcount_single = len(us)
        packed = store.pack()
        out.append((packed.codes, packed.quals, np.concatenate([packed.lens, packed.lens])))
    return out


@pytest.mark.cuda
def test_cached_matrix_on_card_equals_a_fresh_upload(cuda_device):
    """Each iteration's matrix, assembled on the card from the last one's
    rows and the changed rows, is torch.equal to a fresh upload, through
    comb_for_devices and through a mesh of card 0 twice; every iteration
    after the first reuses rows, and the scores equal the cache off's."""
    from haploconduct_torch.ops import device_cache
    from haploconduct_torch.ops.score import pack_host

    card = torch.device("cuda", torch.cuda.current_device())
    seq = _cache_inputs()
    device_cache.reset_stats()
    for i, (codes, quals, lens) in enumerate(seq):
        got = device_cache.comb_for_devices(codes, quals, lens, pack_host(codes, quals),
                                            [card])[0]
        assert got.device == card and got.data_ptr() % 16 == 0
        assert torch.equal(got, pack_for_device(codes, quals, card)), i
    stats = dict(device_cache.TRANSFER_STATS)
    assert stats["iterations"] == 4 and stats["reused_rows"] == 2 * (2600 + 2600 + 1000)
    assert stats["uploaded_bytes"] < stats["full_bytes"]
    rng = np.random.default_rng(2)
    for codes, quals, lens in seq:
        tasks = random_tasks(rng, lens, 20_000, 60)
        on = sharded_score_tasks(codes, quals, lens, *tasks, mesh=[card, card])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("HC_DEVICE_CACHE", "0")
            off = score_tasks_torch(codes, quals, lens, *tasks, device=card)
        for col in ("sum_log", "counted", "mismatches", "rejected"):
            np.testing.assert_array_equal(getattr(on, col), getattr(off, col))


@pytest.mark.cuda
def test_cached_matrices_of_two_threads_on_card(cuda_device):
    """Two threads that alternate between their own matrices on one card
    in lockstep each get their exact matrix."""
    import threading

    from haploconduct_torch.ops import device_cache
    from haploconduct_torch.ops.score import pack_host

    seq = _cache_inputs()
    card = torch.device("cuda", torch.cuda.current_device())
    barrier = threading.Barrier(2, timeout=60)
    errors = []

    def work(t):
        try:
            for i in range(6):
                barrier.wait()
                codes, quals, lens = seq[(2 * t + i) % 4]
                got = device_cache.comb_for_devices(codes, quals, lens,
                                                    pack_host(codes, quals), [card])[0]
                if not torch.equal(got, pack_for_device(codes, quals, card)):
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []


@pytest.mark.cuda
def test_launch_helper_counts_each_launch_and_no_captured_one(cuda_device):
    """kernels.launch_score_tasks, which the wrapper, torch_bench.py's
    repeat loop and torch_ab.py launch through, gives the wrapper's
    columns and counts each launch it enqueues; a launch recorded into a
    CUDA graph is counted by whoever replays the graph, not here."""
    *_, comb, cols = card_case("envelope_reads", cuda_device)
    want = kernels.score_tasks_cuda(comb, *cols, 0.0)
    n = cols[1].shape[0]
    sum_log, ints = kernels.score_tasks_outputs(n, cuda_device)
    args = (comb, *cols, 0.0, int(comb.max()) >> 3, kernels.default_group(comb.shape[1]),
            sum_log, ints)

    def check():
        torch.cuda.synchronize()
        assert torch.equal(sum_log, want[0])
        for j, got in enumerate((ints[:n], ints[n:2 * n], ints[2 * n:3 * n]), 1):
            assert torch.equal(got, want[j])

    before = kernels.score_tasks_cuda.launches
    kernels.launch_score_tasks(*args)
    assert kernels.score_tasks_cuda.launches == before + 1
    check()
    sum_log.zero_()
    ints.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.launch_score_tasks(*args)
    assert kernels.score_tasks_cuda.launches == before + 1
    graph.replay()
    check()
