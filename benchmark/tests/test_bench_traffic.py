"""The traffic: seeded draws of the configurations' units."""

import json
import os

import numpy as np

import bench_helpers
from benchlib import reference, simulate


def shapes(config):
    with open(os.path.join(bench_helpers.BENCH, "configs", config + ".json")) as f:
        return json.load(f)["shapes"]


def read_set(unit):
    return {c.tobytes() for c, _ in unit.reads}


def test_unit_sizes_are_the_configurations():
    unit = simulate.draw_unit(7, "savage-patch", 0, shapes("savage-patch-667x"))
    assert len(unit.reads) == 4444 and unit.pairs == 0
    assert all(len(c) == 150 == len(q) for c, q in unit.reads)
    unit = simulate.draw_unit(7, "polyte-sample", 0, shapes("polyte-diploid-20x"))
    assert len(unit.reads) == 2664 and unit.pairs == 1332
    assert len(unit.haps) == 2 and len(unit.haps[0]) == 10000


def test_same_seed_same_reads_and_large_seeds():
    sh = dict(shapes("polyte-diploid-20x"), genome_len=1500)
    seed = 2**31 + 12345
    a = simulate.draw_unit(seed, "polyte-sample", 3, sh)
    b = simulate.draw_unit(seed, "polyte-sample", 3, sh)
    c = simulate.draw_unit(2**40 + 12345, "polyte-sample", 3, sh)
    assert read_set(a) == read_set(b) and a.pairs == b.pairs
    assert all(np.array_equal(x, y) for x, y in zip(a.haps, b.haps))
    assert read_set(a) != read_set(c)


def test_units_share_no_reads_and_streams_are_keyed_by_the_whole_name():
    sh = dict(shapes("savage-patch-667x"), genome_len=600)
    units = [read_set(simulate.draw_unit(11, "savage-patch", k, sh)) for k in range(4)]
    for k in range(4):
        for j in range(k):
            assert not units[k] & units[j]
    # names that agree in their first 8 bytes draw different units
    warm = read_set(simulate.draw_unit(11, "savage-patch-warmup", 0, sh))
    assert not warm & units[0]


def test_strains_differ_at_the_stated_share():
    sh = shapes("savage-patch-667x")
    unit = simulate.draw_unit(5, "savage-patch", 0, dict(sh, coverage=4))
    for h in unit.haps[1:]:
        assert int(np.sum(h != unit.haps[0])) == round(sh["divergence"] * sh["genome_len"])


def test_reads_come_from_both_strands_with_the_errors_their_phreds_state():
    sh = dict(shapes("savage-patch-667x"), genome_len=1000)
    unit = simulate.draw_unit(9, "savage-patch", 0, sh)
    index = reference.HaplotypeIndex(unit.haps)
    forward = mism = 0
    for codes, _ in unit.reads[:400]:
        mm, where = index.place(codes)
        h, lo, hi = where[0]
        mism += mm
        forward += bool(np.array_equal(codes[:20], unit.haps[h][lo:lo + 20]))
    assert 150 < forward < 250  # about half the reads lie forward
    phreds = np.stack([q for _, q in unit.reads]).astype(float)
    assert phreds[:, 0].mean() > phreds[:, -1].mean() + 5
    expected = np.power(10.0, -phreds[:400] / 10).sum()
    assert 0.5 * expected < mism < 1.6 * expected


def test_pairs_lie_an_insert_apart():
    sh = dict(shapes("polyte-diploid-20x"), genome_len=3000)
    unit = simulate.draw_unit(3, "polyte-sample", 0, sh)
    p = unit.pairs
    index = reference.HaplotypeIndex(unit.haps)
    spans = []
    for i in range(200):
        (h1, lo1, hi1), (h2, lo2, hi2) = (index.place(unit.reads[j][0])[1][0]
                                          for j in (i, p + i))
        if h1 == h2:
            spans.append(max(hi1, hi2) - min(lo1, lo2))
    assert abs(np.median(spans) - sh["insert_size"]) < 60
