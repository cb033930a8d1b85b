"""The plain reference and the judge at small sizes."""

import math

import numpy as np
import torch

import bench_helpers  # noqa: F401
from benchlib import judge, reference

CPU = torch.device("cpu")


def scalar_score(a, qa, b, qb, pos):
    """EdgeCalculator's score, one position at a time, in Python floats."""
    s = 0.0
    n = mism = 0
    for i in range(min(len(a) - pos, len(b))):
        x, y = a[pos + i], b[i]
        if x >= 4 or y >= 4:
            continue
        p1, p2 = 10 ** (-int(qa[pos + i]) / 10), 10 ** (-int(qb[i]) / 10)
        if x == y:
            p = (1 - p1) * (1 - p2) + p1 * p2 / 3
        else:
            p = (p1 * (1 - p2) + p2 * (1 - p1)) / 3 + 2 / 9 * p1 * p2
            mism += 1
        s += math.log(p)
        n += 1
    return math.exp(s / n), mism / n, n, mism


def toy_units(rng, n=6, length=40):
    units = []
    for _ in range(n):
        c = rng.integers(0, 4, length).astype(np.int8)
        c[rng.random(length) < 0.05] = 4
        units.append((c, rng.integers(2, 41, length).astype(np.uint8)))
    return units


def test_reference_scores_match_the_scalar_formula():
    rng = np.random.default_rng(3)
    units = toy_units(rng)
    codes, quals, lens = reference.oriented_rows(units)
    row_a = np.array([0, 1, 7, 2, 9])
    row_b = np.array([3, 4, 0, 8, 5])
    pos = np.array([0, 5, 12, 30, 1])
    out = reference.score_tasks(codes, quals, lens, row_a, row_b, pos, mismatch_thresh=0.0,
                                min_read_len=0, dtype=torch.float64, device=CPU)
    for t in range(len(pos)):
        s, m, n, k = scalar_score(codes[row_a[t]], quals[row_a[t]], codes[row_b[t]],
                                  quals[row_b[t]], int(pos[t]))
        assert abs(out["score"][t] - s) <= 1e-13 * s
        assert out["mismatch_rate"][t] == m
        assert out["counted"][t] == n and out["mismatches"][t] == k


def test_reverse_rows_are_reverse_complements():
    units = [(np.array([0, 1, 2, 3, 4], np.int8), np.arange(5, dtype=np.uint8))]
    codes, quals, lens = reference.oriented_rows(units)
    assert codes[1].tolist() == [4, 0, 1, 2, 3] and quals[1].tolist() == [4, 3, 2, 1, 0]
    assert lens.tolist() == [5, 5]


def test_float32_control_is_not_the_reference():
    rng = np.random.default_rng(4)
    units = toy_units(rng, 20, 150)
    call = {"units": units, "ids": np.arange(20), "id1": np.repeat(np.arange(10), 2),
            "id2": np.arange(20)[::-1], "ori1": np.ones(20, bool), "ori2": np.ones(20, bool),
            "pos1": np.tile([0, 3], 10), "edge_threshold": 0.97, "ov_threshold": 0.9,
            "merge_contigs": 0.0, "mismatch": 0.0, "min_read_len": 0}
    exact = judge.reference_scores(call, torch.float64, CPU)
    call["answer"] = exact
    assert judge.judge_call(call, CPU)["mismatch_rate_diffs"] == 0
    low = judge.judge_call(call, CPU, control=True)
    assert low["mismatch_rate_diffs"] > 0


def test_decisions():
    cls = reference.decisions(np.array([0.99, 0.95, 0.5, 0.2]), np.array([0.1, 0.1, 0.0, 0.3]),
                              0.97, 0.9, 0.0)
    assert cls.tolist() == [reference.EDGE, reference.NONEDGE, reference.EDGE, reference.NEITHER]


def test_consensus_disagreements():
    contig = reference.encode("ACGTACGTAC")
    read = reference.encode("GTACG")
    layout = [(read, 2, True)] * 5
    assert reference.consensus_disagreements([contig], [layout]) == (0, 5, 5, 0, 25)
    rc = reference._COMPLEMENT[read[::-1]]
    assert reference.consensus_disagreements([contig], [[(rc, 2, False)] * 5]) == (0, 5, 5, 0, 25)
    wrong = contig.copy()
    wrong[3] = 0
    assert reference.consensus_disagreements([wrong], [layout]) == (1, 5, 5, 0, 25)
    # no reads under a contig: every base unsupported, none judged
    assert reference.consensus_disagreements([contig], [[]]) == (0, 0, 10, 0, 0)
    # a contig cut short: its reads lie past its end
    assert reference.consensus_disagreements([contig[:5]], [layout]) == (0, 3, 2, 10, 25)


def test_contigs_are_placed_on_the_haplotypes_they_came_from():
    rng = np.random.default_rng(5)
    haps = [rng.integers(0, 4, 500).astype(np.int8)]
    haps.append(haps[0].copy())
    haps[1][::25] = (haps[1][::25] + 1) % 4
    index = reference.HaplotypeIndex(haps)
    piece = haps[1][100:300]
    assert index.place(piece) == (0, [(1, 100, 300)])
    back = reference._COMPLEMENT[piece[::-1]]
    assert index.place(back) == (0, [(1, 100, 300)])
    # a stretch where the haplotypes agree fits both
    assert index.place(haps[0][101:124]) == (0, [(0, 101, 124), (1, 101, 124)])
    # a chimera of the two haplotypes fits neither without mismatches
    chimera = np.concatenate([haps[0][100:200], haps[1][200:300]])
    assert index.place(chimera)[0] > 0
    # a base past a haplotype's end counts as a mismatch
    over = np.concatenate([haps[0][450:], rng.integers(0, 4, 30).astype(np.int8)])
    assert index.place(over)[0] >= 20
    mism, bases, uncovered, worst = reference.haplotype_agreement(
        [[piece], [haps[0][:250]]], haps)
    assert (mism, bases, worst) == (0, 450, 0.0)
    assert uncovered == 0.6


def test_the_contig_faults_move_their_numbers():
    rng = np.random.default_rng(6)
    hap = rng.integers(0, 4, 400).astype(np.int8)
    contigs = [hap[:220], hap[180:]]
    layouts = [[(c[j:j + 60], j, True) for j in range(0, len(c) - 59, 10) for _ in range(5)]
               for c in contigs]
    unit = {"haps": [hap], "sets": [{"contigs": contigs, "layouts": layouts}]}
    sound = judge.judge_contigs([unit])
    assert sound["unsupported_positions"] == 0 and sound["haplotype_uncovered_max"] == 0
    assert sound["read_outside_share"] == 0
    assert sound["contig_mismatch_share"] == 0 and sound["consensus_disagreements"] == 0
    faults = judge.contig_fault_readings([unit])
    assert faults["contigs_dropped"]["haplotype_uncovered_max"] > 0.4
    assert faults["contigs_truncated"]["read_outside_share"] > 0.4
    assert faults["subreads_emptied"]["unsupported_positions"] == 440
    assert faults["contig_base_altered"]["contig_mismatch_share"] == 2 / 440
