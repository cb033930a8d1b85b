"""Orientation labelling of haploconduct_torch against the JAX package.

The port's `vertex_labelling_heuristic` rewrites the edges it flips, moves
and deletes as whole arrays; the JAX package's keeps the per-edge loop of
`_switch_edge_orientation` and `list.remove`/`append`. On the same graph
both must leave the same edge rows byte for byte, the same alive mask, the
same adjacency lists in the same order, the same vertex orientations and
the same return value."""

import numpy as np
import pytest

from haploconduct_tpu.graph import algos as ref_algos
from haploconduct_tpu.graph.overlap_graph import OverlapGraph as RefGraph
from haploconduct_tpu.utils.config import Settings as RefSettings
from haploconduct_torch.graph import algos
from haploconduct_torch.graph.overlap_graph import OverlapGraph
from haploconduct_torch.ops.verify import EDGE_DTYPE
from haploconduct_torch.utils.config import Settings
from haploconduct_torch.utils.simulate import (
    mutate_sequence, random_genome, simulate_reads)

from torch_helpers import make_store, port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


def edge(v1, v2, ori1=True, ori2=True, pos1=10, pos2=0, pos3=5, pos4=0,
         ordc=b"-", score=0.99):
    e = np.zeros(1, dtype=EDGE_DTYPE)[0]
    e["v1"], e["v2"], e["score"] = v1, v2, score
    e["pos1"], e["pos2"], e["pos3"], e["pos4"] = pos1, pos2, pos3, pos4
    e["ori1"], e["ori2"], e["ord"] = ori1, ori2, ordc
    e["len1"], e["perc"] = 50, 50
    return e


def state_from_rows(n, rows, rng=None, dead=()):
    """A graph state (n, edges, alive, adj_out, adj_in): every edge not in
    `dead` listed under its endpoints, in id order or, with `rng`, in a
    shuffled order per list."""
    rows = np.array(rows, dtype=EDGE_DTYPE)
    alive = np.ones(len(rows), dtype=bool)
    alive[list(dead)] = False
    adj_out = [[] for _ in range(n)]
    adj_in = [[] for _ in range(n)]
    for e in np.flatnonzero(alive).tolist():
        adj_out[int(rows["v1"][e])].append(e)
        adj_in[int(rows["v2"][e])].append(e)
    if rng is not None:
        for lst in adj_out + adj_in:
            rng.shuffle(lst)
    return n, rows, alive, adj_out, adj_in


def build(graph_cls, settings, state):
    n, rows, alive, adj_out, adj_in = state
    g = graph_cls(n, None, settings)
    g.edges = rows.copy()
    g.alive = alive.copy()
    g.adj_out = [list(lst) for lst in adj_out]
    g.adj_in = [list(lst) for lst in adj_in]
    return g


def switch_branches():
    """One edge a component, both orientations against the labels, over
    every branch of the switch: pos3 positive, zero or negative (the new
    pos1), pos4 negative or not, each ord, v1 below or above v2 (the tie
    at pos3 == 0); next to them edges the labels keep and edges whose
    target is labelled the other way."""
    rows, v = [], 0
    for pos3 in (5, 0, -5):
        for pos4 in (3, -3):
            for ordc in (b"1", b"2", b"-"):
                for up in (True, False):
                    a, b = (v, v + 1) if up else (v + 1, v)
                    rows.append(edge(a, b, False, False, pos3=pos3, pos4=pos4,
                                     ordc=ordc))
                    v += 2
    for ori2 in (True, False):
        for pos3 in (4, 0, -4):
            rows.append(edge(v, v + 1, True, ori2, pos3=pos3, pos4=-2, ordc=b"1"))
            rows.append(edge(v + 1, v + 2, not ori2, True, pos3=pos3, ordc=b"2"))
            v += 3
    return state_from_rows(v, rows)


def parity_conflict():
    """Two odd-parity cycles sharing vertices with even chains: edges are
    deleted, passes 2..100 run, and the surviving edges are flipped and
    moved."""
    rows = [
        edge(0, 1), edge(1, 2), edge(0, 2, True, False, pos3=-3),
        edge(2, 3, False, False, pos3=-1, pos4=-2, ordc=b"1"),
        edge(3, 4, True, False, pos3=0), edge(4, 5), edge(5, 3, pos3=2),
        edge(5, 6, False, True, pos3=-6), edge(6, 0, False, False, pos3=0),
        edge(1, 4, False, True, pos3=7, pos4=-1, ordc=b"2"),
    ]
    return state_from_rows(7, rows)


def random_graph(seed):
    """Random multigraph with random parities, positions and ords, shuffled
    adjacency order and some dead rows."""
    rng = np.random.default_rng(seed)
    n = 200
    rows = []
    while len(rows) < 700:
        v1, v2 = rng.integers(0, n, size=2)
        if v1 == v2:
            continue
        rows.append(edge(int(v1), int(v2), bool(rng.integers(2)),
                         bool(rng.integers(2)), pos3=int(rng.integers(-6, 20)),
                         pos4=int(rng.integers(-10, 10)),
                         ordc=(b"1", b"2", b"-")[int(rng.integers(3))]))
    dead = rng.choice(len(rows), 25, replace=False)
    return state_from_rows(n, rows, rng=rng, dead=dead)


class _Captured(Exception):
    pass


def iteration1_state(monkeypatch, run):
    """The graph that the port's first run_iteration hands to labelling,
    taken before the call; `run` drives the port and is stopped there."""
    states = []

    def capture(g, stats=None):
        states.append((g.n, g.edges.copy(), g.alive.copy(),
                       [list(lst) for lst in g.adj_out],
                       [list(lst) for lst in g.adj_in]))
        raise _Captured

    monkeypatch.setattr(algos, "vertex_labelling_heuristic", capture)
    with pytest.raises(_Captured):
        run()
    monkeypatch.undo()
    return states[0]


def _both_strands(seqs, quals, rng):
    comp = str.maketrans("ACGT", "TGCA")
    flip = rng.random(len(seqs)) < 0.5
    return ([s[::-1].translate(comp) if f else s for s, f in zip(seqs, flip)],
            [q[::-1] if f else q for q, f in zip(quals, flip)])


def savage_patch(monkeypatch):
    """Iteration 1 of SAVAGE stage a on a 1 kb patch of 3 strains at 100x
    each, reads from both strands."""
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 1000)
    haps = [genome] + [mutate_sequence(genome, rng, sub_rate=0.03) for _ in range(2)]
    reads = _both_strands(*simulate_reads(haps, 100, 150, rng), rng)
    store = port_store(make_store(*reads))
    cfg = SavageConfig(split_num=1, stage_b=False, stage_c=False, backend="numpy")
    return iteration1_state(monkeypatch, lambda: run_savage(store, cfg))


def polyte_sample(monkeypatch):
    """Iteration 1 of POLYTE on a 2 kb diploid sample at 20x a haplotype,
    reads from both strands."""
    from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte

    rng = np.random.default_rng(12)
    hap1 = random_genome(rng, 2000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    reads = _both_strands(*simulate_reads([hap1, hap2], 20, 150, rng,
                                          error_rate=0.0), rng)
    store = port_store(make_store(*reads))
    cfg = PolyteConfig(backend="numpy", candidates="host", hap_cov=20,
                       insert_size=150, stddev=15, min_overlap_len=60,
                       min_overlap_len_EC=77)
    return iteration1_state(monkeypatch, lambda: run_polyte(store, cfg))


CASES = {
    "switch_branches": lambda mp: switch_branches(),
    "parity_conflict": lambda mp: parity_conflict(),
    "random_1": lambda mp: random_graph(1),
    "random_2": lambda mp: random_graph(2),
    "random_3": lambda mp: random_graph(3),
    "savage_patch": savage_patch,
    "polyte_sample": polyte_sample,
}


def label_both(state, monkeypatch):
    """(port graph, its stats, its return, reference graph, its return,
    how many edges the reference's per-edge loop switched)."""
    calls = []
    switch = ref_algos._switch_edge_orientation

    def counted(g, e):
        calls.append(e)
        return switch(g, e)

    monkeypatch.setattr(ref_algos, "_switch_edge_orientation", counted)
    ref = build(RefGraph, RefSettings(), state)
    ref_ret = ref_algos.vertex_labelling_heuristic(ref)
    got = build(OverlapGraph, Settings(), state)
    stats = {}
    got_ret = algos.vertex_labelling_heuristic(got, stats)
    return got, stats, got_ret, ref, ref_ret, len(calls)


@pytest.mark.parametrize("case", list(CASES))
def test_labelling_matches_the_per_edge_loop(case, monkeypatch):
    state = CASES[case](monkeypatch)
    got, stats, got_ret, ref, ref_ret, n_switched = label_both(state, monkeypatch)
    assert got_ret == ref_ret
    assert got.edges.tobytes() == ref.edges.tobytes()
    assert np.array_equal(got.alive, ref.alive)
    assert got.adj_out == ref.adj_out
    assert got.adj_in == ref.adj_in
    assert np.array_equal(got.vertex_orientations, ref.vertex_orientations)
    flat, v_of = got._flat_adj_out()
    assert flat.tolist() == [e for lst in got.adj_out for e in lst]
    assert v_of.tolist() == [v for v, lst in enumerate(got.adj_out) for _ in lst]
    assert stats["label_flipped"] + stats["label_moved"] == n_switched
    if case in ("switch_branches", "parity_conflict", "savage_patch",
                "polyte_sample"):
        # the case reaches what it was built for
        assert stats["label_flipped"] > 0 and stats["label_moved"] > 0
    if case in ("parity_conflict", "random_1"):
        assert got_ret > 0


def test_label_counts_reach_the_iteration_stats():
    """run_iteration records the rewrite's two counts beside `conflicts`,
    equal to what the reference's per-edge loop switches on that graph."""
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    rng = np.random.default_rng(13)
    genome = random_genome(rng, 800)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    reads = _both_strands(*simulate_reads(haps, 60, 150, rng), rng)
    res = run_savage(port_store(make_store(*reads)), SavageConfig(
        split_num=1, stage_b=False, stage_c=False, backend="numpy"))
    history = [h for h in res.stage_a.history if "conflicts" in h]
    assert history
    for h in history:
        assert h["label_flipped"] >= 0 and h["label_moved"] >= 0
    assert sum(h["label_flipped"] + h["label_moved"] for h in history) > 0
