"""FNO1's reconsideration of non-edge overlaps in haploconduct_torch against
the JAX package's.

The port's `FNO1._reconsider_nonedges` turns every stored non-edge overlap
into a pseudo-edge row at once, drops the pairs that share an edge of score
above 0 with one lookup of packed keys, and sends the rows through the batch
path in row order; the JAX package's keeps the per-row loop over
`check_edge` and the scalar `_update_overlap`. Each package runs its own
workflow on the same reads up to the same FNO1 call; there both FNO1s get
the same non-edge overlaps and must give the same sorted lines and the same
`found` pair keys, and the port's two counters must count the rows that
pass the edge check and those that touch paired reads or paired
superreads."""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

from haploconduct_tpu.assemble import fno as ref_fno
from haploconduct_tpu.assemble import iteration as ref_iteration
from haploconduct_tpu.core.reads import ReadStore as RefReadStore
from haploconduct_tpu.io.overlaps import OVERLAP_DTYPE, empty_overlaps
from haploconduct_torch.assemble import fno
from haploconduct_torch.assemble import iteration
from haploconduct_torch.utils.simulate import (
    mutate_sequence, random_genome, simulate_paired_reads, simulate_reads)

from torch_helpers import make_store, port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


class _Captured(Exception):
    pass


def _both_strands(seqs, quals, rng):
    comp = str.maketrans("ACGT", "TGCA")
    flip = rng.random(len(seqs)) < 0.5
    return ([s[::-1].translate(comp) if f else s for s, f in zip(seqs, flip)],
            [q[::-1] if f else q for q, f in zip(quals, flip)])


def _capture(module, run, call):
    """(builder, non-edge overlaps) that the `call`-th FNO1 of `run` gets
    (counting from 0); the workflow is stopped there."""
    real, seen = module.FNO1, []

    def make(builder):
        obj = real(builder)

        def stop(nonedge_overlaps=None):
            seen.append((builder, nonedge_overlaps))
            if len(seen) > call:
                raise _Captured
            return real.run(obj, nonedge_overlaps)

        obj.run = stop
        return obj

    module.FNO1 = make
    try:
        with pytest.raises(_Captured):
            run()
    finally:
        module.FNO1 = real
    return seen[-1]


def polyte_reads():
    """A 2 kb diploid sample at 20x a haplotype, reads from both strands."""
    rng = np.random.default_rng(12)
    hap1 = random_genome(rng, 2000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    return make_store(*_both_strands(*simulate_reads([hap1, hap2], 20, 150, rng),
                                     rng))


def savage_reads():
    """A 1 kb patch of 3 strains at 100x each, 1% misread bases, reads from
    both strands."""
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 1000)
    haps = [genome] + [mutate_sequence(genome, rng, sub_rate=0.03) for _ in range(2)]
    return make_store(*_both_strands(*simulate_reads(haps, 100, 150, rng,
                                                     error_rate=0.01), rng))


def savage_paired_reads():
    """A 1 kb patch of 2 strains: single reads at 40x and pairs at 80x."""
    rng = np.random.default_rng(21)
    genome = random_genome(rng, 1000)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    p1, p2, quals = simulate_paired_reads(haps, 80, 150, 400, 40, rng)
    seqs, squals = simulate_reads(haps, 40, 150, rng)
    store = RefReadStore()
    for i, (s, q) in enumerate(zip(seqs, squals)):
        store.add_single(i, s, q)
    store.readcount_single = len(seqs)
    for j, (a, b, q) in enumerate(zip(p1, p2, quals)):
        store.add_paired(len(seqs) + j, a, q, b, q)
    return store


def _polyte(pkg):
    from importlib import import_module

    mod = import_module(f"{pkg}.workflows.polyte")
    cfg = mod.PolyteConfig(backend="numpy", candidates="host", hap_cov=20,
                           insert_size=150, stddev=15, min_overlap_len=60,
                           min_overlap_len_EC=77, diploid=True)
    return lambda store: mod.run_polyte(store, cfg)


def _savage(pkg):
    from importlib import import_module

    mod = import_module(f"{pkg}.workflows.savage")
    cfg = mod.SavageConfig(split_num=1, stage_b=False, stage_c=False,
                           backend="numpy")
    return lambda store: mod.run_savage(store, cfg)


WORKFLOWS = {"polyte": (polyte_reads, _polyte),
             "savage": (savage_reads, _savage),
             "savage_paired": (savage_paired_reads, _savage)}


@lru_cache(maxsize=None)
def captured(workflow, call):
    """(reference builder, port builder, non-edge overlaps) at the
    `call`-th FNO1 of each package's run of `workflow` on the same reads."""
    reads, runner = WORKFLOWS[workflow]
    ref_store = reads()
    ref_b, ref_ne = _capture(ref_iteration,
                             lambda: runner("haploconduct_tpu")(ref_store), call)
    got_b, got_ne = _capture(iteration,
                             lambda: runner("haploconduct_torch")(port_store(ref_store)),
                             call)
    # the two workflows reached the same state
    assert got_ne.tobytes() == ref_ne.tobytes()
    assert (got_b.g.edges[got_b.g.alive].tobytes()
            == ref_b.g.edges[ref_b.g.alive].tobytes())
    assert np.array_equal(got_b.visited, ref_b.visited)
    assert got_b.nodes_to_new_ids == ref_b.nodes_to_new_ids
    return ref_b, got_b, ref_ne


def synthetic_rows(b, seed, n=400):
    """Non-edge overlaps over every branch of updateOverlap: neither, one
    or the other, or both endpoints inside superreads; pairs that share an
    edge of score above 0, forward or reverse only (dropped); perc2 0 and
    odd perc1 + perc2; pairs from the same superreads as a current edge
    (their keys are found first); rows repeated. Returns the rows and how
    many of each kind were made."""
    rng = np.random.default_rng(seed)
    g, store = b.g, b.store
    ids = np.asarray(store.ids, dtype=np.uint64)
    vis = np.flatnonzero(b.visited)
    unv = np.array(sorted(k for k in b.nodes_to_new_ids if not b.visited[k]),
                   dtype=np.int64)
    pairs, kinds = [], {}

    def add(kind, u, v):
        pairs.append((int(u), int(v)))
        kinds[kind] = kinds.get(kind, 0) + 1

    for _ in range(n):
        kind = ("neither", "first", "second", "both")[int(rng.integers(4))]
        a = vis if kind in ("first", "both") else unv
        c = vis if kind in ("second", "both") else unv
        if len(a) == 0 or len(c) == 0:
            continue
        u, v = int(rng.choice(a)), int(rng.choice(c))
        if u != v:
            add(kind, u, v)
    alive = np.flatnonzero(g.alive)
    fwd = {(int(g.edges["v1"][e]), int(g.edges["v2"][e])) for e in alive}
    for e in rng.choice(alive, min(40, len(alive)), replace=False):
        u, v = int(g.edges["v1"][e]), int(g.edges["v2"][e])
        add("forward_edge", u, v)
        if (v, u) not in fwd:
            add("reverse_edge", v, u)
    members = {}
    for sr in b.single_SR + b.paired_SR:
        for node in sr.sorted_clique1:
            members.setdefault(node, sr.sorted_clique1)
    for e in alive:
        u, v = int(g.edges["v1"][e]), int(g.edges["v2"][e])
        if u in members and v in members:
            u2 = int(rng.choice(members[u]))
            v2 = int(rng.choice(members[v]))
            if u2 != v2 and g.check_edge(u2, v2) < 0:
                add("edge_superreads", u2, v2)
        if kinds.get("edge_superreads", 0) >= 30:
            break
    rows = np.zeros(len(pairs), dtype=OVERLAP_DTYPE)
    uu = np.array([p[0] for p in pairs], dtype=np.int64)
    vv = np.array([p[1] for p in pairs], dtype=np.int64)
    rows["id1"], rows["id2"] = ids[uu], ids[vv]
    rows["pos1"] = rng.integers(0, 120, len(rows))
    rows["pos2"] = np.where(rng.random(len(rows)) < 0.5, 0,
                            rng.integers(-60, 60, len(rows)))
    rows["ord"] = rng.choice([b"-", b"1", b"2"], len(rows))
    rows["ori1"] = rng.choice([b"+", b"-"], len(rows))
    rows["ori2"] = rng.choice([b"+", b"-"], len(rows))
    rows["perc1"] = rng.integers(0, 101, len(rows))
    rows["perc2"] = np.where(rng.random(len(rows)) < 0.4, 0,
                             rng.integers(1, 101, len(rows)))
    rows["perc1"][:8] = 100
    rows["perc2"][:8] = [0, 100, 99, 0, 1, 100, 0, 98]
    rows["len1"] = rng.integers(1, 150, len(rows))
    rows["len2"] = rng.integers(0, 150, len(rows))
    rows["type1"], rows["type2"] = b"s", b"s"
    rows = np.concatenate([rows, rows[rng.choice(len(rows), 25)]])
    kinds["repeated"] = 25
    return rows[rng.permutation(len(rows))], kinds


def with_twin_edges(b, seed):
    """A copy of builder `b` whose graph has more edges between reads
    outside superreads (whose pseudo-edges emit their own lines, in their
    own direction), and non-edge overlaps over them: u -> v of score 0.9
    beside v -> u of score 0 (the forward edge decides for each direction),
    and u -> w of score 0 before u -> w of score 0.9 (the first in
    adjacency order decides)."""
    import copy

    rng = np.random.default_rng(seed)
    g = copy.copy(b.g)
    g.edges, g.alive = b.g.edges.copy(), b.g.alive.copy()
    g.adj_out = [list(lst) for lst in b.g.adj_out]
    g.adj_in = [list(lst) for lst in b.g.adj_in]
    g.invalidate_adj_cache()
    twin = copy.copy(b)
    twin.g = g
    unv = [k for k in sorted(b.nodes_to_new_ids) if not b.visited[k]]
    row = g.edges[np.flatnonzero(g.alive)[0]].copy()
    pairs = []
    for n_pair in range(40):
        u, v = (int(x) for x in rng.choice(unv, 2, replace=False))
        if g.check_edge(u, v) >= 0:
            continue
        if n_pair % 2:  # the forward edge decides
            added = [(u, v, 0.9), (v, u, 0.0)]
        else:  # the first u -> v decides
            added = [(u, v, 0.0), (u, v, 0.9)]
        for v1, v2, score in added:
            row["v1"], row["v2"], row["score"] = v1, v2, score
            g.add_edge(row)
        pairs += [(u, v), (v, u)]
    ids = np.asarray(b.store.ids, dtype=np.uint64)
    rows = np.zeros(len(pairs), dtype=OVERLAP_DTYPE)
    rows["id1"] = ids[[p[0] for p in pairs]]
    rows["id2"] = ids[[p[1] for p in pairs]]
    rows["pos1"], rows["ord"], rows["ori1"], rows["ori2"] = 30, b"-", b"+", b"-"
    rows["perc1"], rows["len1"], rows["type1"], rows["type2"] = 80, 120, b"s", b"s"
    return twin, rows


def expected_counts(fno1, overlaps):
    """(rows past checkEdge, rows that touch paired reads or paired
    superreads) by the per-row rule, on the reference's objects."""
    b, g, store = fno1.b, fno1.g, fno1.store
    any_paired = {node: any(sr.is_paired for sr in srs)
                  for node, srs in fno1.nodes_to_sr.items()}
    kept = scalar = 0
    for r in overlaps:
        u = store.id_to_index[int(r["id1"])]
        v = store.id_to_index[int(r["id2"])]
        if g.check_edge(u, v, reverse_allowed=True) > 0:
            continue
        kept += 1
        if b.visited[u] and b.visited[v]:
            scalar += any_paired.get(u, False) or any_paired.get(v, False)
        elif b.visited[u]:
            scalar += any_paired.get(u, False) or bool(store.is_paired[v])
        elif b.visited[v]:
            scalar += bool(store.is_paired[u]) or any_paired.get(v, False)
    return kept, scalar


CASES = {
    # name: (workflow, FNO1 call, its own non-edges, synthetic rows, no_inclusions)
    "polyte_it1": ("polyte", 0, True, False, False),
    "polyte_later": ("polyte", 2, True, True, False),
    "polyte_later_no_inclusions": ("polyte", 2, True, True, True),
    "polyte_later_twin_edges": ("polyte", 2, True, True, False),
    "savage_merge": ("savage", 0, True, False, False),
    "savage_paired": ("savage_paired", 0, True, True, False),
    "savage_paired_later": ("savage_paired", 3, True, False, False),
    "empty": ("polyte", 0, False, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nonedges_match_the_per_row_loop(case):
    workflow, call, own, synthetic, no_incl = CASES[case]
    ref_b, got_b, nonedge = captured(workflow, call)
    parts = [nonedge if own else empty_overlaps(0)]
    kinds = {}
    if synthetic:
        rows, kinds = synthetic_rows(ref_b, seed=call + 7)
        parts.append(rows)
    if case.endswith("twin_edges"):
        ref_b, twin_rows = with_twin_edges(ref_b, seed=5)
        got_b, _ = with_twin_edges(got_b, seed=5)
        parts.append(twin_rows)
        assert len(twin_rows) >= 24
    overlaps = np.concatenate(parts)
    ref, got = ref_fno.FNO1(ref_b), fno.FNO1(got_b)
    if no_incl:
        ref.s = dataclasses.replace(ref.s, no_inclusions=True)
        got.s = dataclasses.replace(got.s, no_inclusions=True)
    want_lines = ref.run(nonedge_overlaps=overlaps)
    got_lines = got.run(nonedge_overlaps=overlaps)
    assert got_lines == want_lines
    assert got.found == ref.found
    kept, scalar = expected_counts(ref, overlaps)
    assert (got.nonedge_rows, got.nonedge_scalar) == (kept, scalar)

    # each case reaches what it was built for
    if case == "empty":
        assert len(overlaps) == 0 and kept == 0
    else:
        assert kept > 0
    if workflow == "savage_paired":
        assert 0 < scalar < kept
    else:
        assert scalar == 0
    if synthetic:
        assert kept < len(overlaps)  # the pairs that share an edge dropped
        for kind in ("neither", "first", "second", "both", "forward_edge",
                     "reverse_edge", "edge_superreads"):
            assert kinds.get(kind, 0) > 0, (kind, kinds)
    if no_incl:
        # some pseudo-edge of perc 100 is left out
        relaxed = fno.FNO1(got_b)
        assert set(relaxed.run(nonedge_overlaps=overlaps)) > set(got_lines)


def test_an_unknown_read_id_raises_as_in_the_per_row_loop():
    ref_b, got_b, nonedge = captured("polyte", 0)
    bad = nonedge[:3].copy()
    bad["id2"][1] = max(ref_b.store.ids) + 1
    for cls, b in ((ref_fno.FNO1, ref_b), (fno.FNO1, got_b)):
        with pytest.raises(KeyError):
            cls(b).run(nonedge_overlaps=bad)


def test_nonedge_counts_reach_the_iteration_stats():
    """run_iteration records both counts beside the FNO phase, and the
    non-edge phase sits inside it."""
    from haploconduct_torch.workflows.savage import SavageConfig, run_savage

    res = run_savage(port_store(savage_paired_reads()), SavageConfig(
        split_num=1, stage_b=False, stage_c=False, backend="numpy"))
    history = [h for h in res.stage_a.history if "fno_nonedges" in h]
    assert history
    assert sum(h["fno_nonedges"] for h in history) > 0
    assert 0 < sum(h["fno_nonedge_scalar"] for h in history) < sum(
        h["fno_nonedges"] for h in history)
    for h in history:
        assert 0 <= h["fno_nonedge_scalar"] <= h["fno_nonedges"]
        if h["fno_nonedges"]:
            # phase_times are rounded to 4 places
            assert h["phase_times"]["fno.nonedges"] <= h["phase_times"]["fno"] + 1e-4
