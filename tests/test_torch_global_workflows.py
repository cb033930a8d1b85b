"""The workflows over the mesh that spans ranks: SAVAGE with split_num=2,
polyte-split and POLYTE as two gloo ranks on the CPU
(tests/test_torch_global_mesh.py:run_ranks). Where the ranks make
different calls (SAVAGE's stage-a patches, polyte-split's regions) each
scores on its own device with no collective, where the JAX package's
global mesh would block; where they make the same calls (stages b and
c, the final reference-guided pass, POLYTE on every rank) the torch
backend goes through the mesh. Every rank's contigs equal one process's."""

import json

import numpy as np

import torch_envelope
from haploconduct_tpu.utils.simulate import (mutate_sequence, random_genome,
                                              simulate_reads)
from haploconduct_tpu.workflows.polyte import PolyteConfig as RefPolyteConfig
from haploconduct_tpu.workflows.polyte import run_polyte as ref_run_polyte
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.utils import simulate as port_sim
from haploconduct_torch.workflows.polyte_split import run_polyte_split
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

import chip_smoke
from test_torch_global_mesh import rank_json, run_ranks
from test_torch_polyte import POLYTE_KW, contigs
from torch_helpers import make_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

# in a worker: `module.name` wrapped so that each call records its kind,
# and the collectives, "mesh" tasks and "torch" tasks it added
RECORDER = """
    calls = []

    def record(module, name, kind):
        real = getattr(module, name)

        def wrapped(*a, **k):
            c0 = len(collectives)
            m0, t0 = V.BACKEND_COUNTS["mesh"], V.BACKEND_COUNTS["torch"]
            out = real(*a, **k)
            calls.append([kind(*a, **k), len(collectives) - c0,
                          V.BACKEND_COUNTS["mesh"] - m0, V.BACKEND_COUNTS["torch"] - t0])
            return out

        setattr(module, name, wrapped)
"""

SAVAGE_BODY = RECORDER + """
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                                   simulate_reads)
    from haploconduct_torch.workflows import savage

    with open(os.path.join(workdir, "savage.json")) as f:
        kw = json.load(f)
    rng = np.random.default_rng(5)
    genome = random_genome(rng, kw["genome_len"])
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    seqs, quals = simulate_reads(haps, coverage=kw["coverage"], read_len=120, rng=rng)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    record(savage, "run_stage", lambda params, *a, **k: params.stage)
    res = savage.run_savage(store, savage.SavageConfig(split_num=kw["split_num"],
                                                       backend="torch", min_clique_size=4))
    save_json({"contigs": {s: res.contigs(s) for s in "abc"}, "calls": calls,
               "collectives": collectives})
"""


def savage_over_ranks(tmp_path, ranks: int, **kw):
    """SAVAGE_BODY on `ranks` gloo ranks, its store drawn from `kw`
    (genome_len, coverage) and cut into kw["split_num"] patches, one a
    rank: each rank's stage a scores on its own device with no collective
    inside, the patches are gathered, stages b and c go through the mesh
    that spans the ranks (tasks under "mesh", none under "torch"), and
    every rank's stage a/b/c contigs equal one process's run_savage with
    the same split_num."""
    store = savage_store(kw["genome_len"], kw["coverage"])
    single = {s: list(map(list, c)) for s, c in chip_smoke.contig_sets(run_savage(
        store, SavageConfig(split_num=kw["split_num"], backend="torch",
                            min_clique_size=4))).items()}
    assert set(single) == set("abc") and single["c"][1]
    (tmp_path / "savage.json").write_text(json.dumps(kw))
    run_ranks(tmp_path, SAVAGE_BODY, ranks)
    for rank in range(ranks):
        got = rank_json(tmp_path, rank)
        assert got["contigs"] == single
        stage_a, *bc = got["calls"]
        assert [c[0] for c in bc] == ["b", "c"], got["calls"]
        assert stage_a[0] == "a" and stage_a[1:3] == [0, 0] and stage_a[3] > 0
        for _, n_collectives, mesh_tasks, torch_tasks in bc:
            assert n_collectives > 0 and mesh_tasks > 0 and torch_tasks == 0
        # stage a's gather of the patches, outside run_stage
        assert "all_gather_object" in got["collectives"]


def test_two_rank_savage_split_2_patches_rank_local_stages_b_c_on_the_mesh(tmp_path):
    """SAVAGE with split_num=2 and the torch backend as two gloo ranks: each
    rank's stage a (its one patch) scores on its own device with no
    collective inside, the patches are gathered, and stages b and c go
    through the mesh that spans the ranks (tasks under "mesh", none under
    "torch"). Both ranks' stage a/b/c contigs equal one process's run."""
    savage_over_ranks(tmp_path, 2, genome_len=1200, coverage=15, split_num=2)


def test_four_rank_savage_split_4_whole_sample_is_one_process(tmp_path):
    """The savage-sample-4rank deployment at a CPU's size: a 600 bp sample
    of two strains cut into 4 patches over four gloo ranks, one a rank,
    stages a -> b -> c with the abundance filter. Every rank's final
    contigs (and its stage a and b contigs) are byte-equal to one
    process's run_savage with split_num=4, and to each other."""
    savage_over_ranks(tmp_path, 4, genome_len=600, coverage=60, split_num=4)


def savage_store(genome_len: int, coverage: float):
    """SAVAGE_BODY's draw in this process: two strains at 3% of a
    `genome_len` genome, 120 bp reads at `coverage` a strain."""
    rng = np.random.default_rng(5)
    genome = port_sim.random_genome(rng, genome_len)
    haps = [genome, port_sim.mutate_sequence(genome, rng, sub_rate=0.03)]
    seqs, quals = port_sim.simulate_reads(haps, coverage=coverage, read_len=120, rng=rng)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return store


SPLIT_BODY = RECORDER + """
    import torch_envelope
    from haploconduct_torch.workflows import polyte_split

    store, _ = torch_envelope.polyte_envelope_store(genome_len=12_000)
    ref = os.path.join(workdir, "ref.fasta")
    record(polyte_split, "run_polyte",
           lambda *a, **k: "final" if "initial_overlaps" in k else "region")
    res = polyte_split.run_polyte_split(store, torch_envelope.polyte_split_config(
        ref, backend="torch"))
    final = res.final.store
    save_json({"contigs": [final.seq_str(i) for i in range(len(final))],
               "calls": calls, "regions": len(res.regions)})
"""


def test_two_rank_polyte_split_regions_rank_local_final_pass_on_the_mesh(tmp_path):
    """polyte-split at the envelope's settings on a 12 kb genome (two
    regions) as two gloo ranks: each rank's region scores on its own
    device with no collective inside, and the final reference-guided
    pass goes through the mesh that spans the ranks. Both ranks' final
    contigs equal one process's run."""
    store, haps = torch_envelope.polyte_envelope_store(genome_len=12_000)
    ref = str(tmp_path / "ref.fasta")
    chip_smoke.write_fasta(ref, "chr", haps[0])
    res = run_polyte_split(store, torch_envelope.polyte_split_config(ref, backend="torch"))
    single = chip_smoke.store_seqs(res.final.store)
    assert len(res.regions) == 2 and single
    run_ranks(tmp_path, SPLIT_BODY)
    for rank in range(2):
        got = rank_json(tmp_path, rank)
        assert got["contigs"] == single and got["regions"] == 2
        assert [c[0] for c in got["calls"]] == ["region", "final"], got["calls"]
        region, final = got["calls"]
        assert region[1:3] == [0, 0] and region[3] > 0
        assert final[1] > 0 and final[2] > 0 and final[3] == 0


POLYTE_BODY = RECORDER + """
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                                   simulate_reads)
    from haploconduct_torch.workflows import polyte

    with open(os.path.join(workdir, "polyte_kw.json")) as f:
        kw = json.load(f)
    rng = np.random.default_rng(42)
    hap1 = random_genome(rng, 4000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    seqs, quals = simulate_reads([hap1, hap2], coverage=20, read_len=150, rng=rng,
                                 error_rate=0.0)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    record(polyte, "run_polyte", lambda *a, **k: "polyte")
    res = polyte.run_polyte(store, polyte.PolyteConfig(
        backend="torch", candidates="host", diploid=True, **kw))
    save_json({"contigs": [res.store.seq_str(i) for i in range(len(res.store))],
               "diploid": [res.diploid_store.seq_str(i)
                           for i in range(len(res.diploid_store))],
               "iterations": res.iterations, "calls": calls})
"""


def test_two_rank_polyte_4kb_on_the_mesh_is_the_references(tmp_path):
    """POLYTE diploid on a 4 kb genome (two haplotypes at 1%, 20x each of
    error-free 150 bp reads), run on both gloo ranks with the torch
    backend: every verify call goes through the mesh that spans them, and
    both ranks' contigs, diploid contigs and iterations equal the JAX
    package's run_polyte (its f64 oracle, the host candidate engine)."""
    (tmp_path / "polyte_kw.json").write_text(json.dumps(POLYTE_KW))
    run_ranks(tmp_path, POLYTE_BODY)
    rng = np.random.default_rng(42)
    hap1 = random_genome(rng, 4000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    ref = ref_run_polyte(make_store(*simulate_reads(
        [hap1, hap2], coverage=20, read_len=150, rng=rng, error_rate=0.0)),
        RefPolyteConfig(backend="numpy", candidates="host", diploid=True, **POLYTE_KW))
    want = contigs(ref.store)
    assert want and ref.diploid_store is not None
    for rank in range(2):
        got = rank_json(tmp_path, rank)
        assert got["contigs"] == want
        assert got["diploid"] == contigs(ref.diploid_store)
        assert got["iterations"] == ref.iterations
        [[_, n_collectives, mesh_tasks, torch_tasks]] = got["calls"]
        assert n_collectives > 0 and mesh_tasks > 0 and torch_tasks == 0


# phase 15's inputs cut to a CPU's size in each rank and in the test: 4,000
# tasks of the iteration-1 stream's draw, a 600 bp patch at 100x for the
# join step, and test_torch_cli_ranks._small_store's reads for SAVAGE
PHASE15_PRELUDE = """
import numpy as np
import chip_smoke, torch_bench
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                               simulate_reads)
_draw, _patch = torch_bench.envelope_workload, chip_smoke.envelope_patch
torch_bench.envelope_workload = lambda n_tasks=None, seed=0: _draw(4000, seed)
chip_smoke.envelope_patch = lambda: _patch(genome_len=600, coverage=100)

def _small_store():
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 1200)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    seqs, quals = simulate_reads(haps, coverage=15, read_len=120, rng=rng)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return store, haps

chip_smoke.phase11_store = _small_store
"""


def test_chip_smoke_phase15_on_two_cpu_ranks(tmp_path, monkeypatch, capsys):
    """chip_smoke.py phase 15 as two gloo ranks on the CPU at a small size
    (PHASE15_PRELUDE): every stream call, the join step and SAVAGE's
    stages on each rank hold to one process's results, stage a
    rank-local and stages b and c through the mesh; no launch without a
    card."""
    import torch
    import torch_bench
    from haploconduct_torch.parallel import mesh

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for module, name in ((torch_bench, "envelope_workload"),
                         (chip_smoke, "envelope_patch"), (chip_smoke, "phase11_store")):
        monkeypatch.setattr(module, name, getattr(module, name))  # restored after
    exec(PHASE15_PRELUDE, {})
    one = mesh.sharded_assembly_step([torch.device("cpu")], *chip_smoke.envelope_join_inputs(
        chip_smoke.envelope_patch()), **chip_smoke.JOIN_KW)
    assert one[1] > 0
    store, _ = chip_smoke.phase11_store()
    savage_want = chip_smoke.contig_sets(run_savage(store, SavageConfig(
        split_num=2, backend="torch", min_clique_size=4)))
    assert set(savage_want) == set("abc")
    launches = chip_smoke.phase_global_mesh(
        torch, (chip_smoke.sha256_of(one[0]), one[1]), savage_want, device="cpu",
        prelude=PHASE15_PRELUDE)
    assert launches == {"score_tasks": 0, "join_verify": 0}
    text = capsys.readouterr().out
    assert "[global_mesh] two gloo ranks on ['cpu', 'cpu']" in text
    for rank in range(2):
        assert f"[global_mesh_b] rank {rank} (cpu)" in text
        assert text.count(f"[global_mesh_a] rank {rank} (cpu)") == 2
