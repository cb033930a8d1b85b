"""haploconduct_torch stands alone: no module of it, and not chip_smoke.py,
torch_envelope.py, torch_bench.py or torch_cands.py, imports the JAX package or jax; a
process that refuses both imports every module of the port and runs it; importing it tunes the allocator; the host
modules it copied are the reference's, byte for byte, but for the
definitions it rewrote; and state crosses
from the reference's objects to the port's only as plain arrays."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from haploconduct_tpu.core.reads import ReadStore as RefReadStore
from haploconduct_tpu.workflows.polyte import PolyteConfig as RefPolyteConfig
from haploconduct_tpu.workflows.polyte import run_polyte as ref_run_polyte
from haploconduct_torch.core.arrays import store_from_arrays
from haploconduct_torch.core.reads import ReadStore

from torch_helpers import dryrun_store, make_store, port_store, store_arrays
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "haploconduct_torch"
REFUSED = ("jax", "jaxlib", "haploconduct_tpu")

# the host modules the port copied from the reference, unchanged
COPIED = [
    "core/__init__.py", "core/reads.py",
    "io/__init__.py", "io/fastq.py", "io/gfa.py", "io/overlaps.py", "io/sam.py",
    "io/sfo.py", "io/subreads.py",
    "graph/__init__.py", "graph/algos.py", "graph/cliques.py",
    "graph/overlap_graph.py",
    "native/__init__.py", "native/baseline_score.cpp", "native/bfslabel.cpp",
    "native/cliques.cpp", "native/consensus.cpp", "native/kmerjoin.cpp",
    "native/refsem.cpp", "native/transitive.cpp",
    "assemble/fno.py", "assemble/superreads.py", "assemble/branch_reduction.py",
    "ops/kmer.py", "ops/align.py", "ops/banded.py",
    "utils/config.py", "utils/cpporder.py", "utils/hostmem.py",
    "utils/checkpoint.py",
    "workflows/freq_est.py", "workflows/min_ev_table.py",
    "workflows/strain_count.py",
    "utils/simulate.py", "workflows/evaluate.py", "workflows/phasing_bench.py",
    "io/converters.py",
]

# copied modules in which the port rewrote some top-level definitions: every
# other top-level statement is still the reference's, in the same order
REWRITTEN = {
    # labelling applies its flips, moves and deletions as whole arrays
    "graph/algos.py": {"_LabelCtx", "_switch_edge_orientation",
                       "_switch_edge_orientations", "_rebuild_adj",
                       "vertex_labelling_heuristic"},
    # FNO1 reconsiders its non-edge overlaps as one batch
    "assemble/fno.py": {"FNO1"},
}

REFUSE = textwrap.dedent("""
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in %(refused)r:
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, %(repo)r)
""")


def _imports(path: Path):
    """Top-level package names a Python file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_the_reference_or_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "torch_envelope.py",
                                          REPO / "torch_bench.py",
                                          REPO / "torch_cands.py"]
    assert len(files) > 40
    bad = {str(f.relative_to(REPO)): sorted(set(_imports(f)) & set(REFUSED))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def _run_refused(body: str, *args, timeout=600):
    script = REFUSE % {"refused": REFUSED, "repo": str(REPO)} + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "HC_NO_MALLOC_TUNE"}
    env.update(CUDA_VISIBLE_DEVICES="", HC_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", script, *args], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


DRIVE = """
    import importlib, pkgutil
    import numpy as np
    import haploconduct_torch
    mods = [m.name for m in pkgutil.walk_packages(haploconduct_torch.__path__,
                                                  "haploconduct_torch.")]
    for name in mods:
        importlib.import_module(name)

    import chip_smoke
    import torch_envelope
    from haploconduct_torch.assemble.stages import StageParams, run_stage
    from haploconduct_torch.core.reads import ReadStore
    from haploconduct_torch.io.sfo import sfo_to_overlaps
    from haploconduct_torch.ops.kmer import find_overlap_candidates
    from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte

    # stage a on the dry-run store (tests/torch_helpers.py:dryrun_store)
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 2000))
    store = ReadStore()
    for i in range(160):
        start = int(rng.integers(0, len(genome) - 150 + 1))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(20, 41, 150))
        store.add_single(i, genome[start:start + 150], qual)
    store.readcount_single = 160
    seqs = [store.unit_codes(u) for u in range(store.n_units)]
    ov = sfo_to_overlaps(find_overlap_candidates(seqs, min_overlap_len=80, k=16),
                         len(store), 0)
    res = run_stage(StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                                original_readcount=len(store), backend="torch"),
                    store, ov)
    print("stage_a", *[res.store.seq_str(i) for i in range(len(res.store))])

    # POLYTE on the 3 kb, 20x input (tests/test_torch_polyte.py:diploid_reads)
    from haploconduct_torch.utils.simulate import mutate_sequence, random_genome
    rng = np.random.default_rng(42)
    hap1 = random_genome(rng, 3000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    reads = chip_smoke.sim_store([hap1, hap2], 20, 150, rng)
    pol = run_polyte(reads, PolyteConfig(
        backend="torch", candidates="host", hap_cov=20, insert_size=150,
        stddev=15, min_overlap_len=60, min_overlap_len_EC=77))
    print("polyte", *[pol.store.seq_str(i) for i in range(len(pol.store))])
    # torch_bench.py's --mesh mode, small, on the CPU
    import contextlib, io, json
    import torch_bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch_bench.main(["--mesh", "--device", "cpu", "--counts", "1,2", "--tasks",
                          "500", "--envelope-tasks", "0", "--mesh-repeats", "1"])
    print("bench", json.loads(buf.getvalue())["n_tasks"])
    print("modules", len(mods))
    assert not [m for m in sys.modules if m.split(".")[0] in %(refused)r]
"""


def test_port_runs_with_the_reference_and_jax_refused():
    """Every module imports, stage a runs on the dry-run store, POLYTE on
    the 3 kb input and torch_bench.py's --mesh mode on a small workload,
    in a process that refuses jax and the JAX package; stage a and POLYTE
    give the reference's contigs."""
    proc = _run_refused(DRIVE % {"refused": REFUSED})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {line.split(" ")[0]: line.split(" ")[1:] for line in proc.stdout.splitlines()}
    assert int(out["modules"][0]) > 40
    assert out["bench"] == ["500"]

    from haploconduct_tpu.assemble.stages import StageParams, run_stage
    from torch_helpers import dryrun_overlaps

    store = dryrun_store()
    ref = run_stage(StageParams(stage="a", min_overlap_len=80, edge_threshold=0.97,
                                original_readcount=len(store), backend="numpy"),
                    store, dryrun_overlaps(store))
    assert out["stage_a"] == [ref.store.seq_str(i) for i in range(len(ref.store))]
    assert out["stage_a"]

    from test_torch_polyte import POLYTE_KW, diploid_reads

    pol = ref_run_polyte(make_store(*diploid_reads()), RefPolyteConfig(
        backend="numpy", candidates="host", **POLYTE_KW))
    assert out["polyte"] == [pol.store.seq_str(i) for i in range(len(pol.store))]
    assert out["polyte"]


def test_cli_help_with_the_reference_and_jax_refused():
    proc = _run_refused("""
        import runpy
        sys.argv = ["haploconduct_torch", "savage", "--help"]
        try:
            runpy.run_module("haploconduct_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "usage: haploconduct-torch savage" in proc.stdout
    assert "--backend" in proc.stdout


def test_import_tunes_the_allocator():
    """The port's own copy of utils/hostmem.py tunes glibc malloc when the
    package is imported, as the reference's import does."""
    proc = _run_refused("""
        import haploconduct_torch
        from haploconduct_torch.utils import hostmem
        print(hostmem._done)
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "True"


def _top_level(path: Path, rewritten: set):
    """Source of each top-level statement of a module, but the definitions
    named in `rewritten`."""
    src = path.read_text()
    return [ast.get_source_segment(src, node) for node in ast.parse(src).body
            if getattr(node, "name", None) not in rewritten]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_host_module_is_the_reference(rel):
    port, ref = PORT / rel, REPO / "haploconduct_tpu" / rel
    if rel in REWRITTEN:
        assert _top_level(port, REWRITTEN[rel]) == _top_level(ref, REWRITTEN[rel])
    else:
        assert port.read_bytes() == ref.read_bytes()


def test_store_from_arrays_carries_a_reference_store():
    """Singles and pairs cross as arrays; the port's store then holds the
    same reads, units, ids and packed matrices."""
    ref = dryrun_store()
    ref.add_paired(500, "ACGTACGTAC", "IIIIIIIIII", "GGGTTTAAAC", "!!!!!IIIII")
    ref.add_paired(7, "NACGT", "IIIII", "TTTT", "IIII")
    got = port_store(ref)
    assert isinstance(got, ReadStore) and not isinstance(got, RefReadStore)
    want, have = store_arrays(ref), store_arrays(got)
    for key in ("ids", "unit1", "unit2", "readcount_single"):
        assert have[key] == want[key], key
    for a, b in zip(have["unit_codes"] + have["unit_quals"],
                    want["unit_codes"] + want["unit_quals"]):
        np.testing.assert_array_equal(a, b)
    assert list(got.is_paired) == list(ref.is_paired)
    assert got.id_to_index == ref.id_to_index
    assert [got.seq_str(i, 2) for i in (160, 161)] == ["GGGTTTAAAC", "TTTT"]
    pg, pr = got.pack(), ref.pack()
    np.testing.assert_array_equal(pg.codes, pr.codes)
    np.testing.assert_array_equal(pg.quals, pr.quals)
    with pytest.raises(ValueError):
        store_from_arrays([], [], [0], [0, 1], [-1], 1)
