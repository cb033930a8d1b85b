"""polyte-split through haploconduct_torch against the JAX package: regions,
the reference-guided final pass and the final contigs must equal the
reference's; a thread pool over regions, two gloo ranks and a process
without jax must give the same result."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from haploconduct_tpu.core.reads import ReadStore
from haploconduct_tpu.utils.simulate import (
    mutate_sequence, random_genome, simulate_reads)
from haploconduct_tpu.workflows.polyte_split import \
    PolyteSplitConfig as RefPolyteSplitConfig
from haploconduct_tpu.workflows.polyte_split import \
    run_polyte_split as ref_run_polyte_split
from haploconduct_torch.ops.verify import BACKEND_COUNTS
from haploconduct_torch.workflows import polyte_split
from haploconduct_torch.workflows.polyte_split import (PolyteSplitConfig,
                                                       run_polyte_split)

from torch_helpers import port_store
from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes on shared cores: torch's
    many small CPU ops here run on one thread, so idle intra-op threads do
    not spin against the other workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_inputs(ref_path):
    """The input of tests/test_workflows.py:test_polyte_split_synthetic: a
    12 kb genome and one haplotype at 0.5%, 150 bp reads, 12x each; the
    genome is written to `ref_path` as the reference."""
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 12000)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    seqs, quals = simulate_reads([genome, hap2], coverage=12, read_len=150,
                                 rng=rng, error_rate=0.0)
    store = ReadStore()
    for i, (s, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, s, q)
    store.readcount_single = len(store.ids)
    with open(ref_path, "w") as f:
        f.write(f">chr\n{genome}\n")
    return store


def split_kw(ref_path, backend):
    return dict(hap_cov=12, insert_size=150, stddev=15, reference=ref_path,
                split_size=5000, split_overlap=500, backend=backend,
                min_overlap_len=60, min_overlap_len_EC=77, min_region_reads=50)


def final_contigs(res):
    st = res.final.store
    return [f"{int(st.ids[i])} {st.seq_str(i)}" for i in range(len(st))]


@pytest.fixture(scope="module")
def split_case(tmp_path_factory):
    ref_path = str(tmp_path_factory.mktemp("split") / "ref.fasta")
    store = split_inputs(ref_path)
    ref = ref_run_polyte_split(store, RefPolyteSplitConfig(**split_kw(ref_path, "numpy")))
    tasks = BACKEND_COUNTS["torch"]
    store = port_store(store)
    got = run_polyte_split(store, PolyteSplitConfig(**split_kw(ref_path, "torch")))
    assert BACKEND_COUNTS["torch"] > tasks
    return store, ref_path, ref, got


def test_run_polyte_split_matches_reference(split_case):
    _, _, ref, got = split_case
    assert len(ref.regions) >= 2
    assert got.regions == ref.regions
    assert got.final_ref_candidates == ref.final_ref_candidates > 0
    assert got.failed_regions == []
    assert len(got.region_results) == len(ref.region_results)
    assert [st.seq_str(i) for st in [got.combined_store] for i in range(len(st))] == \
        [st.seq_str(i) for st in [ref.combined_store] for i in range(len(st))]
    assert final_contigs(got) == final_contigs(ref)
    assert got.final.iterations == ref.final.iterations


def test_region_pool_matches_one_thread(split_case):
    """pool_size=2 assembles the regions on two threads; the counters are
    shared and locked, and the result equals pool_size=1's."""
    store, ref_path, _, single = split_case
    tasks = BACKEND_COUNTS["torch"]
    pooled = run_polyte_split(store, PolyteSplitConfig(pool_size=2,
                                                       **split_kw(ref_path, "torch")))
    assert BACKEND_COUNTS["torch"] > tasks
    assert pooled.regions == single.regions and pooled.failed_regions == []
    assert final_contigs(pooled) == final_contigs(single)


def test_region_failures_are_counted_and_device_errors_raised(split_case, monkeypatch):
    store, ref_path, _, _ = split_case
    real = polyte_split.run_polyte

    def failing(exc):
        def run(rstore, cfg, preprocessing=True, original_store=None,
                initial_overlaps=None):
            if original_store is not None:  # a region, not the final pass
                raise exc
            return real(rstore, cfg, preprocessing, original_store, initial_overlaps)
        return run

    cfg = PolyteSplitConfig(**split_kw(ref_path, "torch"))
    monkeypatch.setattr(polyte_split, "run_polyte", failing(KeyError("edge")))
    res = run_polyte_split(store, cfg)
    assert [r for r, _ in res.failed_regions] == res.regions
    assert all("KeyError" in err for _, err in res.failed_regions)
    assert res.final is None and len(res.combined_store) == 0
    monkeypatch.setattr(polyte_split, "run_polyte",
                        failing(RuntimeError("score_tasks kernel launch failed")))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        run_polyte_split(store, cfg)


def test_region_threads_take_the_callers_card(monkeypatch):
    """The CUDA current device is per thread: region threads must score on
    the rank's card, not on card 0."""
    import threading

    import torch

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.append((threading.get_ident(), d)))
    init = polyte_split.same_card_initializer()
    t = threading.Thread(target=init)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [(t.ident, 1)]


JAX_FREE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.path.insert(0, %(tests)r)
    from test_torch_polyte_split import final_contigs, split_inputs, split_kw
    from torch_helpers import port_store
    from haploconduct_torch.workflows.polyte_split import (PolyteSplitConfig,
                                                           run_polyte_split)
    ref_path = sys.argv[1]
    res = run_polyte_split(port_store(split_inputs(ref_path)),
                           PolyteSplitConfig(**split_kw(ref_path, "torch")))
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    print("\\n".join(final_contigs(res)))
""")


def test_polyte_split_runs_with_jax_unimportable(split_case, tmp_path):
    """The root conftest imports jax, so only a fresh process can show the
    port's polyte-split never needs it."""
    _, _, _, got = split_case
    script = tmp_path / "jax_free.py"
    script.write_text(JAX_FREE % {"tests": os.path.join(REPO, "tests")})
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "ref.fasta")],
        env=dict(os.environ, PYTHONPATH=REPO, HC_TORCH_DEVICE="cpu",
                 OMP_NUM_THREADS="1"), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == final_contigs(got)


GLOO_WORKER = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None
    sys.path.insert(0, %(tests)r)
    from test_torch_polyte_split import final_contigs, split_inputs, split_kw
    from torch_helpers import port_store
    from haploconduct_torch.parallel import distributed
    from haploconduct_torch.workflows.polyte_split import (PolyteSplitConfig,
                                                           run_polyte_split)
    ref_path = sys.argv[2]
    res = run_polyte_split(port_store(split_inputs(ref_path)),
                           PolyteSplitConfig(**split_kw(ref_path, "torch")))
    assert distributed.process_count() == 2
    assert res.failed_regions == []
    with open(sys.argv[1], "w") as f:
        f.write("\\n".join([repr(res.regions)] + final_contigs(res)))
""")


def test_two_process_gloo_polyte_split_matches_single(split_case, tmp_path):
    """Mirror of tests/test_torch_savage.py:test_two_process_gloo_savage_matches_single
    for polyte-split: two gloo ranks split the regions, allgather them
    (allgather_indexed with allow_missing) and both end with the
    single-process result."""
    _, _, _, single = split_case
    worker = tmp_path / "worker.py"
    worker.write_text(GLOO_WORKER % {"tests": os.path.join(REPO, "tests")})
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    outs = [tmp_path / f"out{r}.txt" for r in range(2)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   CUDA_VISIBLE_DEVICES="", HC_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(outs[rank]),
             str(tmp_path / f"ref{rank}.fasta")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        finally:
            p.kill()
        errs.append(err.decode()[-2000:])
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    want = "\n".join([repr(single.regions)] + final_contigs(single))
    assert outs[0].read_text() == want
    assert outs[1].read_text() == want


def test_chip_smoke_inputs_are_the_simulators_draws():
    """chip_smoke.py builds the polyte-split envelope (and the POLYTE and
    reference-guided inputs) with the port's copy of the simulator, without
    importing the JAX package: phase 8's genome and store
    (torch_envelope.polyte_envelope_store) must be the reference
    simulator's draws, the envelope tool's store."""
    import torch_envelope

    rng = np.random.default_rng(1)
    genome = random_genome(rng, 6000)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    seqs, quals = simulate_reads([genome, hap2], coverage=15, read_len=250,
                                 rng=rng, error_rate=0.0)
    store, (g, h2) = torch_envelope.polyte_envelope_store(genome_len=6000)
    assert (g, h2) == (genome, hap2)
    want = ReadStore()
    for i, (s, q) in enumerate(zip(seqs, quals)):
        want.add_single(i, s, q)
    assert len(store) == len(want) == 720
    for i in range(len(want)):
        assert store.seq_str(i) == want.seq_str(i)
        assert store.phred_str(i) == want.phred_str(i)
