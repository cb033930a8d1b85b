"""POLYTE, reference-guided SAVAGE, abundance-mode frequencies, the CLI
commands and the process-group start of haploconduct_torch against the JAX
package: contigs and output files must be byte-identical to the reference
driven with its f64 numpy oracle and its host k-mer engine."""

import os

import numpy as np
import pytest

from haploconduct_tpu.cli import main as ref_main
from haploconduct_tpu.utils.simulate import (
    mutate_sequence, random_genome, simulate_paired_reads, simulate_reads)
from haploconduct_tpu.workflows.polyte import PolyteConfig as RefPolyteConfig
from haploconduct_tpu.workflows.polyte import run_polyte as ref_run_polyte
from haploconduct_tpu.workflows.savage import SavageConfig as RefSavageConfig
from haploconduct_tpu.workflows.savage import run_savage as ref_run_savage
from haploconduct_torch.cli import main
from haploconduct_torch.ops import kmer_device
from haploconduct_torch.ops.verify import BACKEND_COUNTS
from haploconduct_torch.workflows.polyte import PolyteConfig, run_polyte
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

from torch_helpers import make_store, port_store
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


POLYTE_KW = dict(hap_cov=20, insert_size=150, stddev=15, min_overlap_len=60,
                 min_overlap_len_EC=77)


def diploid_reads():
    """The input of tests/test_workflows.py:test_polyte_diploid_synthetic:
    two haplotypes of a 3 kb genome at 1%, 150 bp error-free reads, 20x."""
    rng = np.random.default_rng(42)
    hap1 = random_genome(rng, 3000)
    hap2 = mutate_sequence(hap1, rng, sub_rate=0.01)
    return simulate_reads([hap1, hap2], coverage=20, read_len=150, rng=rng,
                          error_rate=0.0)


def contigs(store):
    return None if store is None else [store.seq_str(i) for i in range(len(store))]


@pytest.fixture(scope="module")
def polyte_reference():
    store = make_store(*diploid_reads())
    return store, {dip: ref_run_polyte(store, RefPolyteConfig(
        backend="numpy", candidates="host", diploid=dip, **POLYTE_KW))
        for dip in (False, True)}


@pytest.mark.parametrize("diploid", [False, True])
@pytest.mark.parametrize("candidates", ["host", "device"])
def test_run_polyte_matches_reference(polyte_reference, diploid, candidates):
    store, refs = polyte_reference
    ref = refs[diploid]
    calls = kmer_device.JOIN_CALLS.get("cpu", 0)
    tasks = BACKEND_COUNTS["torch"]
    got = run_polyte(port_store(store), PolyteConfig(
        backend="torch", candidates=candidates, diploid=diploid, **POLYTE_KW))
    assert BACKEND_COUNTS["torch"] > tasks
    joined = kmer_device.JOIN_CALLS.get("cpu", 0) - calls
    assert (joined > 0) == (candidates == "device")
    assert len(ref.store) > 0 and contigs(got.store) == contigs(ref.store)
    assert contigs(got.diploid_store) == contigs(ref.diploid_store)
    assert (ref.diploid_store is not None) == diploid
    assert got.iterations == ref.iterations
    assert len(got.history) == len(ref.history)


def savage_ref_inputs(tmp_path, paired: bool):
    rng = np.random.default_rng(7)
    hap = random_genome(rng, 1500)
    haps = [hap, mutate_sequence(hap, rng, sub_rate=0.02)]
    ref_path = tmp_path / "ref.fasta"
    ref_path.write_text(f">chr\n{hap}\n")
    if not paired:
        return make_store(*simulate_reads(haps, coverage=40, read_len=120, rng=rng,
                                          error_rate=0.0)), str(ref_path)
    from haploconduct_tpu.core.reads import ReadStore

    p1, p2, quals = simulate_paired_reads(haps, coverage=40, read_len=120,
                                          insert_size=300, insert_std=20, rng=rng,
                                          error_rate=0.0)
    store = ReadStore()
    for i, (a, b, q) in enumerate(zip(p1, p2, quals)):
        store.add_paired(i, a, q, b, q)
    store.readcount_single = 0
    return store, str(ref_path)


@pytest.mark.parametrize("paired", [False, True])
def test_reference_guided_savage_matches_reference(tmp_path, paired):
    """run_savage with `reference=` (stage a candidates from the seed
    aligner) against the reference. The induced overlaps pass
    io/overlaps.py:validate_overlaps, so no task position is negative and
    the torch scorer accepts every task."""
    store, ref_path = savage_ref_inputs(tmp_path, paired)
    ref = ref_run_savage(store, RefSavageConfig(split_num=1, backend="numpy",
                                                reference=ref_path))
    got = run_savage(port_store(store), SavageConfig(split_num=1, backend="torch",
                                                     reference=ref_path))
    assert len(ref.contigs("a")[0]) > 0
    for stage in "abc":
        assert got.contigs(stage) == ref.contigs(stage), stage


def test_freq_est_abundance_matches_reference():
    """Mirror of tests/test_abundance.py:test_freq_est_abundance_mode: the
    twin (torch EM) against the reference's f64 host EM."""
    from haploconduct_tpu.workflows.freq_est import \
        estimate_frequencies_abundance as ref_estimate
    from haploconduct_torch.workflows.freq_est import estimate_frequencies_abundance

    rng = np.random.default_rng(4)
    a, b, ghost = (random_genome(rng, n) for n in (600, 500, 300))
    reads = make_store(*simulate_reads([a, a, a, b], coverage=10, read_len=80,
                                       rng=rng, error_rate=0.0))
    contig_store = make_store([a, b, ghost], ["I" * len(s) for s in (a, b, ghost)])
    want = ref_estimate(contig_store, reads, fragment_len=80.0, min_len=400,
                        backend="numpy")
    got = estimate_frequencies_abundance(port_store(contig_store), port_store(reads),
                                         fragment_len=80.0, min_len=400,
                                         backend="torch")
    assert got.contig_ids == want.contig_ids == [0, 1]
    assert got.lengths == want.lengths
    assert got.total_subread_count == want.total_subread_count > 0
    np.testing.assert_allclose(got.frequencies, want.frequencies, rtol=1e-4)
    assert got.frequencies[0] / got.frequencies[1] == pytest.approx(3.0, rel=0.15)


def write_fastq(path, seqs, quals):
    path.write_text("".join(f"@r{i}\n{s}\n+\n{q}\n"
                            for i, (s, q) in enumerate(zip(seqs, quals))))


def assert_same_outputs(ref_dir, got_dir):
    names = sorted(os.listdir(ref_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name


def test_cli_polyte_matches_reference_cli(tmp_path):
    fq = tmp_path / "reads.fastq"
    write_fastq(fq, *diploid_reads())
    args = ["polyte", "-s", str(fq), "--hap_cov", "20", "--insert_size", "150",
            "--stddev", "15", "-m", "60", "-m_EC", "77", "--diploid"]
    assert ref_main(args + ["-o", str(tmp_path / "ref"), "--backend", "numpy",
                            "--candidates", "host"]) == 0
    # candidates auto: the torch join on a card, the host engine here
    assert main(args + ["-o", str(tmp_path / "torch"), "--backend", "torch"]) == 0
    assert "contigs_diploid.fasta" in os.listdir(tmp_path / "ref")
    assert_same_outputs(tmp_path / "ref", tmp_path / "torch")


def test_cli_polyte_split_matches_reference_cli(tmp_path):
    rng = np.random.default_rng(12)
    genome = random_genome(rng, 6000)
    hap2 = mutate_sequence(genome, rng, sub_rate=0.005)
    fq = tmp_path / "reads.fastq"
    write_fastq(fq, *simulate_reads([genome, hap2], coverage=12, read_len=150,
                                    rng=rng, error_rate=0.0))
    ref = tmp_path / "ref.fasta"
    ref.write_text(f">chr\n{genome}\n")
    args = ["polyte-split", "-s", str(fq), "--ref", str(ref), "--hap_cov", "12",
            "--insert_size", "150", "--stddev", "15", "-m", "60",
            "--split_size", "3000", "--split_overlap", "300"]
    assert ref_main(args + ["-o", str(tmp_path / "out_ref"), "--backend", "numpy"]) == 0
    assert main(args + ["-o", str(tmp_path / "out_torch"), "--backend", "torch"]) == 0
    assert_same_outputs(tmp_path / "out_ref", tmp_path / "out_torch")


def test_cli_count_strains_matches_reference_cli(tmp_path, capsys):
    """The strains of tests/test_workflows.py:test_strain_count_synthetic as
    a contig fasta, aligned with the reference's seed aligner."""
    ref = random_genome(np.random.default_rng(0), 2000)
    rng = np.random.default_rng(1)
    strains = [ref, mutate_sequence(ref, rng, 0.02), mutate_sequence(ref, rng, 0.02)]
    fa = tmp_path / "contigs.fasta"
    fa.write_text("".join(f">{i}\n{s[100:900]}\n" for i, s in enumerate(strains)))
    rf = tmp_path / "ref.fasta"
    rf.write_text(f">ref\n{ref}\n")
    args = ["count-strains", "--contigs", str(fa), "--ref", str(rf)]
    assert ref_main(args) == 0
    want = capsys.readouterr().out
    assert main(args) == 0
    got = capsys.readouterr().out
    assert got == want and "is 3." in got


@pytest.mark.parametrize("local_rank, rank, want_card", [("1", "3", 1), (None, "3", 1),
                                                         (None, "4", 0)])
def test_maybe_initialize_sets_the_rank_card_before_nccl(monkeypatch, local_rank,
                                                         rank, want_card):
    """With CUDA present each rank takes its own card (LOCAL_RANK, else RANK
    modulo the card count) before the NCCL group starts, with the group's
    timeout set above a SAVAGE stage's time (distributed.COLLECTIVE_TIMEOUT)."""
    import torch
    import torch.distributed as dist

    from haploconduct_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method, timeout: calls.append(
                            ("init", backend, timeout)))
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", rank)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert distributed.maybe_initialize()
    assert calls == [("set_device", want_card),
                     ("init", "nccl", distributed.COLLECTIVE_TIMEOUT)]
