"""The port's SAVAGE and polyte-split CLI as two gloo ranks under torchrun
(each rank's output in its own directory, every rank's contigs those of
one process), and torch_envelope.py --profile's cProfile of patch 0's
stage a and the two abundance filters."""

import numpy as np

import chip_smoke
import torch_envelope
from haploconduct_torch.core.reads import ReadStore
from haploconduct_torch.utils.simulate import (mutate_sequence, random_genome,
                                               simulate_reads)
from haploconduct_torch.workflows import savage
from haploconduct_torch.workflows.polyte_split import run_polyte_split
from haploconduct_torch.workflows.savage import SavageConfig, run_savage

from torch_helpers import torch_on_cpu  # noqa: F401  (autouse)


def _small_store():
    """300 reads of 120 bp from two strains of a 1.2 kb genome at 15x each."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 1200)
    haps = [genome, mutate_sequence(genome, rng, sub_rate=0.03)]
    seqs, quals = simulate_reads(haps, coverage=15, read_len=120, rng=rng)
    store = ReadStore()
    for i, (sq, q) in enumerate(zip(seqs, quals)):
        store.add_single(i, sq, q)
    store.readcount_single = len(seqs)
    return store


def test_two_rank_cli_gives_every_rank_the_single_process_contigs(tmp_path):
    store = _small_store()
    single = chip_smoke.contig_sets(run_savage(store, SavageConfig(
        split_num=2, backend="torch", min_clique_size=4)))
    assert set(single) == set("abc") and single["c"][1]
    ranks, wall = chip_smoke.two_rank_cli(store, str(tmp_path), 2, device="cpu",
                                          timeout=300)
    assert wall > 0
    assert ranks == [single, single]
    out = tmp_path / "two_ranks"
    # rank 0 writes -o, rank 1 <-o>/rank1: each its own checkpoints
    assert (out / "checkpoints").is_dir() and (out / "rank1" / "checkpoints").is_dir()
    assert not (out / "rank0").exists()


def test_two_rank_polyte_split_cli_gives_every_rank_the_single_process_contigs(tmp_path):
    """chip_smoke.py phase 8's two-card part, on the CPU over gloo: the
    envelope's configuration through the CLI as two ranks, on a 12 kb
    genome (two regions, one a rank)."""
    store, haps = torch_envelope.polyte_envelope_store(genome_len=12_000)
    ref = str(tmp_path / "ref.fasta")
    chip_smoke.write_fasta(ref, "chr", haps[0])
    res = run_polyte_split(store, torch_envelope.polyte_split_config(ref, backend="torch"))
    single = chip_smoke.store_seqs(res.final.store)
    assert len(res.regions) == 2 and single
    ranks, wall = chip_smoke.two_rank_polyte_split(store, ref, str(tmp_path),
                                                   device="cpu", timeout=300)
    assert wall > 0 and ranks == [single, single]
    assert not (tmp_path / "two_rank_split" / "rank0").exists()


def test_profile_covers_patch0_stage_a_and_both_filters(capsys):
    store, _ = torch_envelope.savage_envelope_store(genome_len=600, total_cov=1334,
                                                    split_num=2)
    originals = (savage.split_into_patches, savage.denovo_candidates,
                 savage.run_stage, savage._freq_filter)
    profs = torch_envelope.profile_envelope(store, 2, "native")
    assert set(profs) == {"patch0_stage_a", "stage_b_filter", "stage_c_filter"}
    assert (savage.split_into_patches, savage.denovo_candidates,
            savage.run_stage, savage._freq_filter) == originals
    text = capsys.readouterr().out
    assert "patch 0 of 2" in text
    for name in profs:
        assert f"[profile] {name}: top 30 by cumulative time" in text
    assert "find_overlap_candidates" in text and "classify_all" in text
