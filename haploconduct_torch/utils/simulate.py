"""Synthetic-data generation: genome mutation + read simulation.

Covers the reference's scripts/random_mutations.py (substitution /
insertion / deletion mutagenesis of fasta sequences) and adds an Illumina
read simulator used by the test-suite (the reference had no read
simulator; its example data was pre-generated)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

BASES = "ACGT"


def random_genome(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[b] for b in rng.integers(0, 4, length))


def mutate_sequence(seq: str, rng: np.random.Generator,
                    sub_rate: float = 0.0, ins_rate: float = 0.0,
                    del_rate: float = 0.0) -> str:
    """Random mutagenesis (scripts/random_mutations.py semantics: counts
    are round(len * rate), positions unique-uniform)."""
    out = list(seq)
    n = len(seq)
    n_sub = int(round(n * sub_rate))
    for pos in rng.choice(n, size=min(n_sub, n), replace=False):
        cur = out[pos]
        if cur in BASES:
            alt = BASES[(BASES.index(cur) + int(rng.integers(1, 4))) % 4]
            out[pos] = alt
    n_del = int(round(n * del_rate))
    for pos in sorted(rng.choice(n, size=min(n_del, n), replace=False), reverse=True):
        if out[pos] is not None:
            out[pos] = ""
    n_ins = int(round(n * ins_rate))
    for pos in sorted(rng.choice(n, size=min(n_ins, n), replace=False), reverse=True):
        out[pos] = out[pos] + BASES[int(rng.integers(0, 4))]
    return "".join(out)


def simulate_reads(
    genomes: List[str],
    coverage: float,
    read_len: int,
    rng: np.random.Generator,
    error_rate: float = 0.002,
    qual_char: str = "I",
):
    """Uniform single-end reads over a set of haplotypes; returns
    (seqs, phreds) with per-base substitution errors at error_rate."""
    seqs: List[str] = []
    quals: List[str] = []
    for genome in genomes:
        n_reads = int(coverage * len(genome) / read_len)
        starts = rng.integers(0, max(len(genome) - read_len, 1), n_reads)
        for s in starts:
            read = list(genome[s:s + read_len])
            errs = rng.random(len(read)) < error_rate
            for i in np.flatnonzero(errs):
                read[i] = BASES[(BASES.index(read[i]) + int(rng.integers(1, 4))) % 4]
            seqs.append("".join(read))
            quals.append(qual_char * len(read))
    order = rng.permutation(len(seqs))
    return [seqs[i] for i in order], [quals[i] for i in order]


def simulate_paired_reads(
    genomes: List[str],
    coverage: float,
    read_len: int,
    insert_size: int,
    insert_std: int,
    rng: np.random.Generator,
    error_rate: float = 0.002,
    qual_char: str = "I",
):
    """Forward-forward paired reads (PEAR-style, as SAVAGE expects)."""
    p1s, p2s, quals = [], [], []
    for genome in genomes:
        n_pairs = int(coverage * len(genome) / (2 * read_len))
        for _ in range(n_pairs):
            frag = max(2 * read_len, int(rng.normal(insert_size, insert_std)))
            start = int(rng.integers(0, max(len(genome) - frag, 1)))
            r1 = genome[start:start + read_len]
            r2 = genome[start + frag - read_len:start + frag]
            if len(r1) < read_len or len(r2) < read_len:
                continue
            def err(read):
                read = list(read)
                for i in np.flatnonzero(rng.random(len(read)) < error_rate):
                    read[i] = BASES[(BASES.index(read[i]) + int(rng.integers(1, 4))) % 4]
                return "".join(read)
            p1s.append(err(r1))
            p2s.append(err(r2))
            quals.append(qual_char * read_len)
    return p1s, p2s, quals
