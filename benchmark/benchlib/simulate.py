"""The traffic's reads, drawn from the seed as a sequencer gives them.

A unit is a master genome and strains at a share of substitutions from it
(the layout of the repo's read simulator, haploconduct_torch/utils/
simulate.py). Each read is drawn from a uniform start on one haplotype,
from either strand with equal odds; its phreds follow the configuration's
quality model (a mean that falls along the read, with noise around it),
and each base is misread with the probability its phred states. Paired
reads come from fragments whose lengths follow the configuration's insert
size: mate 1 is the fragment's start and mate 2 the reverse complement of
its end, as paired fastq files hold them. Arrays in, arrays out; numpy
only, so a change to the program cannot change the traffic.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Tuple

import numpy as np

_COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.int8)


class Unit(NamedTuple):
    """One unit of traffic: the haplotypes as base codes 0-3; the reads as
    (codes, phreds) in the order a store numbers them (single-end reads,
    or mate 1 of every pair and then mate 2 of every pair, the order in
    which POLYTE concatenates paired files); and the number of pairs."""
    haps: List[np.ndarray]
    reads: List[Tuple[np.ndarray, np.ndarray]]
    pairs: int


def unit_rng(seed: int, stream: str, index: int) -> np.random.Generator:
    """The generator of one unit of traffic: its own stream of the run's
    seed, keyed by the whole stream name, so that unit k of a seed is the
    same whatever else is drawn."""
    digest = hashlib.sha256(stream.encode()).digest()
    words = [int.from_bytes(digest[i:i + 8], "little") for i in range(0, 32, 8)]
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *words, int(index)])


def draw_strains(rng: np.random.Generator, genome_len: int, n_strains: int,
                 divergence: float) -> List[np.ndarray]:
    """A uniform random master genome and n_strains - 1 strains, each at
    round(genome_len * divergence) distinct substituted positions."""
    master = rng.integers(0, 4, genome_len).astype(np.int8)
    haps = [master]
    n_sub = min(int(round(genome_len * divergence)), genome_len)
    for _ in range(n_strains - 1):
        h = master.copy()
        at = rng.choice(genome_len, size=n_sub, replace=False)
        h[at] = (h[at] + rng.integers(1, 4, n_sub)) % 4
        haps.append(h)
    return haps


def draw_phreds(rng: np.random.Generator, n: int, read_len: int, quality: dict) -> np.ndarray:
    """(n, read_len) phreds: the mean falls linearly from quality["start"]
    at the first base to quality["end"] at the last, each base adds normal
    noise of quality["sd"], rounded and clipped to [min, max]."""
    mean = np.linspace(quality["start"], quality["end"], read_len)
    q = np.rint(mean[None, :] + rng.normal(0.0, quality["sd"], (n, read_len)))
    return np.clip(q, quality["min"], quality["max"]).astype(np.uint8)


def misread(rng: np.random.Generator, codes: np.ndarray, phreds: np.ndarray) -> np.ndarray:
    """Each base replaced by one of the other three with the error
    probability its phred states."""
    err = rng.random(codes.shape) < np.power(10.0, -phreds.astype(np.float64) / 10.0)
    out = codes.copy()
    out[err] = (out[err] + rng.integers(1, 4, int(err.sum()))) % 4
    return out


def _fragments(rng, hap_len: int, n: int, shapes: dict):
    """Starts and lengths of n fragments on a haplotype: the read length
    for single-end reads, the insert size for pairs."""
    read_len = int(shapes["read_len"])
    if shapes.get("pairing", "single") == "paired":
        lens = np.rint(rng.normal(shapes["insert_size"], shapes["insert_sd"], n))
        lens = np.clip(lens, read_len, hap_len).astype(np.int64)
    else:
        lens = np.full(n, read_len, dtype=np.int64)
    starts = (rng.random(n) * (hap_len - lens + 1)).astype(np.int64)
    return starts, lens


def draw_unit(seed: int, stream: str, index: int, shapes: dict) -> Unit:
    """One unit of traffic from a configuration's shapes. Every unit has
    its own genome, so no two units share reads."""
    rng = unit_rng(seed, stream, index)
    haps = draw_strains(rng, shapes["genome_len"], shapes["n_strains"],
                        shapes["divergence"])
    read_len = int(shapes["read_len"])
    paired = shapes.get("pairing", "single") == "paired"
    per_hap = int(shapes["coverage"] / shapes["n_strains"] * shapes["genome_len"] / read_len)
    n_frag = per_hap // 2 if paired else per_hap
    mates: List[List[np.ndarray]] = [[], []] if paired else [[]]
    for hap in haps:
        g = len(hap)
        strands = (hap, _COMPLEMENT[hap[::-1]])
        starts, lens = _fragments(rng, g, n_frag, shapes)
        reverse = rng.random(n_frag) < 0.5 if shapes.get("strands") == "both" \
            else np.zeros(n_frag, bool)
        for s, n, rev in zip(starts, lens, reverse):
            # the fragment as read from its strand: on the reverse strand
            # it starts where the forward fragment ends
            frag = strands[int(rev)][(g - s - n if rev else s):][:n]
            mates[0].append(frag[:read_len])
            if paired:
                mates[1].append(_COMPLEMENT[frag[-read_len:][::-1]])
    n = len(mates[0])
    order = rng.permutation(n)
    reads = []
    for mate in mates:
        codes = np.stack([mate[i] for i in order])
        phreds = draw_phreds(rng, n, read_len, shapes["quality"])
        codes = misread(rng, codes, phreds)
        reads += list(zip(codes, phreds))
    return Unit(haps, reads, n if paired else 0)
