"""Assembly evaluation: contiguity and accuracy metrics.

Replaces the reference's external-tool evaluation layer
(scripts/customized_metaquast.py needs QUAST, scripts/
polymorphic_positions.py needs nucmer + bwa) with built-in equivalents
computed via the internal seed aligner: N50/NGA-style contiguity, genome
fraction, per-base mismatch rate against the true haplotypes, and SNP
recovery at polymorphic positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore, encode_seq


@dataclass
class AssemblyMetrics:
    n_contigs: int
    total_length: int
    largest: int
    n50: int
    genome_fraction: float  # fraction of haplotype positions covered
    mismatch_rate: float  # mismatches per aligned base
    unaligned_contigs: int
    # QUAST-comparable headline metrics (quast.sf.net definitions):
    nga50: int = 0  # N50 over ALIGNED blocks, vs the reference length
    duplication_ratio: float = 0.0  # aligned bases / covered ref positions
    misassemblies: int = 0  # relocation/inversion/translocation events

    def summary(self) -> str:
        return (f"contigs: {self.n_contigs}  total: {self.total_length}bp  "
                f"largest: {self.largest}  N50: {self.n50}  "
                f"NGA50: {self.nga50}  "
                f"genome fraction: {100 * self.genome_fraction:.1f}%  "
                f"mismatch rate: {100 * self.mismatch_rate:.3f}%  "
                f"duplication: {self.duplication_ratio:.3f}  "
                f"misassemblies: {self.misassemblies}  "
                f"unaligned: {self.unaligned_contigs}")


def n50(lengths: List[int], reference_total: Optional[int] = None) -> int:
    """N50 (half of sum(lengths)); with reference_total, the NG-style
    variant where the 50% threshold is half the REFERENCE length."""
    if not lengths:
        return 0
    total = reference_total if reference_total is not None else sum(lengths)
    acc = 0
    for ln in sorted(lengths, reverse=True):
        acc += ln
        if 2 * acc >= total:
            return ln
    return 0


# QUAST's "extensive misassembly" distance threshold: consecutive aligned
# fragments of one contig whose reference coordinates disagree with their
# contig coordinates by more than this are a relocation event
_MIS_THRESHOLD = 1000
_MIS_CHUNK = 1000  # contig fragment size for split alignment
_MIS_MIN_CHUNK = 200  # ignore trailing fragments shorter than this


def _misassembly_events(codes: np.ndarray, index, hap_codes) -> int:
    """Count relocation / inversion / translocation events within one
    contig, QUAST-style: split the contig into fragments, align each
    independently, and compare consecutive aligned fragments."""
    from ..ops.align import _best_diagonal, _gapless_mismatches
    from ..core.reads import revcomp_codes

    if len(codes) < 2 * _MIS_MIN_CHUNK:
        return 0
    placements = []  # (contig_offset, rid, diag, rev)
    for off in range(0, len(codes), _MIS_CHUNK):
        chunk = codes[off:off + _MIS_CHUNK]
        if len(chunk) < _MIS_MIN_CHUNK:
            break
        best = None
        for rev in (False, True):
            c = revcomp_codes(chunk) if rev else chunk
            for rid, diag, _ in _best_diagonal(index, c):
                mism, span = _gapless_mismatches(hap_codes[rid], c, diag)
                if span == 0:
                    continue
                cand = (mism / span, -span, rid, diag, rev)
                if best is None or cand < best:
                    best = cand
        if best is not None:
            _, _, rid, diag, rev = best
            placements.append((off, rid, diag, rev))
    events = 0
    for (o1, r1, d1, v1), (o2, r2, d2, v2) in zip(placements, placements[1:]):
        if r1 != r2:
            events += 1  # translocation
        elif v1 != v2:
            events += 1  # inversion
        elif abs(d2 - d1) > _MIS_THRESHOLD:
            events += 1  # relocation (diagonals encode ref_pos - contig_pos)
    return events


def evaluate_assembly(contigs: List[str], haplotypes: List[str],
                      min_contig_len: int = 0) -> AssemblyMetrics:
    """Align each contig to its best haplotype (gapless seed alignment)
    and accumulate coverage/mismatch statistics."""
    from ..ops.align import ReferenceIndex, _best_diagonal, _gapless_mismatches
    from ..core.reads import revcomp_codes

    contigs = [c for c in contigs if len(c) >= min_contig_len]
    hap_codes = [encode_seq(h) for h in haplotypes]
    index = ReferenceIndex([str(i) for i in range(len(haplotypes))], hap_codes)
    covered = [np.zeros(len(h), dtype=bool) for h in haplotypes]
    mismatches = 0
    aligned_bases = 0
    unaligned = 0
    aligned_blocks: List[int] = []
    misassemblies = 0
    for contig in contigs:
        codes = encode_seq(contig)
        best = None
        for rev in (False, True):
            c = revcomp_codes(codes) if rev else codes
            for rid, diag, _ in _best_diagonal(index, c):
                mism, span = _gapless_mismatches(hap_codes[rid], c, diag)
                if span == 0:
                    continue
                cand = (mism / span, -span, rid, diag, rev)
                if best is None or cand < best:
                    best = cand
        if best is None:
            unaligned += 1
            continue
        rate, negspan, rid, diag, rev = best
        span = -negspan
        mismatches += int(round(rate * span))
        aligned_bases += span
        aligned_blocks.append(span)
        misassemblies += _misassembly_events(codes, index, hap_codes)
        a = max(0, diag)
        b = min(len(hap_codes[rid]), diag + len(codes))
        covered[rid][a:b] = True
    lengths = [len(c) for c in contigs]
    genome_total = sum(len(h) for h in haplotypes)
    covered_total = sum(int(c.sum()) for c in covered)
    return AssemblyMetrics(
        n_contigs=len(contigs),
        total_length=sum(lengths),
        largest=max(lengths, default=0),
        n50=n50(lengths),
        genome_fraction=covered_total / genome_total if genome_total else 0.0,
        mismatch_rate=mismatches / aligned_bases if aligned_bases else 0.0,
        unaligned_contigs=unaligned,
        nga50=n50(aligned_blocks, reference_total=genome_total),
        duplication_ratio=(aligned_bases / covered_total
                           if covered_total else 0.0),
        misassemblies=misassemblies,
    )


def polymorphic_position_accuracy(
    contigs: List[str], haplotypes: List[str],
) -> Tuple[int, int]:
    """SNP recovery (scripts/polymorphic_positions.py intent): of the
    positions where haplotypes disagree, how many are covered by a contig
    carrying the correct allele? Returns (correctly_recovered, total_snps).
    Haplotypes must be equal length (substitution-only divergence)."""
    from ..ops.align import ReferenceIndex, _best_diagonal, _gapless_mismatches
    from ..core.reads import revcomp_codes

    if len(set(len(h) for h in haplotypes)) != 1:
        raise ValueError("haplotypes must be equal length for SNP accounting")
    hap_codes = [encode_seq(h) for h in haplotypes]
    arr = np.stack(hap_codes)
    snp_positions = np.flatnonzero((arr != arr[0]).any(axis=0))
    recovered = set()
    index = ReferenceIndex([str(i) for i in range(len(haplotypes))], hap_codes)
    for contig in contigs:
        codes = encode_seq(contig)
        best = None
        for rev in (False, True):
            c = revcomp_codes(codes) if rev else codes
            for rid, diag, _ in _best_diagonal(index, c):
                mism, span = _gapless_mismatches(hap_codes[rid], c, diag)
                if span == 0:
                    continue
                cand = (mism / span, -span, rid, diag, rev)
                if best is None or cand < best:
                    best = cand
        if best is None:
            continue
        _, _, rid, diag, rev = best
        c = revcomp_codes(codes) if rev else codes
        for p in snp_positions:
            j = p - diag
            if 0 <= j < len(c) and c[j] == hap_codes[rid][p]:
                recovered.add((rid, int(p)))
    total = len(snp_positions) * len(haplotypes)
    return len(recovered), total
