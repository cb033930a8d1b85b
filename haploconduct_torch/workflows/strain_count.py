"""Strain-count lower bound from contig-to-reference alignments.

Rebuild of estimate_strain_count.py: build a *conflict graph* — contigs
are vertices, an edge connects two contigs whose reference alignments
overlap and DISAGREE at any position — and return the size of its maximum
clique (each member of a conflict clique must come from a different
strain). Uses the native degeneracy Bron-Kerbosch engine instead of the
qc subprocess (estimate_strain_count.py:113-127).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore, encode_seq
from ..graph.cliques import enumerate_cliques
from ..io.sam import SamRecord, _parse_cigar


def _softclip_trim(rec: SamRecord) -> Tuple[str, int]:
    """Remove soft-clipped ends (estimate_strain_count.py:166-186); the
    record pos here is the RAW SAM pos (no clip correction)."""
    ops = _parse_cigar(rec.cigar)
    seq = rec.seq
    clip1 = ops[0][0] if ops and ops[0][1] == "S" else 0
    clip2 = -ops[-1][0] if ops and ops[-1][1] == "S" else len(seq)
    return seq[clip1:clip2 or len(seq)], rec.pos


def _check_overlap(seq1: str, seq2: str, pos: int, allow_n: bool) -> int:
    mismatches = 0
    overlap_len = min(len(seq1) - pos, len(seq2))
    for i in range(overlap_len):
        b1, b2 = seq1[pos + i], seq2[i]
        if allow_n and "N" in (b1, b2):
            continue
        if b1 != b2:
            mismatches += 1
    return mismatches


def conflict_edges(records: List[Tuple[int, int, str]], min_overlap_len: int = 0,
                   allow_n: bool = True) -> List[Tuple[int, int]]:
    """records: (contig_id, ref_pos, trimmed_seq), one reference's worth.
    Returns conflict-graph edges (pairs of disagreeing overlapping contigs)."""
    records = sorted(records, key=lambda r: r[1])
    active: List[Tuple[int, int, str]] = []
    edges: List[Tuple[int, int]] = []
    seen = set()
    for cid, pos, seq in records:
        new_active = []
        for aid, apos, aseq in active:
            overlap_pos = pos - apos
            overlap_len = min(len(aseq) - overlap_pos, len(seq))
            if len(aseq) - overlap_pos >= min_overlap_len:
                new_active.append((aid, apos, aseq))
            if overlap_len > min_overlap_len:
                if _check_overlap(aseq, seq, overlap_pos, allow_n) > 0:
                    if aid != cid:
                        key = (min(aid, cid), max(aid, cid))
                        if key not in seen:
                            seen.add(key)
                            edges.append(key)
        active = new_active
        active.append((cid, pos, seq))
    return edges


def estimate_strain_count(
    sam_records: List[SamRecord],
    allow_n: bool = True,
) -> int:
    """Max conflict-clique size over all references."""
    per_ref: Dict[str, List[Tuple[int, int, str]]] = {}
    max_id = 0
    for rec in sam_records:
        if rec.unmapped or (rec.flag & 256):
            continue
        seq, pos = _softclip_trim(rec)
        cid = int(rec.qname)
        max_id = max(max_id, cid)
        per_ref.setdefault(rec.rname, []).append((cid, pos, seq))
    edges: List[Tuple[int, int]] = []
    for recs in per_ref.values():
        edges.extend(conflict_edges(recs))
    if not edges:
        return 1 if max_id >= 0 and per_ref else 0
    v1 = np.array([e[0] for e in edges])
    v2 = np.array([e[1] for e in edges])
    cliques = enumerate_cliques(max_id + 1, v1, v2)
    return max(len(c) for c in cliques)


def strain_count_from_contigs(contig_store: ReadStore, reference_fasta: str) -> int:
    """Align contigs with the built-in aligner and count strains."""
    from ..ops.align import ReferenceIndex, align_store

    index = ReferenceIndex.from_fasta(reference_fasta)
    singles, _ = align_store(contig_store, index)
    # built-in aligner emits raw (unclipped) M-only records: pos is already
    # the raw SAM position, seqs carry no clipping
    return estimate_strain_count(singles)
