"""Contig relative-frequency estimation (rebuild of savage/freq_est.py).

Quick mode: frequencies from subread counts, weighting each original read
by 1/#contigs it appears in, with effective-length correction
(savage/freq_est.py:134-191). Kallisto mode is delegated to the external
kallisto binary when present (savage/freq_est.py:230-247); the quick mode
needs nothing external.

Note: the reference's quick mode unpacks subread entries as ``ID:poslist``
(2 fields) and crashes on the 4-field format its own SRBuilder writes; the
rebuild parses the real format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..io.subreads import SubreadDict


@dataclass
class FreqResult:
    contig_ids: List[int]
    lengths: List[int]
    frequencies: List[float]
    total_subread_count: int
    total_length: int

    def table(self) -> str:
        n = len(self.contig_ids)
        avg = self.total_length / n if n else 0
        lines = [
            f"#contigs: {n}",
            f"total length: {self.total_length}",
            f"average length: {avg:.0f}",
            f"total subread count: {self.total_subread_count}",
            "id\tlength\tfrequency",
        ]
        for cid, length, freq in zip(self.contig_ids, self.lengths, self.frequencies):
            lines.append(f"{cid}\t{length}\t{freq:.3f}")
        return "\n".join(lines) + "\n"


def estimate_frequencies_abundance(
    contig_store,
    read_store,
    fragment_len: float,
    min_len: int = 0,
    backend: str = "auto",
) -> FreqResult:
    """Kallisto-mode estimation (savage/freq_est.py:195-247) through the
    built-in pseudo-alignment + EM estimator (ops/abundance.py) instead of
    the external kallisto binary: contigs >= min_len form the panel, every
    sequence unit of `read_store` is pseudo-aligned, and frequencies are
    the per-contig TPMs renormalized over the panel."""
    from ..ops.abundance import estimate_abundance, store_unit_seqs

    ids, seqs = [], []
    for i in range(len(contig_store)):
        if contig_store.read_len(i) >= min_len:
            ids.append(int(contig_store.ids[i]))
            seqs.append(contig_store.unit_codes(contig_store.unit1[i]))
    res = estimate_abundance(
        [str(i) for i in ids], seqs, store_unit_seqs(read_store),
        fragment_len=fragment_len, backend=backend)
    total = float(res.tpm.sum())
    freqs = [float(t) / total if total > 0 else 0.0 for t in res.tpm]
    return FreqResult(
        contig_ids=ids, lengths=[len(s) for s in seqs], frequencies=freqs,
        total_subread_count=res.n_pseudoaligned,
        total_length=sum(len(s) for s in seqs),
    )


def estimate_frequencies(
    contig_lengths: Dict[int, int],
    subreads: SubreadDict,
    min_len: int = 0,
    len_correction: float = 0.0,
    select_ids: Optional[Sequence[int]] = None,
) -> FreqResult:
    """Quick-mode estimation from subread provenance."""
    selected = {
        cid: ln for cid, ln in contig_lengths.items()
        if ln >= min_len and (select_ids is None or cid in set(select_ids))
    }
    originals_to_contigs: Dict[int, List[int]] = {}
    contigs_to_originals: Dict[int, List[int]] = {}
    for cid, originals in subreads.items():
        if cid not in selected:
            continue
        subs = list(originals.keys())
        contigs_to_originals[cid] = subs
        for oid in subs:
            originals_to_contigs.setdefault(oid, []).append(cid)
    total_subreads = len(originals_to_contigs)

    ids, lengths, freqs = [], [], []
    for cid, subs in contigs_to_originals.items():
        length = selected[cid]
        weighted = sum(1.0 / len(originals_to_contigs[s]) for s in subs)
        eff_len = length - len_correction + 1
        # reference filters with strict > min_len at this stage
        if length > min_len and total_subreads > 0 and eff_len > 0:
            ids.append(cid)
            lengths.append(length)
            freqs.append((weighted / total_subreads) * (1.0 / eff_len))
    total = sum(freqs)
    freqs = [f / total if total > 0 else 0.0 for f in freqs]
    return FreqResult(
        contig_ids=ids, lengths=lengths, frequencies=freqs,
        total_subread_count=total_subreads,
        total_length=sum(selected.values()),
    )
