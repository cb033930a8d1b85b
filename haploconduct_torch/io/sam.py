"""SAM parsing and reference-guided overlap induction.

Port of scripts/sam2overlaps.py: parse read-to-reference alignments
(soft/hard-clip position correction with 'N'/'$' padding), sweep each
reference with an active-read window, and emit 13-col overlaps with
CIGAR-aware position/length correction. Preserves the reference's strict
`corrected_overlap_len <= min_overlap_len` filter and orientation rules.

SAM files can come from any aligner (bwa mem in the reference); the
built-in seed aligner (ops/align.py) produces compatible records when no
external aligner is available.
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .overlaps import parse_overlap_lines

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # clip-corrected, 1-based as in SAM
    mapq: int
    cigar: str
    seq: str  # with 'N' padding for hard clips
    qual: str  # with '$' padding for hard clips

    @property
    def reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def unmapped(self) -> bool:
        return bool(self.flag & 4)


def _parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def parse_sam_line(line: str) -> Optional[SamRecord]:
    parts = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq, cigar = parts[0], int(parts[1]), parts[2], \
        int(parts[3]), int(parts[4]), parts[5]
    seq, qual = parts[9], parts[10]
    if flag & 4:
        return None
    ops = _parse_cigar(cigar)
    if ops and ops[0][1] == "S":
        pos -= ops[0][0]
    elif ops and ops[0][1] == "H":
        pos -= ops[0][0]
        seq = "N" * ops[0][0] + seq
        qual = "$" * ops[0][0] + qual
    if ops and ops[-1][1] == "H":
        seq += "N" * ops[-1][0]
        qual += "$" * ops[-1][0]
    return SamRecord(qname, flag, rname, pos, mapq, cigar, seq, qual)


def read_sam_singles(path: str) -> List[SamRecord]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            rec = parse_sam_line(line)
            if rec is not None:
                out.append(rec)
    return out


def read_sam_paired(path: str) -> List[Tuple[SamRecord, SamRecord, bool]]:
    """Pairs of consecutive records (bwa interleaved output); returns
    (first-by-pos, second, reversed) tuples (sam2overlaps.py:189-266)."""
    out = []
    pending: List[SamRecord] = []
    i = 0
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            parts = line.split("\t", 2)
            if int(parts[1]) & 4:
                continue
            rec = parse_sam_line(line)
            pending.append(rec)
            if i % 2 == 1:
                if len(pending) == 2:
                    a, b = pending
                    if a.qname != b.qname:
                        pending = [b]
                        continue
                    if a.pos >= b.pos:
                        if a.reverse and b.reverse:
                            out.append((b, a, True))
                    else:
                        if not a.reverse and not b.reverse:
                            out.append((a, b, False))
                pending = []
            i += 1
    return out


def compute_overlap_pos(pos1, pos2, len1, len2, cigar1, cigar2):
    """CIGAR-aware overlap position correction (sam2overlaps.py:268-313).
    Read 2 is in front (pos2 <= pos1)."""
    ops1 = _parse_cigar(cigar1)
    ops2 = _parse_cigar(cigar2)
    front_seq_len = 0
    front_ref_len = 0
    p = 0
    total_back_ref_len = sum(n for n, op in ops1 if op != "I")
    max_len = pos1 - pos2 + total_back_ref_len
    for n, op in ops2:
        if p < max_len:
            if op != "D":
                front_seq_len += min(n, max_len - p)
            if op != "I":
                front_ref_len += min(n, max_len - p)
                p += n
    if front_ref_len <= (pos1 - pos2):
        return -1, 0
    back_ref_len = front_ref_len - (pos1 - pos2)
    back_seq_len = 0
    p = 0
    for n, op in ops1:
        if p < back_ref_len:
            if op != "D":
                back_seq_len += min(n, back_ref_len - p)
            if op != "I":
                p += n
    overlap_pos = (pos1 - pos2) - ((front_ref_len - front_seq_len) - (back_ref_len - back_seq_len))
    if overlap_pos >= 0:
        overlap_len = min(len2 - overlap_pos, len1)
    else:
        return -1, 0
    return overlap_pos, overlap_len


def _overlap_fields(read1: SamRecord, read2: SamRecord, pos: int, ovlen: int) -> List[str]:
    perc = int(round(ovlen / min(len(read1.seq), len(read2.seq)) * 100))
    return [read1.qname, read2.qname, str(pos), "0", "-",
            "-" if read1.reverse else "+", "-" if read2.reverse else "+",
            str(perc), "0", str(ovlen), "0", "s", "s"]


def _merge(overlap1: List[str], overlap2: List[str], t1: str, t2: str) -> List[str]:
    overlap = overlap1
    overlap[11], overlap[12] = t1, t2
    if t1 == "p" and t2 == "p":
        overlap[4] = "2" if overlap1[0] != overlap2[0] else "1"
    overlap[3] = overlap2[2]
    overlap[8] = overlap2[7]
    overlap[10] = overlap2[9]
    return overlap


def sam_to_overlaps(
    reference_lengths: Dict[str, int],
    singles: List[SamRecord],
    paired: List[Tuple[SamRecord, SamRecord, bool]],
    min_overlap_len: int,
):
    """Induce overlaps per reference via the active-window sweep
    (sam2overlaps.py:372-563). Returns overlap text lines."""
    lines: List[str] = []
    refs = list(reference_lengths)
    for ref in refs:
        merged: List[Tuple[int, object]] = []
        for rec in sorted((s for s in singles if s.rname == ref), key=lambda r: r.pos):
            merged.append((rec.pos, rec))
        for pair in sorted((p for p in paired if p[0].rname == ref), key=lambda p: p[0].pos):
            merged.append((pair[0].pos, pair))
        merged.sort(key=lambda t: t[0])
        if not merged:
            continue
        active: List[object] = []
        ref_len = reference_lengths[ref]
        for cur_pos, cur in merged:
            if cur_pos >= ref_len:
                break
            new_overlaps, active = _sweep_step(cur, active, min_overlap_len)
            active.append(cur)
            lines.extend("\t".join(o) for o in new_overlaps)
    return lines


def _sweep_step(record, active_reads, min_overlap_len):
    rec_paired = isinstance(record, tuple)
    r1 = record[0] if rec_paired else record
    overlaps = []
    new_active = []
    for read in active_reads:
        rd_paired = isinstance(read, tuple)
        a1 = read[0] if rd_paired else read
        overlap_pos = r1.pos - a1.pos
        if len(a1.seq) - overlap_pos >= min_overlap_len:
            new_active.append(read)
        cpos, clen = compute_overlap_pos(r1.pos, a1.pos, len(r1.seq), len(a1.seq),
                                         r1.cigar, a1.cigar)
        if clen <= min_overlap_len or cpos < 0:
            continue
        if not rec_paired and not rd_paired:
            ov = _overlap_fields(a1, r1, cpos, clen)
            overlaps.append(ov)
        elif rec_paired and not rd_paired:
            ov1 = _overlap_fields(a1, record[0], cpos, clen)
            cpos2, clen2 = compute_overlap_pos(record[1].pos, a1.pos,
                                               len(record[1].seq), len(a1.seq),
                                               record[1].cigar, a1.cigar)
            ov2 = _overlap_fields(a1, record[1], cpos2, clen2)
            ov = _merge(ov1, ov2, "s", "p")
            ov[5] = "-" if a1.reverse else "+"
            ov[6] = "-" if record[2] else "+"
            if clen2 > min_overlap_len and cpos2 >= 0:
                overlaps.append(ov)
        elif not rec_paired and rd_paired:
            ov1 = _overlap_fields(read[0], r1, cpos, clen)
            if read[1].pos - r1.pos < 0:
                continue
            cpos2, clen2 = compute_overlap_pos(read[1].pos, r1.pos,
                                               len(read[1].seq), len(r1.seq),
                                               read[1].cigar, r1.cigar)
            ov2 = _overlap_fields(r1, read[1], cpos2, clen2)
            ov = _merge(ov1, ov2, "s", "p")
            ov[5] = "-" if read[2] else "+"
            ov[6] = "-" if r1.reverse else "+"
            if clen2 > min_overlap_len and cpos2 >= 0:
                overlaps.append(ov)
        else:
            ov1 = _overlap_fields(read[0], record[0], cpos, clen)
            if record[1].pos - read[1].pos < 0:
                cpos2, clen2 = compute_overlap_pos(read[1].pos, record[1].pos,
                                                   len(read[1].seq), len(record[1].seq),
                                                   read[1].cigar, record[1].cigar)
                ov2 = _overlap_fields(record[1], read[1], cpos2, clen2)
            else:
                cpos2, clen2 = compute_overlap_pos(record[1].pos, read[1].pos,
                                                   len(record[1].seq), len(read[1].seq),
                                                   record[1].cigar, read[1].cigar)
                ov2 = _overlap_fields(read[1], record[1], cpos2, clen2)
            ov = _merge(ov1, ov2, "p", "p")
            ov[5] = "-" if read[2] else "+"
            ov[6] = "-" if record[2] else "+"
            if clen2 > min_overlap_len and cpos2 >= 0:
                overlaps.append(ov)
    return overlaps, new_active


def sam_files_to_overlaps(reference_fasta: str, min_overlap_len: int,
                          sam_s: Optional[str] = None, sam_p: Optional[str] = None):
    """File-level entry matching scripts/sam2overlaps.py's CLI."""
    from .fastq import read_fasta

    ids, seqs = read_fasta(reference_fasta)
    ref_lens = {i: len(s) for i, s in zip(ids, seqs)}
    singles = read_sam_singles(sam_s) if sam_s else []
    paired = read_sam_paired(sam_p) if sam_p else []
    lines = sam_to_overlaps(ref_lens, singles, paired, min_overlap_len)
    return parse_overlap_lines(lines)
