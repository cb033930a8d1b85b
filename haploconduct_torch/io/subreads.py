"""subreads.txt — the provenance map from contigs to ORIGINAL input reads.

Per line: ``contigID \\t origID:±:idx1[,idx2]:len1[,len2] \\t ...`` where idx
is the (possibly negative, after error correction) offset of the original
read inside the contig, ± its orientation within the contig, and len the
original sequence length(s). Written by the reference at
src/SRBuilder.cpp:1449-1463 and parsed at src/OverlapGraph.cpp:799-845.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class OriginalIndex:
    """Placement of one original read inside a contig (src/Types.h:84-91)."""

    index1: int
    index2: int = 0
    is_paired: bool = False
    forward: bool = True
    len1: int = 0
    len2: int = 0


SubreadDict = Dict[int, Dict[int, OriginalIndex]]


def read_subreads(path: str) -> SubreadDict:
    with open(path) as f:
        return subreads_from_text(f.read())


def subreads_from_text(text: str) -> SubreadDict:
    out: SubreadDict = {}
    if True:  # keep the original loop body's indentation
        for line in text.split("\n"):
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            contig_id = int(parts[0])
            originals: Dict[int, OriginalIndex] = {}
            for info in parts[1:]:
                if not info:
                    continue
                bits = [b for b in info.replace(",", ":").split(":") if b != ""]
                assert len(bits) in (4, 6), f"bad subreads entry: {info!r}"
                orig_id = int(bits[0])
                fwd = bits[1] == "+"
                if len(bits) == 6:
                    originals[orig_id] = OriginalIndex(
                        index1=int(bits[2]), index2=int(bits[3]),
                        is_paired=True, forward=fwd,
                        len1=int(bits[4]), len2=int(bits[5]))
                else:
                    originals[orig_id] = OriginalIndex(
                        index1=int(bits[2]), is_paired=False, forward=fwd,
                        len1=int(bits[3]))
            out[contig_id] = originals
    return out


def subreads_to_text(subreads: SubreadDict) -> str:
    lines = []
    for contig_id, originals in subreads.items():
        fields = [str(contig_id)]
        for orig_id, oi in originals.items():
            ori = "+" if oi.forward else "-"
            if oi.is_paired:
                fields.append(f"{orig_id}:{ori}:{oi.index1},{oi.index2}:{oi.len1},{oi.len2}")
            else:
                fields.append(f"{orig_id}:{ori}:{oi.index1}:{oi.len1}")
        lines.append("\t".join(fields) + "\n")
    return "".join(lines)


def write_subreads(path: str, subreads: SubreadDict, append: bool = False) -> None:
    with open(path, "a" if append else "w") as f:
        f.write(subreads_to_text(subreads))


def trivial_subreads(read_ids, paired_flags, len1s, len2s) -> SubreadDict:
    """First-iteration provenance: every read is its own contig at offset 0
    (reference: src/OverlapGraph.cpp:768-793 trivial-originals branch)."""
    out: SubreadDict = {}
    for rid, paired, l1, l2 in zip(read_ids, paired_flags, len1s, len2s):
        out[int(rid)] = {
            int(rid): OriginalIndex(
                index1=0, index2=0, is_paired=bool(paired), forward=True,
                len1=int(l1), len2=int(l2) if paired else 0)
        }
    return out
