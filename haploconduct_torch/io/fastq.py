"""fastq / fasta readers and writers.

Semantics match the reference loader (reference: src/FastqStorage.cpp:92-235):
- fastq records are strictly 4 lines (no wrapping);
- the read ID is the first whitespace-delimited token after '@';
- sequences are uppercased on load; quality strings are kept verbatim;
- paired files must list identical IDs in identical order (checked by caller).
"""

from __future__ import annotations

import io as _io
from typing import Iterator, List, Sequence, Tuple


def read_fastq(path: str) -> Tuple[List[str], List[str], List[str]]:
    """Read a fastq file -> (ids, seqs, phreds). Sequences are uppercased."""
    ids: List[str] = []
    seqs: List[str] = []
    phreds: List[str] = []
    with open(path, "r") as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"{path}: read ID does not start with '@': {header!r}")
            seq = f.readline().rstrip("\n")
            plus = f.readline()
            if not plus.startswith("+"):
                raise ValueError(f"{path}: malformed fastq record (missing '+' line)")
            phred = f.readline().rstrip("\n")
            if len(seq) != len(phred):
                raise ValueError(f"{path}: seq/phred length mismatch for {header!r}")
            ids.append(header[1:].split()[0] if len(header) > 1 else "")
            seqs.append(seq.upper())
            phreds.append(phred)
    return ids, seqs, phreds


def write_fastq(path: str, ids: Sequence, seqs: Sequence[str], phreds: Sequence[str]) -> None:
    with open(path, "w") as f:
        for rid, seq, phred in zip(ids, seqs, phreds):
            f.write(f"@{rid}\n{seq}\n+\n{phred}\n")


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (id, seq) from a fasta file; sequences may wrap over lines."""
    cur_id = None
    chunks: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if cur_id is not None:
                    yield cur_id, "".join(chunks)
                cur_id = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if cur_id is not None:
        yield cur_id, "".join(chunks)


def read_fasta(path: str) -> Tuple[List[str], List[str]]:
    ids: List[str] = []
    seqs: List[str] = []
    for rid, seq in iter_fasta(path):
        ids.append(rid)
        seqs.append(seq.upper())
    return ids, seqs


def write_fasta(path: str, ids: Sequence, seqs: Sequence[str]) -> None:
    with open(path, "w") as f:
        for rid, seq in zip(ids, seqs):
            f.write(f">{rid}\n{seq}\n")


def fastq_to_fasta(fastq_path: str, fasta_path: str) -> None:
    """Equivalent of the reference's scripts/fastq2fasta.py."""
    ids, seqs, _ = read_fastq(fastq_path)
    write_fasta(fasta_path, ids, seqs)
