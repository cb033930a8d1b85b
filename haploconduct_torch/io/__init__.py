"""On-disk format layer: fastq/fasta, 13-col overlaps, SFO, subreads, GFA.

These formats are kept bit-compatible with the reference (HaploConduct v0.2)
so intermediates can be diffed against reference runs; internally the
pipeline passes in-memory arrays, and files are only written at workflow
boundaries or on request.
"""

from .fastq import read_fastq, write_fastq, read_fasta, write_fasta, fastq_to_fasta
from .overlaps import (
    OVERLAP_DTYPE,
    empty_overlaps,
    make_overlaps,
    read_overlaps,
    write_overlaps,
    overlap_lines,
    overlap_perc,
    validate_overlaps,
)
from .sfo import read_sfo, sfo_to_overlaps
from .subreads import read_subreads, write_subreads
from .gfa import write_gfa
