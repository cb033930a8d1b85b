"""Stage-granular checkpoint/resume.

The reference persists every stage's intermediates in the working
directory and skips phases with --no_* flags (savage.py:58-63, 175-192;
polyte.py --no_overlaps/--no_preprocessing). The rebuild checkpoints the
same state (reads + subread provenance + pending overlaps) explicitly, in
the reference's own on-disk formats so checkpoints stay interoperable and
diffable against reference runs.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..core.reads import ReadStore, decode_seq
from ..io.fastq import write_fastq
from ..io.overlaps import read_overlaps, write_overlaps
from ..io.subreads import SubreadDict, read_subreads, write_subreads


def save_state(directory: str, store: ReadStore, subreads: Optional[SubreadDict],
               overlaps: Optional[np.ndarray] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    singles_ids, singles_seqs, singles_quals = [], [], []
    p_ids, p1_seqs, p1_quals, p2_seqs, p2_quals = [], [], [], [], []
    for i in range(len(store)):
        rid = int(store.ids[i])
        if store.is_paired[i]:
            p_ids.append(rid)
            p1_seqs.append(store.seq_str(i, 1))
            p1_quals.append(store.phred_str(i, 1))
            p2_seqs.append(store.seq_str(i, 2))
            p2_quals.append(store.phred_str(i, 2))
        else:
            singles_ids.append(rid)
            singles_seqs.append(store.seq_str(i, 0))
            singles_quals.append(store.phred_str(i, 0))
    write_fastq(os.path.join(directory, "singles.fastq"),
                singles_ids, singles_seqs, singles_quals)
    write_fastq(os.path.join(directory, "paired1.fastq"), p_ids, p1_seqs, p1_quals)
    write_fastq(os.path.join(directory, "paired2.fastq"), p_ids, p2_seqs, p2_quals)
    if subreads is not None:
        write_subreads(os.path.join(directory, "subreads.txt"), subreads)
    if overlaps is not None:
        write_overlaps(os.path.join(directory, "overlaps.txt"), overlaps)


def load_state(directory: str) -> Tuple[ReadStore, Optional[SubreadDict], Optional[np.ndarray]]:
    singles = os.path.join(directory, "singles.fastq")
    p1 = os.path.join(directory, "paired1.fastq")
    p2 = os.path.join(directory, "paired2.fastq")
    store = ReadStore.from_files(
        singles=singles if os.path.getsize(singles) else None,
        paired1=p1 if os.path.exists(p1) and os.path.getsize(p1) else None,
        paired2=p2 if os.path.exists(p2) and os.path.getsize(p2) else None,
    )
    sub_path = os.path.join(directory, "subreads.txt")
    subreads = read_subreads(sub_path) if os.path.exists(sub_path) else None
    ov_path = os.path.join(directory, "overlaps.txt")
    overlaps = read_overlaps(ov_path) if os.path.exists(ov_path) else None
    return store, subreads, overlaps
