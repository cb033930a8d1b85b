"""A ReadStore from plain arrays, so state made elsewhere (another
package's store, a file, a test) enters the port as the port's own
objects."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .reads import ReadStore


def store_from_arrays(unit_codes: Sequence[np.ndarray],
                      unit_quals: Sequence[np.ndarray], ids: Sequence[int],
                      unit1: Sequence[int], unit2: Sequence[int],
                      readcount_single: int) -> ReadStore:
    """Reads in storage order: read i has id ids[i] and units unit1[i] and
    unit2[i] (-1 for a single-end read) of the unit code (int8) and qual
    (uint8) arrays; the first `readcount_single` reads are single-end."""
    if not len(ids) == len(unit1) == len(unit2):
        raise ValueError("ids, unit1 and unit2 must have one entry per read")
    store = ReadStore()
    for rid, u1, u2 in zip(ids, unit1, unit2):
        if u2 < 0:
            store.add_single_codes(int(rid), unit_codes[u1], unit_quals[u1])
        else:
            store.add_paired_codes(int(rid), unit_codes[u1], unit_quals[u1],
                                   unit_codes[u2], unit_quals[u2])
    store.readcount_single = int(readcount_single)
    return store
