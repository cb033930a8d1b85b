"""libstdc++ container-order reproduction for bit-identical parity.

The reference binary's output depends on std::unordered_map iteration order
in a handful of places (SRBuilder.cpp:751-867 originals construction,
subreads.txt writing SRBuilder.cpp:1449-1463, FindNextOverlaps3.cpp:29-134
pair selection). Iteration order is a pure function of the first-appearance
key-insertion sequence (copies preserve order), which the native `refsem`
extension replays through a real libstdc++ map.

Invariant used throughout the package: an in-memory originals/subread dict
is stored with keys in the SAME order the corresponding C++ map would
iterate them. Whenever the reference builds a NEW map by inserting keys in
sequence S, we build the dict in sequence S and then `reorder_map` it.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, List

import numpy as np

_EXT = None
_TRIED = False


def _ext():
    global _EXT, _TRIED
    if not _TRIED:
        _TRIED = True
        from ..native import load_refsem_ext

        _EXT = load_refsem_ext()
        if _EXT is None:
            warnings.warn(
                "refsem native extension unavailable: reference-order mode "
                "falls back to insertion order (contigs stay correct but are "
                "not bit-identical to the reference binary)")
    return _EXT


def have_oracle() -> bool:
    return _ext() is not None


def umap_order(keys: Iterable[int]) -> List[int]:
    """Keys in libstdc++ unordered_map iteration order, given their
    first-appearance insertion sequence."""
    ext = _ext()
    keys = list(keys)
    if ext is None or len(keys) <= 1:
        return keys
    return [int(k) for k in ext.umap_order(np.asarray(keys, dtype=np.uint64))]


def reorder_map(d: Dict[int, object]) -> Dict[int, object]:
    """Dict with the same items, keyed in C++ map iteration order (the
    stored-order invariant after the reference constructs a new map by
    inserting our dict's keys in their current order)."""
    if len(d) <= 1:
        return d
    return {k: d[k] for k in umap_order(d.keys())}
