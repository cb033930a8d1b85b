"""Read storage: the in-memory equivalent of the reference's FastqStorage.

Reads live as int8 base codes (A=0, C=1, G=2, T=3, N=4) plus uint8 phred
values (ASCII-33) in per-"unit" NumPy arrays. A *unit* is one contiguous
sequence: a single-end read contributes one unit, a paired-end read two
(/1 and /2). All device kernels operate on padded (rows, width) unit
matrices built by :meth:`ReadStore.pack`; orientation is handled by packing
both forward and reverse-complement views so a kernel row index encodes
(unit, orientation) with no per-row control flow on device.

Reference semantics preserved (src/FastqStorage.cpp:92-235):
- storage order is singles first, then paired reads;
- sequences are uppercased on load; /1-/2 files must agree on IDs in order;
- read IDs are arbitrary integers; ``id_to_index`` maps them to positions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastq import read_fastq

A, C, G, T, N_CODE = 0, 1, 2, 3, 4
PAD_CODE = 5  # padding sentinel, distinct from N so masks stay trivial

_ENCODE_LUT = np.full(256, -1, dtype=np.int8)
for _ch, _code in zip(b"ACGTN", (A, C, G, T, N_CODE)):
    _ENCODE_LUT[_ch] = _code
_DECODE_LUT = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()
_COMP_LUT = np.array([T, G, C, A, N_CODE, PAD_CODE], dtype=np.int8)


def encode_seq(seq: str) -> np.ndarray:
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    codes = _ENCODE_LUT[raw]
    if np.any(codes < 0):
        bad = chr(raw[np.argmax(codes < 0)])
        raise ValueError(f"invalid sequence character {bad!r}")
    return codes


def decode_seq(codes: np.ndarray) -> str:
    return _DECODE_LUT[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP_LUT[codes[::-1]]


def revcomp_str(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))


def encode_phred(phred: str) -> np.ndarray:
    q = np.frombuffer(phred.encode(), dtype=np.uint8).astype(np.int16) - 33
    if np.any(q < 0):
        raise ValueError("phred character below '!' (ASCII 33)")
    return q.astype(np.uint8)


def decode_phred(q: np.ndarray) -> str:
    return (q.astype(np.uint8) + 33).tobytes().decode()


class ReadStore:
    """Container of single- and paired-end reads (singles first)."""

    def __init__(self) -> None:
        self.ids: List[int] = []
        self.is_paired: List[bool] = []
        self.unit1: List[int] = []  # unit index of /1 (or the single seq)
        self.unit2: List[int] = []  # unit index of /2, -1 for singles
        self._unit_codes: List[np.ndarray] = []
        self._unit_quals: List[np.ndarray] = []
        self.id_to_index: Dict[int, int] = {}
        self.readcount_single = 0

    # ------------------------------------------------------------- building
    def _add_unit(self, codes: np.ndarray, quals: np.ndarray) -> int:
        assert codes.shape == quals.shape
        # no-copy when already typed: units forwarded unchanged between
        # iteration stores then SHARE their arrays, which the device-
        # resident matrix cache (ops/device_cache.py) exploits; units are
        # append-only and never mutated in place, so sharing is safe
        self._unit_codes.append(np.ascontiguousarray(codes, dtype=np.int8))
        self._unit_quals.append(np.ascontiguousarray(quals, dtype=np.uint8))
        return len(self._unit_codes) - 1

    def add_single(self, read_id: int, seq: str, phred: str) -> int:
        return self.add_single_codes(read_id, encode_seq(seq), encode_phred(phred))

    def add_single_codes(self, read_id: int, codes: np.ndarray, quals: np.ndarray) -> int:
        if len(codes) == 0:
            raise ValueError(f"single read {read_id} has an empty sequence")
        idx = len(self.ids)
        self.ids.append(int(read_id))
        self.is_paired.append(False)
        self.unit1.append(self._add_unit(codes, quals))
        self.unit2.append(-1)
        self.id_to_index[int(read_id)] = idx
        return idx

    def add_paired(self, read_id: int, seq1: str, phred1: str, seq2: str, phred2: str) -> int:
        return self.add_paired_codes(
            read_id, encode_seq(seq1), encode_phred(phred1), encode_seq(seq2), encode_phred(phred2)
        )

    def add_paired_codes(self, read_id, codes1, quals1, codes2, quals2) -> int:
        if len(codes1) == 0 or len(codes2) == 0:
            raise ValueError(f"paired read {read_id} has an empty sequence")
        idx = len(self.ids)
        self.ids.append(int(read_id))
        self.is_paired.append(True)
        self.unit1.append(self._add_unit(codes1, quals1))
        self.unit2.append(self._add_unit(codes2, quals2))
        self.id_to_index[int(read_id)] = idx
        return idx

    @classmethod
    def from_files(
        cls,
        singles: Optional[str] = None,
        paired1: Optional[str] = None,
        paired2: Optional[str] = None,
        id_map: Optional[Dict[str, int]] = None,
    ) -> "ReadStore":
        """Load fastq files; ``id_map`` optionally renames fastq IDs to
        overlap-file integer IDs (reference --IDs flag)."""
        store = cls()
        single_recs = read_fastq(singles) if singles else ([], [], [])
        if paired1 or paired2:
            assert paired1 and paired2, "both paired fastq files required"
            ids1, seqs1, phreds1 = read_fastq(paired1)
            ids2, seqs2, phreds2 = read_fastq(paired2)
            if ids1 != ids2:
                raise ValueError("fastq files /1 /2 are not ordered identically")
        else:
            ids1, seqs1, phreds1, seqs2, phreds2 = [], [], [], [], []

        all_raw = list(single_recs[0]) + list(ids1)
        if id_map is not None:
            ids = [int(id_map[r]) for r in all_raw]
        else:
            try:
                ids = [int(r) for r in all_raw]
            except ValueError:
                # non-integer fastq IDs: rename positionally, as the
                # reference's preprocessing (scripts/rename_fas.py) does
                ids = list(range(len(all_raw)))

        n_single = len(single_recs[0])
        for rid, seq, phred in zip(ids[:n_single], single_recs[1], single_recs[2]):
            store.add_single(rid, seq, phred)
        store.readcount_single = len(store.ids)
        for rid, s1, p1, s2, p2 in zip(ids[n_single:], seqs1, phreds1, seqs2, phreds2):
            store.add_paired(rid, s1, p1, s2, p2)
        return store

    # ------------------------------------------------------------ accessors
    def ids_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted_ids, argsort_order) for vectorized id->index lookups;
        cached and rebuilt only when reads were added (ids are append-only
        — nothing mutates them in place)."""
        cur = len(self.ids)
        if getattr(self, "_ids_cache_n", -1) != cur:
            keys = np.array(self.ids, dtype=np.int64)
            order = np.argsort(keys, kind="stable")
            # identity flag lets lookups skip the searchsorted entirely
            # (ids are 0..n-1 in every internally-built store)
            identity = bool(keys.size == 0 or
                            (keys[order][0] == 0 and keys[order][-1] == cur - 1
                             and len(np.unique(keys)) == cur
                             and (keys == np.arange(cur)).all()))
            self._ids_cache = (keys[order], order, identity)
            self._ids_cache_n = cur
        return self._ids_cache[:2]

    def ids_identity(self) -> bool:
        """True when read ids are exactly 0..n-1 in order (id == index)."""
        self.ids_index()
        return self._ids_cache[2]

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def n_units(self) -> int:
        return len(self._unit_codes)

    def unit_len(self, unit: int) -> int:
        return len(self._unit_codes[unit])

    def unit_codes(self, unit: int, forward: bool = True) -> np.ndarray:
        c = self._unit_codes[unit]
        return c if forward else revcomp_codes(c)

    def unit_quals(self, unit: int, forward: bool = True) -> np.ndarray:
        q = self._unit_quals[unit]
        return q if forward else q[::-1]

    def units_of(self, index: int) -> Tuple[int, int]:
        return self.unit1[index], self.unit2[index]

    def seq_str(self, index: int, end: int = 0) -> str:
        u1, u2 = self.unit1[index], self.unit2[index]
        if not self.is_paired[index]:
            assert end == 0
            return decode_seq(self._unit_codes[u1])
        assert end in (1, 2)
        return decode_seq(self._unit_codes[u1 if end == 1 else u2])

    def phred_str(self, index: int, end: int = 0) -> str:
        u1, u2 = self.unit1[index], self.unit2[index]
        if not self.is_paired[index]:
            assert end == 0
            return decode_phred(self._unit_quals[u1])
        assert end in (1, 2)
        return decode_phred(self._unit_quals[u1 if end == 1 else u2])

    def read_len(self, index: int) -> int:
        """Total sequence length (both ends for paired), Read::get_len."""
        u1, u2 = self.unit1[index], self.unit2[index]
        n = len(self._unit_codes[u1])
        if self.is_paired[index]:
            n += len(self._unit_codes[u2])
        return n

    def unit_lens(self) -> np.ndarray:
        return np.array([len(c) for c in self._unit_codes], dtype=np.int32)

    # -------------------------------------------------------------- packing
    def pack(self, width: Optional[int] = None) -> "PackedUnits":
        """Pad all units into (2*U, width) matrices: rows [0, U) forward,
        rows [U, 2U) reverse-complement. Pad positions get PAD_CODE / qual 0."""
        lens = self.unit_lens()
        u = len(lens)
        w = int(width) if width is not None else int(lens.max(initial=1))
        assert w >= int(lens.max(initial=0)), "pack width smaller than longest unit"
        codes = np.full((2 * u, w), PAD_CODE, dtype=np.int8)
        quals = np.zeros((2 * u, w), dtype=np.uint8)
        for i, (c, q) in enumerate(zip(self._unit_codes, self._unit_quals)):
            n = len(c)
            codes[i, :n] = c
            quals[i, :n] = q
            codes[u + i, :n] = _COMP_LUT[c[::-1]]
            quals[u + i, :n] = q[::-1]
        return PackedUnits(codes=codes, quals=quals, lens=lens, n_units=u)

    def pack_cached(self) -> "PackedUnits":
        """Default-width pack(), cached while no reads are added (reads are
        append-only and never mutated in place). Used by consumers that
        re-pack an UNCHANGING store every iteration, e.g. BranchReduction's
        original-read matrix."""
        cur = self.n_units
        cached = getattr(self, "_pack_cache", None)
        if cached is None or cached[0] != cur:
            self._pack_cache = (cur, self.pack())
        return self._pack_cache[1]


class PackedUnits:
    """Padded unit matrices ready for device transfer.

    Row layout: row ``i`` = forward unit ``i``; row ``n_units + i`` = its
    reverse complement (qualities reversed). ``row_index(unit, forward)``
    maps an oriented unit to its row.
    """

    def __init__(self, codes: np.ndarray, quals: np.ndarray, lens: np.ndarray, n_units: int):
        self.codes = codes
        self.quals = quals
        self.lens = lens
        self.n_units = n_units
        self.width = codes.shape[1]

    def row_index(self, unit, forward) -> np.ndarray:
        unit = np.asarray(unit)
        fwd = np.asarray(forward, dtype=bool)
        return np.where(fwd, unit, unit + self.n_units)

    def row_lens(self, row: np.ndarray) -> np.ndarray:
        return self.lens[np.asarray(row) % self.n_units]
