"""The 13-column overlap record — the central interchange format.

One overlap per line, tab-separated:

    id1 id2 pos1 pos2 ord ori1 ori2 perc1 perc2 len1 len2 type1 type2

Field semantics (reference: src/Overlap.h:39-164):
- pos1: start of the overlap within (oriented) read1's /1 sequence;
- pos2: start of the second overlap for paired-involved overlaps, '-' or 0
  when irrelevant; when the pos2 *text* field is "-", pos2/perc2/len2 are
  all zeroed;
- ord in {'1','2','-'}: for P-P overlaps, which read comes first in the /2
  overlap; must be '-' iff either side is single-end;
- ori in {'+','-'}; type in {'s','p'};
- 0 <= perc <= 100, len >= 0.

Overlaps are held as a NumPy structured array (`OVERLAP_DTYPE`) so filtering
and batching for the device kernels is vectorized.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

OVERLAP_DTYPE = np.dtype(
    [
        ("id1", np.uint64),
        ("id2", np.uint64),
        ("pos1", np.int32),
        ("pos2", np.int32),
        ("ord", "S1"),
        ("ori1", "S1"),
        ("ori2", "S1"),
        ("perc1", np.int32),
        ("perc2", np.int32),
        ("len1", np.int32),
        ("len2", np.int32),
        ("type1", "S1"),
        ("type2", "S1"),
    ]
)

_FIELDS = list(OVERLAP_DTYPE.names)


def empty_overlaps(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=OVERLAP_DTYPE)


def make_overlaps(**cols) -> np.ndarray:
    """Build an overlap array from per-field columns (missing -> defaults)."""
    n = len(cols[next(iter(cols))])
    out = empty_overlaps(n)
    out["ord"] = b"-"
    out["ori1"] = b"+"
    out["ori2"] = b"+"
    out["type1"] = b"s"
    out["type2"] = b"s"
    for key, val in cols.items():
        out[key] = val
    return out


def read_overlaps(path: str, max_overlaps: int | None = None, allow_spaces: bool = False) -> np.ndarray:
    """Parse an overlaps.txt file into a structured array.

    Lines with a wrong field count are skipped, matching the reference's
    tolerant parser (src/EdgeCalculator.cpp:598-603).
    """
    with open(path, "r") as f:
        return parse_overlap_lines(f, max_overlaps=max_overlaps, allow_spaces=allow_spaces)


def _atoi(text: str) -> int:
    """C atoi semantics: non-numeric (e.g. "-") parses as 0."""
    try:
        return int(text)
    except ValueError:
        return 0


def parse_overlap_lines(lines, max_overlaps: int | None = None, allow_spaces: bool = False) -> np.ndarray:
    rows: List[tuple] = []
    for i, line in enumerate(lines):
        if max_overlaps is not None and i >= max_overlaps:
            break
        line = line.strip("\t \n")
        if not line:
            continue
        parts = line.split() if allow_spaces else line.split("\t")
        if len(parts) != 13:
            continue
        pos2_dash = parts[3].strip() == "-"
        rows.append(
            (
                int(parts[0]),
                int(parts[1]),
                int(parts[2]),
                0 if pos2_dash else _atoi(parts[3]),
                parts[4].strip().encode(),
                parts[5].strip().encode(),
                parts[6].strip().encode(),
                _atoi(parts[7]),
                0 if pos2_dash else _atoi(parts[8]),
                _atoi(parts[9]),
                0 if pos2_dash else _atoi(parts[10]),
                parts[11].strip().encode(),
                parts[12].strip().encode(),
            )
        )
    # NOTE: the reference zeroes pos2/perc2/len2 when the pos2 field is "-",
    # but *not* perc1/len1 (src/Overlap.h:55-59). Keep the same.
    out = np.array(rows, dtype=OVERLAP_DTYPE) if rows else empty_overlaps(0)
    validate_overlaps(out)
    return out


def validate_overlaps(ov: np.ndarray) -> None:
    """Format checks mirroring src/Overlap.h:107-164."""
    if ov.size == 0:
        return
    if np.any(ov["pos1"] < 0) or np.any(ov["pos2"] < 0):
        raise ValueError("overlap pos < 0")
    for f in ("perc1", "perc2"):
        if np.any((ov[f] < 0) | (ov[f] > 100)):
            raise ValueError("overlap perc not in [0, 100]")
    if np.any(ov["len1"] < 0) or np.any(ov["len2"] < 0):
        raise ValueError("overlap len < 0")
    for f in ("ori1", "ori2"):
        if not np.all(np.isin(ov[f], [b"+", b"-"])):
            raise ValueError("overlap ori not in {+, -}")
    for f in ("type1", "type2"):
        if not np.all(np.isin(ov[f], [b"s", b"p"])):
            raise ValueError("overlap type not in {s, p}")
    if not np.all(np.isin(ov["ord"], [b"1", b"2", b"-"])):
        raise ValueError("overlap ord not in {1, 2, -}")
    has_single = (ov["type1"] == b"s") | (ov["type2"] == b"s")
    if np.any(has_single & (ov["ord"] != b"-")):
        raise ValueError("ord must be '-' when either read is single-end")
    if np.any(~has_single & (ov["ord"] == b"-")):
        raise ValueError("ord must be '1' or '2' for paired-paired overlaps")


def overlap_perc(ov: np.ndarray) -> np.ndarray:
    """Combined overlap percentage (src/Overlap.h:203-210).

    For paired overlaps (perc2 > 0) the average of perc1/perc2, truncated to
    int exactly as the C++ unsigned-int return does.
    """
    avg = (0.5 * (ov["perc1"].astype(np.float64) + ov["perc2"].astype(np.float64))).astype(np.int64)
    return np.where(ov["perc2"] > 0, avg, ov["perc1"].astype(np.int64))


def overlap_lines(ov: np.ndarray) -> Iterable[str]:
    """Serialize to the exact reference line format (src/Overlap.h:234-237).

    The reference writes pos2/perc2/len2 as integers (zeros when irrelevant),
    never as '-', when re-serializing.
    """
    for r in ov:
        yield (
            f"{int(r['id1'])}\t{int(r['id2'])}\t{int(r['pos1'])}\t{int(r['pos2'])}\t"
            f"{r['ord'].decode()}\t{r['ori1'].decode()}\t{r['ori2'].decode()}\t"
            f"{int(r['perc1'])}\t{int(r['perc2'])}\t{int(r['len1'])}\t{int(r['len2'])}\t"
            f"{r['type1'].decode()}\t{r['type2'].decode()}\n"
        )


def write_overlaps(path: str, ov: np.ndarray, append: bool = False) -> None:
    with open(path, "a" if append else "w") as f:
        for line in overlap_lines(ov):
            f.write(line)
