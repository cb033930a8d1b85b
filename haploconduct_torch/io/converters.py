"""Interchange-format converters (ports of the reference's small scripts).

- blast tabular -> 13-col overlaps  (scripts/blast2overlaps.py)
- blast tabular -> SFO              (scripts/blast2sfo.py)
- 13-col overlaps -> SFO            (scripts/overlaps2sfo.py)
- minimap2 PAF-ish -> SFO           (scripts/minimap2sfo.py)
- overlap orientation histogram     (scripts/analyze_overlaps.py)

These exist for interoperability with external overlap generators; the
native path is ops/kmer.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from .overlaps import parse_overlap_lines
from .sfo import SFO_DTYPE


def _py2_round(x: float) -> int:
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def blast_to_overlaps(lines: Iterable[str], min_overlap_len: int = 0,
                      allow_revcomp: bool = True) -> np.ndarray:
    """blast -outfmt '6 qseqid sseqid pident length mismatch gapopen qstart
    qend sstart send qlen slen' -> overlaps (blast2overlaps.py:35-103)."""
    out_lines: List[str] = []
    for line in lines:
        f = line.strip("\n").split("\t")
        (qseqid, sseqid, _pident, length, _mismatch, _gapopen,
         qstart, qend, sstart, send, qlen, slen) = f[:12]
        if qseqid == sseqid:
            continue
        if int(qstart) > int(qend) or int(sstart) > int(send):
            if not allow_revcomp:
                continue
        qori = int(qstart) <= int(qend)
        sori = int(sstart) <= int(send)
        assert qori
        if not sori:
            sstart = str(int(slen) - int(sstart) + 1)
            send = str(int(slen) - int(send) + 1)
        if int(length) < min_overlap_len:
            continue
        if int(qstart) - int(sstart) >= 0:
            id1, id2 = qseqid, sseqid
            pos1 = int(qstart) - int(sstart)
            ori1 = "+" if qori else "-"
            ori2 = "+" if sori else "-"
        else:
            id1, id2 = sseqid, qseqid
            ori1 = "+" if sori else "-"
            ori2 = "+" if qori else "-"
            pos1 = int(sstart) - int(qstart)
        perc = min(_py2_round(100 * max(int(length) / int(qlen), int(length) / int(slen))), 100)
        out_lines.append(
            f"{id1}\t{id2}\t{pos1}\t-\t-\t{ori1}\t{ori2}\t{perc}\t-\t{length}\t-\ts\ts")
    return parse_overlap_lines(out_lines)


def blast_to_sfo(lines: Iterable[str], min_overlap_len: int = 0) -> np.ndarray:
    """blast tabular -> SFO (blast2sfo.py:36-72)."""
    rows = []
    for line in lines:
        f = line.strip("\n").split("\t")
        (qseqid, sseqid, _pident, length, mismatch, _gapopen,
         qstart, qend, sstart, send, qlen, slen) = f[:12]
        if qseqid == sseqid:
            continue
        sori = int(sstart) <= int(send)
        if int(length) < min_overlap_len:
            continue
        ida, idb = qseqid, sseqid
        ori = b"N" if sori else b"I"
        ola = int(length)
        if sori:
            oha = int(qstart) - int(sstart)
            ohb = int(slen) - int(sstart) - (int(qlen) - int(qstart))
        else:
            oha = int(qstart) - (int(slen) - int(sstart) + 1)
            ohb = int(sstart) - (int(qlen) - int(qstart) + 1)
        if ida > idb:  # string comparison, as in the reference
            ida, idb = idb, ida
            if ori == b"N":
                oha, ohb = -oha, -ohb
            else:
                oha, ohb = ohb, oha
        rows.append((int(ida), int(idb), ori, oha, ohb, ola, ola, int(mismatch)))
    return np.array(rows, dtype=SFO_DTYPE) if rows else np.zeros(0, dtype=SFO_DTYPE)


def overlaps_to_sfo(ov: np.ndarray, id_to_len: Dict[int, int],
                    min_overlap_len: int = 0) -> np.ndarray:
    """13-col S-S overlaps -> SFO (overlaps2sfo.py:38-94)."""
    rows = []
    for r in ov:
        assert r["type1"] == b"s" and r["type2"] == b"s", "only s-s overlaps"
        id1, id2 = int(r["id1"]), int(r["id2"])
        if id1 == id2:
            continue
        length = int(r["len1"])
        if length < min_overlap_len:
            continue
        ori1, ori2 = r["ori1"], r["ori2"]
        ori = b"I" if ori1 != ori2 else b"N"
        oha = int(r["pos1"])
        if id_to_len[id2] == length:
            ohb = int(r["pos1"]) + length - id_to_len[id1]
        else:
            ohb = id_to_len[id2] - length
        ida, idb = id1, id2
        if str(ida) > str(idb):
            ida, idb = idb, ida
            ori1, ori2 = ori2, ori1
            oha, ohb = -oha, -ohb
        if ori1 == b"-":
            oha, ohb = -ohb, -oha
        rows.append((ida, idb, ori, oha, ohb, length, length, 0))
    return np.array(rows, dtype=SFO_DTYPE) if rows else np.zeros(0, dtype=SFO_DTYPE)


def minimap_to_sfo(lines: Iterable[str], min_overlap_len: int = 0,
                   min_pident: float = 98.0) -> np.ndarray:
    """minimap2 PAF-style 13 fields -> SFO (minimap2sfo.py:39-80)."""
    rows = []
    for line in lines:
        f = line.strip("\n").split("\t")
        (qseqid, qlen, qstart, _qend, qori, sseqid, slen, sstart, send,
         matchcount, length, _qual, _cigar) = f[:13]
        if int(length) < min_overlap_len:
            continue
        if int(matchcount) / float(length) < min_pident / 100.0:
            continue
        ida, idb = qseqid, sseqid
        ori = b"N" if qori == "+" else b"I"
        if ori == b"N":
            oha = int(qstart) - int(sstart)
            ohb = int(slen) - int(sstart) - (int(qlen) - int(qstart))
        else:
            oha = int(qstart) - (int(slen) - int(send))
            ohb = int(send) - (int(qlen) - int(qstart))
        if oha >= 0:
            ola = min(int(qlen) - oha, int(slen))
        else:
            ola = min(int(slen) + oha, int(qlen))
        if ida > idb:
            ida, idb = idb, ida
            if ori == b"N":
                oha, ohb = -oha, -ohb
            else:
                oha, ohb = ohb, oha
        mismatch = int(length) - int(matchcount)
        rows.append((int(ida), int(idb), ori, oha, ohb, ola, ola, mismatch))
    return np.array(rows, dtype=SFO_DTYPE) if rows else np.zeros(0, dtype=SFO_DTYPE)


def overlap_histogram(ov: np.ndarray) -> Dict[str, List[int]]:
    """Orientation/type histogram (scripts/analyze_overlaps.py,
    pipeline_per_stage.py:592-662). Keys 'pp','ps','sp','ss'; per key
    counts for [-+, +-, ++, --]."""
    out = {k: [0, 0, 0, 0] for k in ("pp", "ps", "sp", "ss")}
    for r in ov:
        key = ("p" if r["type1"] == b"p" else "s") + ("p" if r["type2"] == b"p" else "s")
        o1, o2 = r["ori1"] == b"+", r["ori2"] == b"+"
        if not o1 and o2:
            idx = 0
        elif o1 and not o2:
            idx = 1
        elif o1 and o2:
            idx = 2
        else:
            idx = 3
        out[key][idx] += 1
    return out


# --- clique-engine graph-format converters -------------------------------
# Library equivalents of the reference's quick-cliques/utils/ stdin
# converters (dimacs2edges.py, edge2dimacs.py, edges2graph.py,
# edges2snap.py, invertdimacs.py), operating on (n_vertices, v1, v2)
# undirected edge arrays. "edges" text = the graph.txt format OverlapGraph
# writes (line1 #vertices, line2 #edge-lines, then "i,j" BOTH directions,
# 0-based); dimacs = "p edge V E" + "e i j" 1-based; metis ".graph" =
# "V E" header + per-vertex sorted 1-based neighbor lines; snap = "i\tj".


def _canon_undirected(n: int, v1: np.ndarray, v2: np.ndarray):
    """Unique undirected edges as (a < b) int64 pairs, loops dropped."""
    v1 = np.asarray(v1, np.int64)
    v2 = np.asarray(v2, np.int64)
    keep = v1 != v2
    a = np.minimum(v1[keep], v2[keep])
    b = np.maximum(v1[keep], v2[keep])
    key = np.unique(a * np.int64(n) + b)
    return key // n, key % n


def edges_to_dimacs(n: int, v1: np.ndarray, v2: np.ndarray) -> str:
    a, b = _canon_undirected(n, v1, v2)
    lines = ["c", f"p edge {n} {len(a)}"]
    lines += [f"e {x + 1} {y + 1}" for x, y in zip(a, b)]
    return "\n".join(lines) + "\n"


def dimacs_to_edges(text: str):
    """-> (n, v1, v2) with both directions listed, matching graph.txt."""
    n = 0
    pairs = []
    for line in text.splitlines():
        if line.startswith("c") or not line.strip():
            continue
        if line.startswith("p"):
            parts = line.split()
            n = int(parts[-2])
            continue
        parts = line.split()
        x, y = int(parts[1]) - 1, int(parts[2]) - 1
        if x == y:
            raise ValueError("loop in dimacs file")
        pairs.append((x, y))
        pairs.append((y, x))
    v = np.array(pairs, np.int64).reshape(-1, 2)
    return n, v[:, 0], v[:, 1]


def complement_edges(n: int, v1: np.ndarray, v2: np.ndarray):
    """Edge set of the complement graph (the --invert / invertdimacs path)."""
    a, b = _canon_undirected(n, v1, v2)
    adj = np.zeros((n, n), dtype=bool)
    adj[a, b] = True
    iu = np.triu_indices(n, 1)
    missing = ~adj[iu]
    return iu[0][missing].astype(np.int64), iu[1][missing].astype(np.int64)


def edges_to_metis_graph(n: int, v1: np.ndarray, v2: np.ndarray) -> str:
    """quick-cliques '.graph' format (edges2graph.py): 'V E' then one
    sorted 1-based neighbor line per vertex."""
    a, b = _canon_undirected(n, v1, v2)
    nbrs = [[] for _ in range(n)]
    for x, y in zip(a, b):
        nbrs[x].append(y)
        nbrs[y].append(x)
    lines = [f"{n} {len(a)}"]
    lines += [" ".join(str(w + 1) for w in sorted(nb)) for nb in nbrs]
    return "\n".join(lines) + "\n"


def edges_to_snap(n: int, v1: np.ndarray, v2: np.ndarray) -> str:
    """Tab-separated directed edge list (edges2snap.py keeps both
    directions as given)."""
    v1 = np.asarray(v1, np.int64)
    v2 = np.asarray(v2, np.int64)
    return "".join(f"{x}\t{y}\n" for x, y in zip(v1, v2))
