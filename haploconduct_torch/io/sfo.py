"""SFO overlap-candidate interchange format and conversion to 13-col overlaps.

SFO is the 8-column output of the reference's candidate generator
(rust-overlaps): ``idA idB ori(N|I) OHA OHB OLA OLB K`` where OHA/OHB are
overhangs (bases outside the overlap; sign encodes which read starts first),
OLA/OLB bases inside the overlap, K the number of mismatches allowed.

The conversion below reproduces the reference's scripts/sfo2overlaps.py
exactly, including its group-flush behavior (a pending candidate group is
typed by the *incoming* line's single/paired status and the final group is
never flushed) so text outputs diff clean against reference intermediates.
Reads are assumed indexed in concatenated order: singles [0, S), /1 reads
[S, S+P), /2 reads [S+P, S+2P) (reference: scripts/sfo2overlaps.py:124-147).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .overlaps import OVERLAP_DTYPE, empty_overlaps

SFO_DTYPE = np.dtype(
    [
        ("ida", np.int64),
        ("idb", np.int64),
        ("ori", "S1"),  # b"N" same orientation, b"I" reverse
        ("oha", np.int64),
        ("ohb", np.int64),
        ("ola", np.int64),
        ("olb", np.int64),
        ("k", np.int64),
    ]
)


def read_sfo(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            assert len(parts) == 8, f"bad SFO line: {line!r}"
            rows.append(
                (int(parts[0]), int(parts[1]), parts[2].encode(), int(parts[3]),
                 int(parts[4]), int(parts[5]), int(parts[6]), int(parts[7]))
            )
    return np.array(rows, dtype=SFO_DTYPE) if rows else np.zeros(0, dtype=SFO_DTYPE)


def write_sfo(path: str, sfo: np.ndarray) -> None:
    with open(path, "w") as f:
        for r in sfo:
            f.write(
                f"{int(r['ida'])}\t{int(r['idb'])}\t{r['ori'].decode()}\t{int(r['oha'])}\t"
                f"{int(r['ohb'])}\t{int(r['ola'])}\t{int(r['olb'])}\t{int(r['k'])}\n"
            )


def _py2_round(x: float) -> int:
    """Python-2 round-half-away-from-zero, as used by the reference script."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _original_id(sfo_id: int, num_singles: int, num_pairs: int) -> int:
    if num_pairs == 0:
        return sfo_id
    return sfo_id if sfo_id < num_singles + num_pairs else sfo_id - num_pairs


def _is_paired(orig_id: int, num_singles: int, num_pairs: int) -> bool:
    return num_pairs > 0 and orig_id >= num_singles


def _s_s_overlap(row: Tuple) -> Optional[list]:
    """One candidate row -> 13-field single-single overlap (as a list of
    py values), mirroring scripts/sfo2overlaps.py:150-200."""
    ida, idb, _sa, _sb, ori_c, oha, ohb, ola, olb, _k = row
    ori = b"+" if ori_c == b"N" else b"-"
    ovlen = min(ola, olb)
    if oha >= 0:  # read A starts first
        readlen_a = ola + oha + (0 if ohb >= 0 else -ohb)
        readlen_b = olb + (ohb if ohb >= 0 else 0)
        id1, id2, pos1, ori1, ori2 = ida, idb, oha, b"+", ori
    else:  # read B starts first
        readlen_a = ola + (0 if ohb >= 0 else -ohb)
        readlen_b = -oha + olb + (ohb if ohb >= 0 else 0)
        id1, id2, pos1, ori1, ori2 = idb, ida, -oha, ori, b"+"
    minreadlen = min(readlen_a, readlen_b)
    assert minreadlen > 0
    perc = min(_py2_round(100.0 * ovlen / minreadlen), 100)
    # [id1 id2 pos1 pos2 ord ori1 ori2 perc1 perc2 len1 len2 type1 type2]
    return [id1, id2, pos1, 0, b"-", ori1, ori2, perc, 0, ovlen, 0, b"s", b"s"]


def _match_group(group: List[Tuple], type_a: bool, type_b: bool) -> List[list]:
    """All consistent per-end overlap pairings of one (idA, idB) candidate
    group, merged into paired overlaps (scripts/sfo2overlaps.py:203-329)."""
    out = []
    if len(group) < 2:
        return out
    for i in range(len(group)):
        for j in range(i + 1, len(group)):
            merged = _pair_up(group[i], group[j], type_a, type_b)
            if merged is not None:
                out.append(merged)
    return out


def _pair_up(c1: Tuple, c2: Tuple, type_a: bool, type_b: bool) -> Optional[list]:
    if c1[4] != c2[4]:  # both ends must have the same relative orientation
        return None
    fwd = c1[4] == b"N"
    c1_sa, c1_sb, c2_sa, c2_sb = c1[2], c1[3], c2[2], c2[3]
    o1 = o2 = None
    if type_a and type_b:  # paired-paired: order by sfo ids of both sides
        if fwd:
            if c1_sa < c2_sa and c1_sb < c2_sb:
                o1, o2 = c1, c2
            elif c1_sa > c2_sa and c1_sb > c2_sb:
                o1, o2 = c2, c1
        else:
            if c1_sa < c2_sa and c1_sb > c2_sb:
                o1, o2 = c1, c2
            elif c1_sa > c2_sa and c1_sb < c2_sb:
                o1, o2 = c2, c1
    elif type_a and not type_b:  # paired-single
        c1_p, c2_p = c1[5], c2[5]
        if fwd:
            if c1_sa < c2_sa and c1_p < c2_p:
                o1, o2 = c1, c2
            elif c1_sa > c2_sa and c1_p > c2_p:
                o1, o2 = c2, c1
        else:
            if c1_sa < c2_sa and c1_p > c2_p:
                o1, o2 = c2, c1
            elif c1_sa > c2_sa and c1_p < c2_p:
                o1, o2 = c1, c2
    else:  # single-paired
        c1_p, c2_p = c1[5], c2[5]
        if fwd:
            if c1_sb < c2_sb and c1_p < c2_p:
                o1, o2 = c1, c2
            elif c1_sb > c2_sb and c1_p > c2_p:
                o1, o2 = c2, c1
        else:
            if c1_sb < c2_sb and c1_p > c2_p:
                o1, o2 = c2, c1
            elif c1_sb > c2_sb and c1_p < c2_p:
                o1, o2 = c1, c2
    if o1 is None:
        return None
    ov1 = _s_s_overlap(o1)
    ov2 = _s_s_overlap(o2)
    if ov1 is None or ov2 is None:
        return None
    # Assign the p/s types according to which read ended up first in overlap1
    if ov1[0] == c1[0]:
        t1 = b"p" if type_a else b"s"
        t2 = b"p" if type_b else b"s"
    else:
        t1 = b"p" if type_b else b"s"
        t2 = b"p" if type_a else b"s"
    merged = list(ov1)
    merged[11], merged[12] = t1, t2
    if t1 == b"p" and t2 == b"p":
        merged[4] = b"2" if ov1[0] != ov2[0] else b"1"
    merged[3] = ov2[2]  # pos2
    merged[8] = ov2[7]  # perc2
    merged[10] = ov2[9]  # len2
    return merged


def sfo_to_overlaps(sfo: np.ndarray, num_singles: int, num_pairs: int) -> np.ndarray:
    """SFO candidates (concatenated s+p1+p2 indexing) -> 13-col overlaps.

    Reproduces scripts/sfo2overlaps.py end to end: canonicalize pair order by
    original ID (with the N/I overhang flips), sort + dedup, emit S-S
    overlaps directly and merge per-end candidates into paired overlaps.
    """
    if sfo.size == 0:
        return empty_overlaps(0)
    # Canonicalize so original-id1 <= original-id2 (flip_N / flip_I),
    # vectorized over all candidate rows.
    ida = sfo["ida"].astype(np.int64)
    idb = sfo["idb"].astype(np.int64)
    if num_pairs:
        na = np.where(ida < num_singles + num_pairs, ida, ida - num_pairs)
        nb = np.where(idb < num_singles + num_pairs, idb, idb - num_pairs)
    else:
        na, nb = ida, idb
    rev = sfo["ori"] == b"I"
    oha = sfo["oha"].astype(np.int64)
    ohb = sfo["ohb"].astype(np.int64)
    ola = sfo["ola"].astype(np.int64)
    olb = sfo["olb"].astype(np.int64)
    kcol = sfo["k"].astype(np.int64)
    flip = na > nb
    c_na = np.where(flip, nb, na)
    c_nb = np.where(flip, na, nb)
    c_sa = np.where(flip, idb, ida)
    c_sb = np.where(flip, ida, idb)
    c_oha = np.where(flip, np.where(rev, ohb, -oha), oha)
    c_ohb = np.where(flip, np.where(rev, oha, -ohb), ohb)
    c_ola = np.where(flip, olb, ola)
    c_olb = np.where(flip, ola, olb)
    cols = (c_na, c_nb, c_sa, c_sb, rev.astype(np.int64), c_oha, c_ohb,
            c_ola, c_olb, kcol)

    if num_pairs == 0:
        # SE fast path: for single-end input the reference's sort keys
        # reduce to (na, nb, rev, oha) — sa/sb duplicate na/nb and the
        # remaining fields (ohb, ola, olb, k) are functions of
        # (na, nb, rev, oha) for engine-generated SFO. One packed int64
        # argsort replaces the 10-column lexsort; ties (possible only for
        # external SFO files with redundant rows) fall through to the
        # general path.
        pk = ((c_na << 44) | (c_nb << 25) | (rev.astype(np.int64) << 24)
              | (c_oha + (1 << 23)))
        order_fast = np.argsort(pk, kind="stable")
        spk = pk[order_fast]
        if len(spk) < 2 or not (spk[1:] == spk[:-1]).any():
            not_self = c_na[order_fast] != c_nb[order_fast]
            idx = order_fast[not_self]
            v_na, v_nb = c_na[idx], c_nb[idx]
            v_rev = rev[idx]
            v_oha, v_ohb = c_oha[idx], c_ohb[idx]
            v_ola, v_olb = c_ola[idx], c_olb[idx]
            ss_out = empty_overlaps(len(idx))
            ovlen = np.minimum(v_ola, v_olb)
            a_first = v_oha >= 0
            neg_ohb = np.where(v_ohb >= 0, 0, -v_ohb)
            pos_ohb = np.where(v_ohb >= 0, v_ohb, 0)
            readlen_a = np.where(a_first, v_ola + v_oha + neg_ohb,
                                 v_ola + neg_ohb)
            readlen_b = np.where(a_first, v_olb + pos_ohb,
                                 -v_oha + v_olb + pos_ohb)
            minreadlen = np.minimum(readlen_a, readlen_b)
            assert (minreadlen > 0).all()
            perc = np.minimum(
                np.floor(100.0 * ovlen / minreadlen + 0.5).astype(np.int64),
                100)
            ss_out["id1"] = np.where(a_first, v_na, v_nb)
            ss_out["id2"] = np.where(a_first, v_nb, v_na)
            ss_out["pos1"] = np.where(a_first, v_oha, -v_oha)
            ss_out["ord"] = b"-"
            ori_ab = np.where(v_rev, b"-", b"+")
            ss_out["ori1"] = np.where(a_first, b"+", ori_ab)
            ss_out["ori2"] = np.where(a_first, ori_ab, b"+")
            ss_out["perc1"] = perc
            ss_out["len1"] = ovlen
            ss_out["type1"] = b"s"
            ss_out["type2"] = b"s"
            # rows with distinct keys are provably distinct 13-col lines,
            # so the final `uniq` pass is a no-op here
            return ss_out

    # sort -k1,1n -k2,2n -k3,3n -k4,4n | uniq (full-field refinement for a
    # deterministic tie order) + consecutive dedup
    order = np.lexsort(cols[::-1])
    mat = np.stack([c[order] for c in cols], axis=1)
    if len(mat) > 1:
        keep = np.ones(len(mat), dtype=bool)
        keep[1:] = np.any(mat[1:] != mat[:-1], axis=1)
        mat = mat[keep]

    pa = (num_pairs > 0) & (mat[:, 0] >= num_singles)
    pb = (num_pairs > 0) & (mat[:, 1] >= num_singles)
    not_self = mat[:, 0] != mat[:, 1]
    ss_mask = ~pa & ~pb & not_self

    # ---- vectorized S-S conversion (scripts/sfo2overlaps.py:150-200)
    ss = mat[ss_mask]
    ss_out = empty_overlaps(len(ss))
    if len(ss):
        v_na, v_nb = ss[:, 0], ss[:, 1]
        v_rev = ss[:, 4].astype(bool)
        v_oha, v_ohb, v_ola, v_olb = ss[:, 5], ss[:, 6], ss[:, 7], ss[:, 8]
        ovlen = np.minimum(v_ola, v_olb)
        a_first = v_oha >= 0
        neg_ohb = np.where(v_ohb >= 0, 0, -v_ohb)
        pos_ohb = np.where(v_ohb >= 0, v_ohb, 0)
        readlen_a = np.where(a_first, v_ola + v_oha + neg_ohb, v_ola + neg_ohb)
        readlen_b = np.where(a_first, v_olb + pos_ohb, -v_oha + v_olb + pos_ohb)
        minreadlen = np.minimum(readlen_a, readlen_b)
        assert (minreadlen > 0).all()
        # py2 round-half-away-from-zero on a non-negative ratio
        perc = np.minimum(
            np.floor(100.0 * ovlen / minreadlen + 0.5).astype(np.int64), 100)
        ss_out["id1"] = np.where(a_first, v_na, v_nb)
        ss_out["id2"] = np.where(a_first, v_nb, v_na)
        ss_out["pos1"] = np.where(a_first, v_oha, -v_oha)
        ss_out["ord"] = b"-"
        ori_ab = np.where(v_rev, b"-", b"+")
        ss_out["ori1"] = np.where(a_first, b"+", ori_ab)
        ss_out["ori2"] = np.where(a_first, ori_ab, b"+")
        ss_out["perc1"] = perc
        ss_out["len1"] = ovlen
        ss_out["type1"] = b"s"
        ss_out["type2"] = b"s"

    # ---- paired groups: Python loop over the (few) rows touching pairs
    pe_rows = np.flatnonzero(~ss_mask & not_self)
    pe_out: List[Tuple[int, list]] = []  # (emit row position, 13-col fields)
    group: List[Tuple] = []
    for ridx in pe_rows:
        row = tuple(mat[ridx])
        row = (row[0], row[1], row[2], row[3],
               b"I" if row[4] else b"N", row[5], row[6], row[7], row[8], row[9])
        cur_pa = bool(pa[ridx])
        cur_pb = bool(pb[ridx])
        if group and (group[0][0], group[0][1]) != (row[0], row[1]):
            # NOTE reference quirk kept for parity: the flushed group is
            # typed by the *current* line's paired status, and the last
            # group is never flushed (scripts/sfo2overlaps.py:89-102).
            for ov in _match_group(group, cur_pa, cur_pb):
                pe_out.append((int(ridx), ov))
            group = []
        group.append(row)

    # merge S-S and paired outputs in original (sorted-row) emit order
    if pe_out:
        ss_idx = np.flatnonzero(ss_mask)
        merged = empty_overlaps(len(ss_out) + len(pe_out))
        order_keys = np.concatenate([
            ss_idx.astype(np.int64),
            np.array([e for e, _ in pe_out], dtype=np.int64)])
        pe_arr = empty_overlaps(len(pe_out))
        for i, (_, ov) in enumerate(pe_out):
            pe_arr[i] = tuple(ov)
        merged[:len(ss_out)] = ss_out
        merged[len(ss_out):] = pe_arr
        merged = merged[np.argsort(order_keys, kind="stable")]
    else:
        merged = ss_out

    # final `uniq` pass: drop consecutive duplicate rows
    if len(merged) > 1:
        raw = merged.view(np.uint8).reshape(len(merged), -1)
        keep = np.ones(len(merged), dtype=bool)
        keep[1:] = np.any(raw[1:] != raw[:-1], axis=1)
        merged = merged[keep]
    return merged
