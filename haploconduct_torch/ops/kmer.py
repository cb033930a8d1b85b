"""Overlap candidate generation: k-mer seeded suffix-prefix matching.

Replaces the reference's external rust-overlaps dependency (FM-index
approximate matching, invoked at savage.py:664 / polyte.py:514): sequences
are 2-bit packed, every k-mer is hashed to (hash, seq, pos) tuples, and a
sort-join over hashes yields candidate (pair, shift) diagonals. Gapless
overlaps only — the verification kernel (ops/score.py) scores gapless
alignments, exactly like the reference's EdgeCalculator, so indel-shifted
candidates would be rejected there anyway.

Output is the SFO 8-column candidate format (io/sfo.py) with the same
concatenated s+p1+p2 index convention, so io/sfo.sfo_to_overlaps provides
the same PE-merging path as the reference's sfo2overlaps script.

The join is pure NumPy on host; a jax/sort-based device version is the
planned scale-up path for deep-coverage datasets (the host version guards
against repetitive k-mer blowup with `max_group`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..core.reads import N_CODE, revcomp_codes
from ..io.sfo import SFO_DTYPE
from ..native import load_kmerjoin_ext


def _pack_keys(ida, idb, shift, rev):
    """63-bit key: 19b idA | 19b idB | 24b shift(+2^23) | 1b rev.
    Shifts are bounded by sequence length (< 2^23 here)."""
    return ((((np.asarray(ida).astype(np.int64) << 19) | idb) << 25)
            | ((shift + (1 << 23)) << 1) | rev)


def _hash_subsample_mask(h: np.ndarray, subsample: int) -> np.ndarray:
    """Content-based k-mer selection: keep iff mix(hash) % subsample == 0.

    Because selection depends only on k-mer content, two reads sharing a
    k-mer either both keep it or both drop it, so every true overlap with
    S shared k-mers survives with prob 1-(1-1/m)^S — the classic MinHash
    sketching argument. This shrinks the sort-join by ~m^2 (both the
    query list and the posting-list sizes scale by 1/m)."""
    if subsample <= 1:
        return np.ones(len(h), dtype=bool)
    mixed = (h.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    return (mixed % np.uint64(subsample)) == 0


def auto_subsample(min_overlap_len: int, k: int, error_rate: float = 0.0) -> int:
    """Pick the subsampling modulus so a minimal-length true overlap is
    missed with probability < ~1e-4: m <= S/10, capped at 8.

    S is the expected number of *exact* shared k-mers in a minimal-length
    overlap. Error-free that is min_overlap_len - k + 1; sequencing errors
    break k-mers, so each survives with probability ~(1-e)^k per read
    (~(1-e)^(2k) for a pair of reads that must both carry it exactly), and
    we scale S accordingly. With the default e=0 this reduces to the
    error-free count — callers with noisy reads must pass their error rate
    or the real miss rate at minimum overlap length can be 10-100x higher
    than the 1e-4 design point."""
    s_shared = max(min_overlap_len - k + 1, 1)
    if error_rate > 0.0:
        survive = (1.0 - min(error_rate, 0.5)) ** (2 * k)
        s_shared = max(s_shared * survive, 1.0)
    return int(np.clip(int(s_shared) // 10, 1, 8))


def _kmer_table(seqs, lens, k: int, seed_step: int, subsample: int = 1):
    """(hash, seq_id, pos) over all sequences, computed in one vectorized
    pass over an N-separated concatenation (cross-boundary k-mers are
    killed by the separator N's)."""
    n = len(seqs)
    sep = np.full(k, N_CODE, dtype=np.int8)
    parts = []
    for sq in seqs:
        parts.append(sq)
        parts.append(sep)
    buf = np.concatenate(parts)
    h = _kmer_hashes(buf, k)
    starts = np.concatenate([[0], np.cumsum(lens + k)])[:-1]
    # ownership: position p belongs to seq i iff starts[i] <= p < starts[i]+len-k+1
    valid = h >= 0
    if subsample > 1:
        valid &= _hash_subsample_mask(h, subsample)
    idx = np.flatnonzero(valid)
    sid = np.searchsorted(starts, idx, side="right") - 1
    pos = idx - starts[sid]
    if seed_step > 1:
        keep = pos % seed_step == 0
        idx, sid, pos = idx[keep], sid[keep], pos[keep]
    return h[idx], sid.astype(np.int64), pos.astype(np.int64)


def _kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit packed k-mer codes for all positions; positions containing an
    N get hash -1 (excluded).

    Horner over k shifted slices (k length-n vector ops) instead of the
    (n, k) @ (k,) int64 matmul — integer matmuls have no BLAS path and
    dominated k-mer hashing at envelope scale; window validity via a
    cumulative invalid count instead of a second (n, k) reduction."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    c = codes.astype(np.int64)
    n_out = n - k + 1
    h = c[:n_out].copy()
    for j in range(1, k):
        h <<= 2
        h |= c[j:j + n_out]
    bad = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(codes >= N_CODE, out=bad[1:])
    ok = (bad[k:] - bad[:n_out]) == 0
    return np.where(ok, h, -1)


def find_overlap_candidates(
    seqs: List[np.ndarray],
    min_overlap_len: int,
    k: int = 20,
    seed_step: int = 1,
    with_reversals: bool = True,
    with_inclusions: bool = True,
    max_group: int = 2000,
    error_rate: float = 0.0,
    verify: bool = False,
    subsample: Optional[int] = None,
) -> np.ndarray:
    """All candidate suffix-prefix overlaps among `seqs` (code arrays).

    Returns an SFO-format array: idA < idB, ori 'N' (same strand) or 'I'
    (B reversed), overhangs/overlap lengths derived from the seed diagonal.
    `error_rate` sets the K column (allowed mismatches); with
    ``verify=True`` candidates are additionally scored on their diagonal
    and only kept when their gapless mismatch rate is within `error_rate`
    — matching rust-overlaps' semantics of only emitting verified
    approximate overlaps (its FM-index search is edit-distance based, so
    indel-shifted overlaps it would find are still absent here).
    """
    lens = np.array([len(sq) for sq in seqs], dtype=np.int64)
    n = len(seqs)
    if n == 0:
        return np.zeros(0, dtype=SFO_DTYPE)
    if subsample is None:
        subsample = auto_subsample(min_overlap_len, k, error_rate)

    # query side stays in sid-major order (the table enumerates reads in
    # order): the native join exploits this to emit per-read sorted-unique
    # runs without a global sort over the coverage-quadratic hit count
    q_h, q_sid, q_pos = _kmer_table(seqs, lens, k, seed_step, subsample)
    order = np.argsort(q_h, kind="stable")
    fwd_h, fwd_sid, fwd_pos = q_h[order], q_sid[order], q_pos[order]

    pairs = []  # packed int64 keys: 19b idA | 19b idB | 24b shift(+2^23) | 1b rev

    assert n < (1 << 19), "too many sequences for packed dedup keys"

    join_ext = None if os.environ.get("HC_KMERJOIN") == "numpy" \
        else load_kmerjoin_ext()

    def join(query_h, query_sid, query_pos, rev: bool):
        """Match query k-mers against the forward table; emit unique
        packed (idA, idB, shift, rev) keys without materializing the
        4-column candidate array (the joins dominate runtime)."""
        left = np.searchsorted(fwd_h, query_h, side="left")
        right = np.searchsorted(fwd_h, query_h, side="right")
        counts = right - left
        big = counts > max_group
        counts = np.where(big, 0, counts)
        total = int(counts.sum())
        if total == 0:
            return
        if join_ext is not None:
            # native expansion: per-read sorted-unique runs over a
            # sid-major query stream (native/kmerjoin.cpp) with the
            # min_overlap_len filter applied at emission; the surviving
            # key set is byte-equal to the numpy join + post-unpack
            # filter below
            pairs.append(join_ext.join_unique(
                query_sid, query_pos, left, counts, fwd_sid, fwd_pos,
                int(rev), lens, min_overlap_len))
            return
        q_idx = np.repeat(np.arange(len(query_h)), counts)
        csum = np.cumsum(counts)
        offs = np.arange(total, dtype=np.int64) - np.repeat(csum - counts, counts)
        t_idx = np.repeat(left, counts) + offs
        qa, qp = query_sid[q_idx], query_pos[q_idx]
        tb, tp = fwd_sid[t_idx], fwd_pos[t_idx]
        keep = qa != tb
        qa, tb = qa[keep], tb[keep]
        # shift = start of B's forward seq relative to A's (query) seq
        shift = qp[keep] - tp[keep]
        pairs.append(np.unique(_pack_keys(qa, tb, shift, int(rev))))

    join(q_h, q_sid, q_pos, rev=False)
    if with_reversals:
        rc_seqs = [revcomp_codes(sq) for sq in seqs]
        rc_h, rc_sid, rc_pos = _kmer_table(rc_seqs, lens, k, 1, subsample)
        join(rc_h, rc_sid, rc_pos, rev=True)

    if not pairs:
        return np.zeros(0, dtype=SFO_DTYPE)
    # each join's key array is already unique, and the fwd/rev sets are
    # disjoint (rev bit differs) — plain concatenation IS the unique set;
    # downstream dedup-after-canonicalization re-sorts anyway
    key = np.concatenate(pairs)
    if join_ext is not None:
        # native canonicalization: min_ov already filtered at emission,
        # frame mapping + idA<idB swap + final sorted-unique in one native
        # pass (the ~20-pass numpy chain below is memory-bound at scale)
        ckey = join_ext.canonicalize_keys(key, lens,
                                          drop_inclusions=not with_inclusions)
        rev = (ckey & 1).astype(bool)
        shift = ((ckey >> 1) & ((1 << 24) - 1)) - (1 << 23)
        idb = (ckey >> 25) & ((1 << 19) - 1)
        ida = ckey >> 44
    else:
        # unpack: 19b idA | 19b idB | 24b shift(+2^23) | 1b rev
        rev = (key & 1).astype(bool)
        shift = ((key >> 1) & ((1 << 24) - 1)) - (1 << 23)
        tb = (key >> 25) & ((1 << 19) - 1)
        qa = key >> 44
        la = lens[qa]  # length of the (possibly reversed) query = len of A
        lb = lens[tb]

        # overlap on the query frame: A covers [0, la), B covers
        # [shift, shift+lb)
        start = np.maximum(0, shift)
        end = np.minimum(la, shift + lb)
        ov = end - start
        ok = ov >= min_overlap_len
        if not with_inclusions:
            contained = (((shift <= 0) & (shift + lb >= la))
                         | ((shift >= 0) & (shift + lb <= la)))
            ok &= ~contained
        qa, tb, shift, rev = (x[ok] for x in (qa, tb, shift, rev))
        la, lb = la[ok], lb[ok]

        # canonicalize to idA < idB in the A-frame; for rev hits the query
        # was revcomp(A), so map the diagonal back to A's forward frame:
        # revcomp(A)[p] pairs with A[la-1-p] => B (forward) aligned to
        # revcomp(A) at `shift` corresponds to revcomp(B) aligned to
        # forward A at shift' = la - (shift + lb)
        shift = np.where(rev, la - (shift + lb), shift)

        swap = qa > tb
        ida = np.where(swap, tb, qa)
        idb = np.where(swap, qa, tb)
        # when swapping on a same-strand hit, the diagonal negates; on a
        # reversed hit the roles are symmetric under reversal: B aligned
        # at `shift` in A's frame <=> A aligned at the mirrored shift in
        # B's frame
        shift = np.where(swap, np.where(rev, shift + lb - la, -shift), shift)

        # dedup again after canonicalization
        key = _pack_keys(ida, idb, shift, rev.astype(np.int64))
        order = np.unique(key, return_index=True)[1]
        ida, idb, shift, rev = ida[order], idb[order], shift[order], rev[order]
    la, lb = lens[ida], lens[idb]

    # SFO fields: OHA = A bases before overlap (signed: negative if B
    # starts first), OHB = B bases after A's end (signed)
    oha = shift
    ohb = (shift + lb) - la
    start = np.maximum(0, shift)
    end = np.minimum(la, shift + lb)
    ov = end - start
    k_col = np.ceil(error_rate * ov).astype(np.int64)

    out = np.zeros(len(ida), dtype=SFO_DTYPE)
    out["ida"] = ida
    out["idb"] = idb
    out["ori"] = np.where(rev, b"I", b"N")
    out["oha"] = oha
    out["ohb"] = ohb
    out["ola"] = ov
    out["olb"] = ov
    out["k"] = k_col
    if verify and len(out):
        out = _verify_candidates(seqs, lens, out, error_rate)
    return out


def _verify_candidates(seqs, lens, sfo: np.ndarray, error_rate: float) -> np.ndarray:
    """Count mismatches on each candidate diagonal (sequence-only) and keep
    candidates whose count is <= ceil(error_rate * overlap_len).

    Pure int8 compare on the shifted windows — no phred math; the full
    Bayesian scoring runs later in the edge calculator. This pass is on
    POLYTE's critical path (overlaps are recomputed every iteration)."""
    from ..core.reads import PAD_CODE

    n = len(seqs)
    w = int(lens.max(initial=1))
    codes = np.full((2 * n, w), PAD_CODE, dtype=np.int8)
    for i, sq in enumerate(seqs):
        codes[i, :len(sq)] = sq
        codes[n + i, :len(sq)] = revcomp_codes(sq)
    lens2 = np.concatenate([lens, lens]).astype(np.int64)

    shift = sfo["oha"].astype(np.int64)
    rev = sfo["ori"] == b"I"
    row_b = np.where(rev, sfo["idb"] + n, sfo["idb"])
    row_first = np.where(shift >= 0, sfo["ida"], row_b).astype(np.int64)
    row_second = np.where(shift >= 0, row_b, sfo["ida"]).astype(np.int64)
    pos = np.abs(shift)

    ext = None if os.environ.get("HC_KMERJOIN") == "numpy" \
        else load_kmerjoin_ext()
    if ext is not None:
        # native per-candidate diagonal scan with early reject; counts may
        # be partial for candidates already over ceil(error_rate * L) —
        # mism only grows from there, so the keep mask below is identical
        counted, mism = ext.diag_mismatch(codes, lens2, row_first,
                                          row_second, pos, error_rate)
    else:
        counted = np.zeros(len(sfo), dtype=np.int64)
        mism = np.zeros(len(sfo), dtype=np.int64)
        col = np.arange(w, dtype=np.int64)[None, :]
        chunk = 16384
        for lo in range(0, len(sfo), chunk):
            hi = min(lo + chunk, len(sfo))
            a = codes[row_first[lo:hi]]
            b = codes[row_second[lo:hi]]
            p = pos[lo:hi, None]
            idx = np.minimum(p + col, w - 1)
            a_shift = np.take_along_axis(a, idx, axis=1)
            L = np.minimum(lens2[row_first[lo:hi]] - pos[lo:hi], lens2[row_second[lo:hi]])
            cm = (col < L[:, None]) & (a_shift < N_CODE) & (b < N_CODE)
            counted[lo:hi] = np.count_nonzero(cm, axis=1)
            mism[lo:hi] = np.count_nonzero(cm & (a_shift != b), axis=1)
    allowed = np.ceil(error_rate * np.maximum(counted, 1)).astype(np.int64)
    keep = (counted > 0) & (mism <= allowed)
    return sfo[keep]
