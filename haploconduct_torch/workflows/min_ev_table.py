"""Evidence-threshold table for branch reduction.

Rebuild of scripts/min_ev_table.py: expected branch evidence per variation
distance from single-end coverage plus paired-end insert-size Normal-CDF
integration, then minimum-evidence thresholds from a binomial tail bound
(<= 1e-3 at 1% sequencing error).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple


def _norm_cdf(x: float, mean: float, std: float) -> float:
    return 0.5 * (1.0 + math.erf((x - mean) / (std * math.sqrt(2.0))))


def _choose(n: int, k: int) -> int:
    return math.comb(n, k)


def _find_min_ev(c: int, m1: int, seq_err: float, accuracy: float) -> int:
    """Smallest m1 with P(m1 <= X < c) <= accuracy for X~Bin(c, seq_err)
    (scripts/min_ev_table.py:134-146)."""
    def tail(m_start: int) -> float:
        return sum(_choose(c, m) * seq_err ** m * (1 - seq_err) ** (c - m)
                   for m in range(m_start, c))

    p1 = tail(m1)
    while p1 > accuracy:
        m1 += 1
        p1 = tail(m1)
    return m1


def build_threshold_table(
    readlen: float,
    intseg: float,
    stddev: float,
    hcov: float,
    seq_err: float = 0.01,
    accuracy: float = 1e-3,
) -> Dict[int, int]:
    """dist -> min required unique evidence. Also see `format_table`."""
    fragsize = intseg + 2 * readlen
    assert fragsize > 0
    exp_ev_list = []
    exp_ev = 0
    dist = 1
    while exp_ev > 0 or dist == 1:
        exp_ev = hcov * max(0.0, readlen - dist) / readlen
        p_sum = 0.0
        for x in range(0, int(math.floor(readlen))):
            p1 = _norm_cdf(dist - 2 * readlen + x + 1, intseg, stddev)
            p2 = _norm_cdf(dist - readlen + x, intseg, stddev)
            p_sum += p2 - p1
        exp_ev += hcov * p_sum / readlen
        exp_ev = int(math.floor(exp_ev))
        exp_ev_list.append(exp_ev)
        if exp_ev == 0:
            break
        dist += 1
        if dist > fragsize + 2 * stddev:
            break

    ev_to_threshold: Dict[int, int] = {}
    min_ev = 1
    for ev in sorted(set(exp_ev_list)):
        min_ev = _find_min_ev(ev, min_ev, seq_err, accuracy)
        ev_to_threshold[ev] = min_ev

    return {i + 1: ev_to_threshold[ev] for i, ev in enumerate(exp_ev_list)}


def format_table(table: Dict[int, int], readlen, intseg, stddev, hcov,
                 exp_ev: Dict[int, int] | None = None) -> str:
    """evidence_threshold_table.tsv text (scripts/min_ev_table.py:128-141)."""
    lines = [
        "# INPUT:",
        f"# readlen {readlen}",
        f"# intseg {intseg}",
        f"# stddev {stddev}",
        f"# hcov {hcov}",
        "# OUTPUT:",
        "# dist\texp_ev\tmin_ev",
    ]
    for dist in sorted(table):
        ev = exp_ev.get(dist, 0) if exp_ev else 0
        lines.append(f"{dist}\t{ev}\t{table[dist]}")
    return "\n".join(lines) + "\n"


def read_threshold_table(path: str) -> Dict[int, int]:
    out: Dict[int, int] = {}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split("\t")
            out[int(parts[0])] = int(parts[2])
    return out
