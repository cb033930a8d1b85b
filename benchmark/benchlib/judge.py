"""The comparison that decides `correct`: the program's verification
decisions and contigs against the plain reference (reference.py).

A judged verify call is a dict of numpy arrays that the driver took from
the program's call (hooks.extract_call): the reads' units and ids, the
overlaps, the thresholds, and what the program answered (score and
mismatch rate of every overlap, and its class). `judge_call` puts the
float64 reference beside them, or with `control` the float32 reference in
the program's place: the control of the comparison (control.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import reference

# the numbers compared, each with its limit (set in the cell's file from
# the readings of the program and of the control; see PERF.md)
VERIFY_NUMBERS = ("decision_flips", "mismatch_rate_diffs", "threshold_gap_ratio")
CONTIG_NUMBERS = ("consensus_disagreements", "unsupported_positions", "read_outside_share",
                  "contig_mismatch_share", "haplotype_uncovered_max")


def reference_scores(call: dict, dtype, device) -> dict:
    codes, quals, lens = reference.oriented_rows(call["units"])
    ia, ib, row_a, row_b, pos = reference.single_end_tasks(
        call["ids"], call["id1"], call["id2"], call["ori1"], call["ori2"], call["pos1"])
    out = reference.score_tasks(codes, quals, lens, row_a, row_b, pos,
                                mismatch_thresh=call["mismatch"],
                                min_read_len=call["min_read_len"],
                                dtype=dtype, device=device)
    out["v1"], out["v2"] = ia, ib
    out["cls"] = reference.decisions(out["score"], out["mismatch_rate"],
                                     call["edge_threshold"], call["ov_threshold"],
                                     call["merge_contigs"])
    return out


def compare(call: dict, answer: dict, ref: dict) -> Dict[str, float]:
    """One call's readings: overlaps whose class or endpoints differ from
    the reference's; mismatch rates that are not the reference's to the
    last bit; how near a score came to a wrong decision, as its gap from
    the reference's score over the reference's distance from each
    threshold in (0, 1) (a wrong side of a threshold reads 1 or more); and
    the largest relative gap of a score from the reference's."""
    flips = int(np.sum((answer["cls"] != ref["cls"]) | (answer["v1"] != ref["v1"])
                       | (answer["v2"] != ref["v2"])))
    rate_diffs = int(np.sum(answer["mismatch_rate"] != ref["mismatch_rate"]))
    s_ref = ref["score"]
    gap = np.abs(answer["score"] - s_ref)
    ratio = 0.0
    for t in (call["edge_threshold"], call["ov_threshold"]):
        if 0.0 < t < 1.0 and len(gap):
            dist = np.abs(s_ref - t)
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.where(gap > 0, gap / dist, 0.0)
            ratio = max(ratio, float(np.max(r)))
    pos = s_ref > 0
    rel = float(np.max(gap[pos] / s_ref[pos])) if np.any(pos) else 0.0
    if np.any(~pos & (answer["score"] != 0)):
        rel = float("inf")
    return {"decision_flips": flips, "mismatch_rate_diffs": rate_diffs,
            "threshold_gap_ratio": ratio, "score_rel_gap": rel, "overlaps": len(s_ref)}


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out = {"decision_flips": 0, "mismatch_rate_diffs": 0, "threshold_gap_ratio": 0.0,
           "score_rel_gap": 0.0, "overlaps": 0, "calls": 0}
    for r in readings:
        for k in ("decision_flips", "mismatch_rate_diffs", "overlaps"):
            out[k] += r[k]
        for k in ("threshold_gap_ratio", "score_rel_gap"):
            out[k] = max(out[k], r[k])
        out["calls"] += r.get("calls", 1)
    return out


def judge_call(call: dict, device, control: bool = False) -> Dict[str, float]:
    """The program's answers against the float64 reference; with
    `control`, the reference in float32 in the program's place."""
    import torch

    ref = reference_scores(call, torch.float64, device)
    answer = reference_scores(call, torch.float32, device) if control else call["answer"]
    return compare(call, answer, ref)


def judge_contigs(units: List[dict]) -> Dict[str, float]:
    """Every window unit's contig sets, each against the reads laid out
    under its contigs, and all of a unit's sets against its haplotypes. A
    unit is {"haps": [...], "sets": [{"contigs": [...], "layouts":
    [...]}, ...]}. Counts add up over the window; the outside share is
    the window's read bases laid outside their contig over all laid; the
    mismatch share is the window's mismatched bases over its contig
    bases; the uncovered
    share is the largest of any haplotype of any unit. Each unit's
    uncovered and mismatch shares are kept as readings too."""
    bad = judged = unsupported = outside = laid = mism = bases = contigs = 0
    uncovered = worst = 0.0
    per_unit = []
    for u in units:
        for cs in u["sets"]:
            b, j, un, out, n = reference.consensus_disagreements(cs["contigs"], cs["layouts"])
            bad, judged, unsupported = bad + b, judged + j, unsupported + un
            outside, laid = outside + out, laid + n
            contigs += len(cs["contigs"])
        mm, n, unc, w = reference.haplotype_agreement([cs["contigs"] for cs in u["sets"]],
                                                      u["haps"])
        mism, bases = mism + mm, bases + n
        uncovered, worst = max(uncovered, unc), max(worst, w)
        per_unit.append([unc, mm / n if n else 1.0])
    return {"consensus_disagreements": bad, "unsupported_positions": unsupported,
            "read_outside_share": outside / laid if laid else 0.0, "contig_mismatch_share": mism / bases if bases else 1.0,
            "haplotype_uncovered_max": uncovered if units else 1.0,
            "positions_judged": judged, "contigs": contigs, "contig_bases": bases,
            "worst_contig_mismatch": worst, "unit_uncovered_mismatch": per_unit}


def _drop_half(cs):
    n = len(cs["contigs"])
    return {k: v[(n + 1) // 2:] for k, v in cs.items()}


def _truncate(cs):
    return {"contigs": [c[: len(c) // 2] for c in cs["contigs"]], "layouts": cs["layouts"]}


def _empty_layouts(cs):
    return {"contigs": cs["contigs"], "layouts": [[] for _ in cs["layouts"]]}


def _alter_middle(cs):
    out = []
    for c in cs["contigs"]:
        c = c.copy()
        if len(c):
            c[len(c) // 2] = (c[len(c) // 2] + 1) % 4
        out.append(c)
    return {"contigs": out, "layouts": cs["layouts"]}


# faults of an assembly's output, as the judge reads them: the larger half
# of each set's contigs (by count) dropped, every contig cut to its first
# half, every contig's reads left out of its layout, the middle base of
# every contig changed
CONTIG_FAULTS = {"contigs_dropped": _drop_half, "contigs_truncated": _truncate,
                 "subreads_emptied": _empty_layouts, "contig_base_altered": _alter_middle}


def contig_fault_readings(units: List[dict]) -> Dict[str, Dict[str, float]]:
    """The contig numbers of the window's own contigs with each fault of
    CONTIG_FAULTS put in: the readings a limit has to fail."""
    return {name: judge_contigs([{"haps": u["haps"], "sets": [f(cs) for cs in u["sets"]]}
                                 for u in units])
            for name, f in CONTIG_FAULTS.items()}


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, ok)] for every number that has a limit."""
    out = []
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        out.append((name, value, limit, bool(ok)))
    return out
