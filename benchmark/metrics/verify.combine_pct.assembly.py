"""Share of the window spent turning the verification's task scores into
edges: the verify.rates (clamp, exact mismatch rates), verify.combine
(combine_scores over the stream) and verify.select (thresholds, the edge
rows, counters) phases that ops/verify.py:verify_overlaps opens inside
the verify phase of run_iteration's PhaseTimer (spans/iteration.json).
None where the program opens no such phase."""

PHASES = ("verify.rates", "verify.combine", "verify.select")


def read(record):
    sec = sum(record["phases"].get(p, 0.0) for p in PHASES)
    return 100.0 * sec / record["window_s"] if sec else None
