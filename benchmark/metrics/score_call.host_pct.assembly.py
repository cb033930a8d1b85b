"""Share of the window the scoring call spends on the host around the
card: the score.prepare (task checks, the host pack), score.matrix (the
device cache's row keys, match and upload) and score.finish (the f64
tail) phases that ops/score.py:score_tasks_torch opens inside the verify
phase of run_iteration's PhaseTimer (spans/iteration.json). None where
the program opens no such phase."""

PHASES = ("score.prepare", "score.matrix", "score.finish")


def read(record):
    sec = sum(record["phases"].get(p, 0.0) for p in PHASES)
    return 100.0 * sec / record["window_s"] if sec else None
