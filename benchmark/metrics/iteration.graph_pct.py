"""Share of the window spent in the iteration's graph phases (insert,
labelling, graph_cleanup, branch_reduction, cliques of
assemble/iteration.py:run_iteration's PhaseTimer, spans/iteration.json)."""

PHASES = ("insert", "labelling", "graph_cleanup", "branch_reduction", "cliques")


def read(record):
    sec = sum(record["phases"].get(p, 0.0) for p in PHASES)
    return 100.0 * sec / record["window_s"] if sec else None
