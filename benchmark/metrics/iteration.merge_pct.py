"""Share of the window spent in the iteration's merge phases (superreads,
fno and next_store of assemble/iteration.py:run_iteration's PhaseTimer,
spans/iteration.json): turning cliques into superreads, the FNO rule and
the next iteration's store."""

PHASES = ("superreads", "fno", "next_store")


def read(record):
    sec = sum(record["phases"].get(p, 0.0) for p in PHASES)
    return 100.0 * sec / record["window_s"] if sec else None
