"""Share of the window spent in the iteration's verify phase
(assemble/iteration.py:run_iteration's PhaseTimer, spans/iteration.json)."""


def read(record):
    sec = record["phases"].get("verify")
    return 100.0 * sec / record["window_s"] if sec else None
