"""Share of the window spent reconsidering FNO1's stored non-edge overlaps:
the fno.nonedges phase that assemble/fno.py:FNO1._reconsider_nonedges opens
inside the fno phase of run_iteration's PhaseTimer (spans/iteration.json):
the ids' lookup, the edge check, the pseudo-edge rows and their batch.
None where the program opens no such phase."""


def read(record):
    sec = record["phases"].get("fno.nonedges")
    return 100.0 * sec / record["window_s"] if sec else None
