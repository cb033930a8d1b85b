"""Share of the tasks scored on the card that ops/verify.py re-scored in
f64 near a threshold (BACKEND_COUNTS["recheck"] over the "torch" and
"mesh" counts, over the window). A count: it repeats exactly for a seed."""


def read(record):
    c = record["counters"]
    scored = c.get("tasks_torch", 0) + c.get("tasks_mesh", 0)
    return 100.0 * c.get("tasks_recheck", 0) / scored if scored else None
