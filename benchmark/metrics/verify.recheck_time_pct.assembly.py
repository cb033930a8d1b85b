"""Share of the window spent in the verification's f64 rechecks: the
verify.recheck phase that ops/verify.py:verify_overlaps opens inside the
verify phase of run_iteration's PhaseTimer (spans/iteration.json): the
near-threshold tasks, then the borderline overlaps and their re-combine.
None where the program opens no such phase."""


def read(record):
    sec = record["phases"].get("verify.recheck")
    return 100.0 * sec / record["window_s"] if sec else None
