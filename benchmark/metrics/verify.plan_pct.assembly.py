"""Share of the window spent planning the verification's tasks: the
verify.plan phase that ops/verify.py:verify_overlaps opens inside the
verify phase of run_iteration's PhaseTimer (spans/iteration.json): the
backend check, plan_tasks' id lookups and task arrays, the row lengths.
None where the program opens no such phase."""


def read(record):
    sec = record["phases"].get("verify.plan")
    return 100.0 * sec / record["window_s"] if sec else None
