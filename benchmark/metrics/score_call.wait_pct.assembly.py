"""Share of the window the scoring call spends in its score.device phase
(ops/score.py:score_tasks_torch, inside the verify phase of
run_iteration's PhaseTimer, spans/iteration.json): the task columns'
upload, the launch and the host's wait for the sums. None where the
program opens no such phase."""


def read(record):
    sec = record["phases"].get("score.device")
    return 100.0 * sec / record["window_s"] if sec else None
