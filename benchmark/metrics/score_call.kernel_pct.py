"""Share of the scoring call's host wall (the benchmark's span around
ops/score.py:score_tasks_torch where ops/verify.py calls it,
spans/score_call.json) that the score_tasks kernel ran on the device
(profiler, kernels by name)."""


def read(record):
    trace = record.get("trace") or {}
    kernel = sum(v for k, v in trace.get("kernel_s", {}).items() if "score_tasks" in k)
    call = record["spans"].get("score_call")
    return 100.0 * kernel / call if kernel and call else None
