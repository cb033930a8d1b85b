"""The score_tasks kernel's share of its roofline: the least time the
card could take for the window's tasks (benchlib/roofline.py, bytes at
3.35 TB/s or f32 adds at 67 TFLOP/s, whichever is longer) over the
kernel's device time in the traced window."""


def read(record):
    trace = record.get("trace") or {}
    kernel = sum(v for k, v in trace.get("kernel_s", {}).items() if "score_tasks" in k)
    bound_ms = record["extra"].get("bound_ms")
    return 100.0 * bound_ms * 1e-3 / kernel if kernel and bound_ms else None
