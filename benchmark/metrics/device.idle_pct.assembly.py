"""Share of the traced window in which no kernel, copy or memset ran on
the device (torch.profiler, the union of device intervals)."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
