"""Share of the window spent in SAVAGE's abundance filters after stages b
and c on rank 0 (workflows/savage.py:run_savage's stage_b_filter_s and
stage_c_filter_s, summed over the window's samples): the contig index,
the classification of the rank's reads, the gather of the ranks' classes
and the EM. None where the program records neither."""

KEYS = ("stage_b_filter_s", "stage_c_filter_s")


def read(record):
    timings = record["extra"].get("timings", {})
    secs = [timings[k] for k in KEYS if k in timings]
    return 100.0 * sum(secs) / record["window_s"] if secs else None
