"""Share of the window spent in SAVAGE's stages b and c on rank 0, with
their candidates and abundance filters (workflows/savage.py:run_savage's
timings, summed over the window's samples). None where the program
records none of them."""

KEYS = ("stage_b_candidates_s", "stage_b_s", "stage_b_filter_s",
        "stage_c_candidates_s", "stage_c_s", "stage_c_filter_s")


def read(record):
    timings = record["extra"].get("timings", {})
    secs = [timings[k] for k in KEYS if k in timings]
    return 100.0 * sum(secs) / record["window_s"] if secs else None
