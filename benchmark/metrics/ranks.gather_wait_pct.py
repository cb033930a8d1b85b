"""Share of the window that rank 0 spent inside the stage-a gather's
all_gather_object (workflows/savage.py:run_savage's
stage_a_gather_wait_s, summed over the window's samples): the wait for
the slowest rank's patch and the exchange. None where the program does
not record it."""


def read(record):
    sec = record["extra"].get("timings", {}).get("stage_a_gather_wait_s")
    return 100.0 * sec / record["window_s"] if sec is not None else None
