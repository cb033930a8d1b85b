"""Reads assembled in the window over the window's seconds: every read of
every unit (a whole assembly) the window started, over the time until the
last one completed."""


def read(record):
    reads = record["work"]["reads"]
    return reads / record["window_s"] if reads else None
