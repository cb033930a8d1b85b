"""Overlap verifications (scoring tasks) completed through
ops/verify.py:verify_overlaps in the window, over the window's seconds."""


def read(record):
    tasks = record["work"]["tasks"]
    return tasks / record["window_s"] if tasks else None
