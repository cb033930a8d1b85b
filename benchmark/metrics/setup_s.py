"""Set-up seconds: from the start of the process (imports, the CUDA
context, kernel builds or their cached libraries, the draws, the
candidates a cell prepares, the warm-up) to the opening of the window."""


def read(record):
    return record["setup_s"]
