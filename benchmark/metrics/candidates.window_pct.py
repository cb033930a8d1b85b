"""Share of the window spent in the candidate engines (the benchmark's
span around workflows/savage.py:denovo_candidates and
workflows/polyte.py:single_end_candidates, spans/candidates.json)."""


def read(record):
    sec = record["spans"].get("candidates")
    return 100.0 * sec / record["window_s"] if sec else None
