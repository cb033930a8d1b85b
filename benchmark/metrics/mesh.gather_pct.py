"""Share of the window spent in rank 0's gathers across ranks during
verification (parallel/mesh.py's phase mesh.gather inside the iteration's
verify phase, spans/iteration.json): the header and block gathers of
every verify call of stages b and c, with the copy to the host. None
where the program opens no such phase."""


def read(record):
    sec = record["phases"].get("mesh.gather")
    return 100.0 * sec / record["window_s"] if sec is not None else None
