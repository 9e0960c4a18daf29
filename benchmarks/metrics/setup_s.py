"""Seconds from the start of the run's process (the first line of
`run.py`) to the first timed request: imports, the card's start, the
kernels' build or load, writing and loading the scene on the card, and
the warm-up request."""


def read(run):
    return run.setup_s
