"""Camera paths per second of the window, in millions: Σ pixels × spp of
every render over the time from the window's start to the end of its last
render (host clock; each render ends with the film on the host)."""

from harness.timeline import rate_per_s


def read(run):
    return rate_per_s(run.renders, run.window_start) / 1e6
