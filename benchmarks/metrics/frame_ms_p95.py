"""95th percentile (nearest rank) of every frame's wall time in the window,
in ms, from the call of `render()` to its return with the film on the host."""

from harness.timeline import percentile


def read(run):
    return 1e3 * percentile([e - s for s, e, _ in run.renders], 95.0)
