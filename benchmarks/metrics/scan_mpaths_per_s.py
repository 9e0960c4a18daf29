"""`mpaths_per_s` of the scan-path cells, a metric of its own so that its
bound, set from the host-paced renders' spread, leaves the card-paced
cells' bound as it is."""

from harness.timeline import rate_per_s


def read(run):
    return rate_per_s(run.renders, run.window_start) / 1e6
