"""Share of the scan path's lanes still alive at the start of a bounce, %:
100 × Σ `scan.lanes_live` (the active lanes, summed on the card) over Σ
`scan.lanes` (the lanes every bounce pays for). Both counters move only in
traced requests, which in a `--trace 1` run are the slice's renders. Dead
lanes run every bounce to its end, so the rest is wasted work. The reader
of `live_lane_pct.scan`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    lanes = t.counter("scan.lanes")
    return 100.0 * t.counter("scan.lanes_live") / lanes if lanes else None
