"""Share of the scan path's sample rounds that replayed a captured CUDA graph
in the traced slice, %: 100 × Σ `scan.rounds_graphed` over Σ `scan.rounds`
(`render.scan_step`'s rounds, each one sample over every chunk). Both
counters move only in traced requests, which in a `--trace 1` run are the
slice's renders. A program that counts no rounds gives None. The reader of
`scan_graph_pct.scan`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    rounds = t.counter("scan.rounds")
    return 100.0 * t.counter("scan.rounds_graphed") / rounds if rounds else None
