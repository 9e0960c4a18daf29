"""The program's own spans and counters, as the per-layer readers read them.

The program records them in memory (`optix_renderer_tpu_torch.utils.tracing`):
a span per layer boundary of a request, with its request, parent, name,
start and end on the host's clock, and counters. A request is traced while
the profiler records, so in a `--trace 1` run only the traced slice's
renders are, and the last `run.trace.renders` root spans named `render` are
exactly the slice's; the warm-up and the window run with tracing off. The
set-up span `kernels.load` is recorded in every run.

A checkout whose program has no tracer, a run without a traced slice, or a
slice whose records were dropped gives None, and the reader's metric is left
out of the result line.
"""

from __future__ import annotations


def tracer():
    """The program's tracing module, or None where the program has none."""
    try:
        from optix_renderer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def slice_records(run):
    """(records of the slice's renders, their root spans), or None."""
    t = tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    recs = t.records()
    roots = [r for r in recs if r.name == "render" and r.parent == 0][-run.trace.renders:]
    if len(roots) < run.trace.renders:
        return None
    requests = {r.request for r in roots}
    return [r for r in recs if r.request in requests], roots


def ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6
