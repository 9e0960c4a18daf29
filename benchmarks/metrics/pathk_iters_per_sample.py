"""The path kernel's loop iterations per sample in the traced slice: Σ
`pathk.iterations` (each launch's row 10, the pixels' loop iterations,
summed on the card) over Σ `pathk.samples` (pixels × samples of each
launch). An iteration walks one closest-hit segment and resolves the
shadow ray queued by the one before, so this is the work per path that the
frozen `segments_per_path` assumes, measured. Both counters move only in
traced requests, which in a `--trace 1` run are the slice's renders. A
program that counts no samples gives None. The reader of
`pathk_iters_per_sample.medium`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    samples = t.counter("pathk.samples")
    return t.counter("pathk.iterations") / samples if samples else None
