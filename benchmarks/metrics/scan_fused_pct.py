"""Share of the scan path's sample rounds whose bounces shaded in the kernel
of `csrc/scan.cu` (one launch a bounce) in the traced slice, %: 100 × Σ
`scan.rounds_fused` over Σ `scan.rounds` (`render.scan_step`'s rounds, each
one sample over every chunk). Both counters move only in traced requests,
which in a `--trace 1` run are the slice's renders; a program that shades
in the kernel counts `scan.rounds_fused` in every traced round (0 where the
round ran the torch chain). A program without that counter, or that counts
no rounds, gives None. The reader of `scan_fused_pct.scan`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    counts = t.counters("scan.rounds")
    rounds = counts.get("scan.rounds", 0)
    if "scan.rounds_fused" not in counts or not rounds:
        return None
    return 100.0 * counts["scan.rounds_fused"] / rounds
