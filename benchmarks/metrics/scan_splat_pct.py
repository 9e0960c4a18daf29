"""Share of the scan path's sample rounds whose splats took the kernel of
`csrc/film.cu` (one launch a chunk) in the traced slice, %: 100 × Σ
`scan.rounds_splatted` over Σ `scan.rounds` (`render.scan_step`'s rounds,
each one sample over every chunk). Both counters move only in traced
requests, which in a `--trace 1` run are the slice's renders; a program that
has the kernel counts `scan.rounds_splatted` in every traced round: 1 where
the round launched it (its `launch.film_splat` counter moved), else 0. A
program without that counter, or that counts no rounds, gives None. The
reader of `scan_splat_pct.scan`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None or run.trace is None or t.dropped:
        return None
    counts = t.counters("scan.rounds")
    rounds = counts.get("scan.rounds", 0)
    if "scan.rounds_splatted" not in counts or not rounds:
        return None
    return 100.0 * counts["scan.rounds_splatted"] / rounds
