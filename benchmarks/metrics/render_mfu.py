"""The path-kernel render's share of the card's FP32 peak in the traced
slice, %: the frozen work of the slice's camera paths (configuration
`work`: every segment's closest-hit sweep of every triangle and sphere,
the whole of what the path kernel computes by the yardstick) over the
slice's wall time at 67 TFLOP/s. It bounds `pathk_small_roofline` end to
end: a change that moves work off the kernel leaves the kernel's roofline
silent, not this. The reader of `render_mfu.<cell kind>` (`.offline`,
`.live`)."""

from harness.roofline import PEAK_FP32, pathk_work


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * pathk_work(run.cell.config["work"], t.paths, t.pixels)[0] / (
        t.window_s * PEAK_FP32)
