"""The medium-branch render's share of the card's FP32 peak in the traced
slice, %: the frozen work of the slice's camera paths, one LBVH walk per
closest-hit segment (`harness/walk_roofline.py`), over the slice's wall
time at 67 TFLOP/s. The stem reader (`render_mfu.py`) counts a sweep of
every triangle, the small branch's work, so this name has a reader of its
own. It bounds `pathk_medium_roofline` end to end."""

from harness.roofline import PEAK_FP32
from harness.walk_roofline import pathk_walk_work


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * pathk_walk_work(run.cell.config["work"], t.paths, t.pixels)[0] / (
        t.window_s * PEAK_FP32)
