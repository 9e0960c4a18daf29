"""The path kernel's medium branch (`pathk_staged_kernel<MIS>`) against its
roofline in the traced slice, %: the frozen work of the slice's camera
paths, one LBVH walk per closest-hit segment (`harness/walk_roofline.py`,
configuration `work`), over the kernels' device time."""

from harness.roofline import share_pct
from harness.walk_roofline import pathk_walk_work


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, n = t.kernel_seconds("pathk_staged_kernel")
    if n == 0:
        return None
    return share_pct(*pathk_walk_work(run.cell.config["work"], t.paths, t.pixels), seconds)
