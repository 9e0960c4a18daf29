"""The path kernel's small branch (`pathk_kernel<MIS>`) against its
roofline in the traced slice, %: the frozen work of the slice's camera
paths (configuration `work`) over the kernels' device time. It reads
`pathk_small_roofline.live` too, the live cell's, which moves its frame
time."""

from harness.roofline import pathk_work, share_pct


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, n = t.kernel_seconds("pathk_kernel")
    if n == 0:
        return None
    return share_pct(*pathk_work(run.cell.config["work"], t.paths, t.pixels), seconds)
