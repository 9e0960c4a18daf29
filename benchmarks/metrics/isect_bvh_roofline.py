"""`isect_bvh` (the kernels named `bvh_kernel`) against its roofline in the
traced slice, %: the frozen rays per render of each kind times the
skip-link yardstick's nodes and leaves per ray (configuration `work`),
over the kernels' device time."""

from harness.roofline import isect_bvh_work, share_pct


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds, n = t.kernel_seconds("bvh_kernel")
    if n == 0:
        return None
    return share_pct(*isect_bvh_work(run.cell.config["work"], t.renders), seconds)
