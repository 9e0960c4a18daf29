"""Kernel and graph launch calls on the host (the profiler's
cudaLaunchKernel*, cuLaunchKernel*, cudaGraphLaunch events) per sample
per pixel of the traced slice: an exact count. The reader of
`host_launches_per_spp.scan`."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return t.launches / (t.renders * run.spp)
