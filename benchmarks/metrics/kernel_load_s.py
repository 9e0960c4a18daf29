"""Seconds of the program's first load of its CUDA library in the run (the
span `kernels.load`, recorded in every run): its build by nvcc in a
checkout's first run, then the load of the built library. Part of
`setup_s`."""

from harness import spans


def read(run):
    t = spans.tracer()
    if t is None:
        return None
    loads = [r for r in t.records() if r.name == "kernels.load"]
    return spans.ms(loads[0]) * 1e-3 if loads else None
