"""A bounded slice of renders under `torch.profiler`, read from its trace.

The profiler has been seen to lose device events late in long runs, so the
slice is a few renders, and the reading refuses a trace in which a kernel
launch of the slice has no device event.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

from harness import timeline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")
ANNOTATION = "bench.render"


class TraceLost(RuntimeError):
    """The trace misses device events of launches it recorded."""


@dataclass
class TraceSlice:
    """What the per-layer readers read from a traced slice."""

    renders: int
    paths: float  # camera paths the slice's renders traced
    pixels: float  # pixel columns the slice's renders wrote
    window_s: float
    busy_s: float
    launches: int  # kernel and graph launch calls on the host side
    kernels: list = field(default_factory=list)  # [(name, device seconds)]
    breakdown: dict = field(default_factory=dict)

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """(Σ device seconds, count) of the kernels whose name holds `pattern`."""
        hits = [d for n, d in self.kernels if pattern in n]
        return sum(hits), len(hits)


def read_trace(events: list, renders: int, paths: float, pixels: float) -> TraceSlice:
    """Reduce chrome-trace events (µs) to a TraceSlice over the window from
    the first render annotation's start to the last one's end."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == ANNOTATION
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise TraceLost("the trace holds no render annotation")
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    inside = lambda e: w0 <= e["ts"] <= w1
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] + e.get("dur", 0) >= w0 and e["ts"] <= w1]
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in LAUNCH_NAMES and inside(e)]
    kernel_corr = {e.get("args", {}).get("correlation") for e in dev if e["cat"] == "kernel"}
    lost = [e for e in launches if e.get("args", {}).get("correlation") not in kernel_corr]
    if lost:
        raise TraceLost(f"{len(lost)} of {len(launches)} kernel launches in the traced slice "
                        "have no device event")
    busy, gaps = timeline.busy_and_gaps([(e["ts"], e["ts"] + e["dur"]) for e in dev], w0, w1)
    kernels = [(e["name"], e["dur"] * 1e-6) for e in dev if e["cat"] == "kernel"]

    by_op = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] * 1e-6
    # a gap goes to the host operation that started last before its middle
    host = sorted((e["ts"], e["name"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver") and inside(e))
    starts = [h[0] for h in host]
    by_gap = {}
    for s, e in gaps:
        i = bisect.bisect_right(starts, 0.5 * (s + e)) - 1
        name = host[i][1] if i >= 0 else "(nothing traced)"
        by_gap[name] = by_gap.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return TraceSlice(renders=renders, paths=paths, pixels=pixels, window_s=(w1 - w0) * 1e-6,
                      busy_s=busy * 1e-6, launches=len(launches), kernels=kernels,
                      breakdown={"device_ops": top(by_op), "idle_gaps": top(by_gap)})


def profile_renders(render_once, n: int, paths_per_render: float,
                    pixels_per_render: float) -> TraceSlice:
    """Run `render_once()` n times under the profiler, each inside a
    `bench.render` annotation, and read the slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(ANNOTATION):
                render_once()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_trace(events, n, paths_per_render * n, pixels_per_render * n)
