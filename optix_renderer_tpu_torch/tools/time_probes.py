"""Device time of the two probe kernels (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_probes.py [--root DIR] [--reps N]

`probe_copy` (`tools/probe_copy.py`) on the probe's inputs: the kernel
behind a spin and alone (`alone_ms`, torch.profiler), and the whole wrapper call
(which waits for the device to check `sel`); `iter_cost`
(`tools/prof_parts.py`) in each mode at 64 and 1,024 iterations, with the
marginal cost per iteration of the launch, per group-iteration and per
lane-iteration, then the card's clocks, performance state and power
draw beside `probe_copy`. Where the timed package has them, also the latency floor
(an empty kernel in `probe_copy`'s grid and clusters), the torch yardstick
of `probe_copy` (a few torch calls that add in other orders), the SMs each
kernel's CTAs ran on and their cluster size, and the issue limit of the
`isect` loop. For every package, ptxas' registers and spills and the
instructions per lane-triangle of the `isect` loop in the built library's
SASS (`time_isect.py: sweep_loops`). Every timed kernel is first held
against its plain version, bit for bit (`torch.equal`; `iter_cost` at 64
iterations).

Kernel times are device time: CUDA events around each launch behind a
spin (`time_isect.py: device_ms`), `reps` launches after a warm-up, their
median and each of them; the wrapper call is the mean of `reps` calls in a
row. `--root` imports the package from another checkout (for instance a
parent commit unpacked with `git archive`), so that two versions can be
timed in one run on one card:

    for r in .ab/parent . . .ab/parent; do
        python3 optix_renderer_tpu_torch/tools/time_probes.py --root $r --reps 7; done

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def alone_ms(fn, reps: int, kernel: str) -> float:
    """Device time in ms per call of the CUDA kernels whose name holds
    `kernel`, from torch.profiler over `reps` calls of `fn()` queued behind
    a ~10 ms spin kernel (`torch.cuda._sleep`, left out of the sum), after a
    warm-up: the launches run back to back, so the time is the kernels'
    alone, without the gaps of the host's enqueueing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key
               and "spin_kernel" not in e.key) / 1e3 / reps


def _median(ms: list[float]) -> dict:
    return {"ms_median": float(np.median(ms)), "ms_each": ms}


def _sms(info) -> dict:
    """Distinct SMs and cluster sizes from an int32 [CTAs, 2] info tensor."""
    rows = info.cpu().numpy()
    return {"ctas": int(rows.shape[0]), "sms": int(len(set(rows[:, 0].tolist()))),
            "cluster_ctas": sorted(set(rows[:, 1].tolist()))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose optix_renderer_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_probes needs a CUDA GPU (torch.cuda.is_available() is False)")
    from optix_renderer_tpu_torch.ops.cuda import _build
    from optix_renderer_tpu_torch.tools import probe_copy, prof_parts
    from optix_renderer_tpu_torch.tools.time_isect import (
        device_ms,
        library_sass,
        ptxas_report,
        sweep_loops,
    )

    if not Path(prof_parts.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise SystemExit(f"imported {prof_parts.__file__}, not the package under {args.root}")
    dev = torch.device("cuda", 0)
    query = lambda what: subprocess.run(
        ["nvidia-smi", f"--query-gpu={what}", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    smi = query("name,power.limit")
    _build.load()
    sass = library_sass(_build.library_path())
    res = {"root": args.root, "gpu": smi,
           "ptxas": {k: v for k, v in ptxas_report(_build.last_build.get("ptxas", "")).items()
                     if "probes" in k},
           "isect_loops": sweep_loops(sass, "iter_cost_kernelILi3E")}
    new = "info" in inspect.signature(probe_copy._launch).parameters

    # ---- iter_cost (first: its long launches bring the card to its working clock
    # before probe_copy's launches of a few microseconds)
    x, tri = prof_parts.make_inputs(dev)
    ic = {}
    for mode in prof_parts.MODES:
        ref = prof_parts.iter_cost_ref(x, tri, 64, mode)
        got = prof_parts.iter_cost(x, tri, 64, mode)
        if not torch.equal(got, ref):
            raise AssertionError(f"iter_cost {mode}: max err {float((got - ref).abs().max())}")
        r = {"ms": {}}
        for n in prof_parts.ITERS:
            each = device_ms(lambda n=n: prof_parts.iter_cost(x, tri, n, mode), args.reps)
            r["ms"][n] = float(np.median(each))
            r[f"ms_each_{n}"] = each
        per_iter = (r["ms"][1024] - r["ms"][64]) / 960 * 1e3
        r.update(us_per_iter=per_iter, us_per_block_iter=per_iter / prof_parts.NB,
                 ns_per_lane_iter=per_iter * 1e3 / (prof_parts.NB * prof_parts.LANES))
        if new:
            info = torch.zeros((prof_parts.NB * prof_parts.CTAS, 2), dtype=torch.int32,
                               device=dev)
            prof_parts.iter_cost(x, tri, 64, mode, info=info)
            r.update(_sms(info))
        ic[mode] = r
    if new and (per_pair := prof_parts.isect_per_pair(sass)):
        ic["isect"].update(per_pair=per_pair,
                           issue_limit_ms={n: prof_parts.issue_limit_ms(per_pair, n)
                                           for n in prof_parts.ITERS})
    res["iter_cost"] = ic
    # ---- probe_copy, with the card's clocks and performance state beside it
    res["clocks_before_probe_copy"] = query("clocks.sm,clocks.mem,pstate,power.draw")
    x, sel = probe_copy.make_inputs(dev)
    ref = probe_copy.probe_copy_ref(x, sel)
    out = torch.zeros_like(ref)
    launch = lambda: probe_copy._launch(x, sel, out)
    launch()
    if not torch.equal(out, ref):
        raise AssertionError(f"probe_copy: max err {float((out - ref).abs().max())}")
    pc = {"kernel": {**_median(device_ms(launch, args.reps)),
                     "kernel_ms": alone_ms(launch, args.reps, "probes")}}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe_copy.probe_copy(x, sel)
    ev[0].record()
    for _ in range(args.reps):
        probe_copy.probe_copy(x, sel)
    ev[1].record()
    torch.cuda.synchronize()
    pc["wrapper_ms_mean"] = ev[0].elapsed_time(ev[1]) / args.reps
    if new:
        info = torch.zeros((probe_copy.CTAS, 2), dtype=torch.int32, device=dev)
        probe_copy._launch(x, sel, out, info=info)
        pc["kernel"].update(_sms(info))
        empty = lambda: probe_copy.empty_launch(dev)
        pc["latency_floor"] = {**_median(device_ms(empty, args.reps)),
                               "kernel_ms": alone_ms(empty, args.reps, "probes")}
        pc["torch_yardstick_ms"] = alone_ms(lambda: probe_copy.torch_yardstick(x, sel),
                                            args.reps, "")
    res["probe_copy"] = pc
    res["clocks_after_probe_copy"] = query("clocks.sm,clocks.mem,pstate,power.draw")

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
