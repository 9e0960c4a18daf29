"""Probe of flag-guarded bulk copies on Hopper:
`python -m optix_renderer_tpu_torch.tools.probe_copy` (needs a CUDA GPU).

Counterpart of `tools/probe_mosaic.py` (its Pallas kernel `kern`, :13-45,
called at :50), which probes what a culled cluster sweep needs: C = 16
cluster flags (c % 2) stored at dynamic indices, then, for each cluster
whose flag is set, a copy of slab `sel[c]` of x [C, 64, 1024] into fast
memory and its sum over rows. The output [8, 1024] holds the accumulated
sum in every row. The kernel `csrc/probes.cu: probe_copy_kernel` does this
with shared-memory flags and TMA bulk copies (`cp.async.bulk`) completing on
an mbarrier; `probe_copy_ref` is its plain torch version. The script prints
the error against the probe's own numpy reference (`probe_mosaic.py:69-74`)
and "PROBE OK" or "PROBE MISMATCH".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

C, CS, W = 16, 64, 1024
OUT_ROWS = 8

# kernel launches by `probe_copy` (not by the plain version)
LAUNCHES = 0


def make_inputs(device="cpu"):
    """x [C, CS, W] = arange · 1e-6 and sel = C − 1 − c (probe_mosaic.py:47-48)."""
    x = torch.arange(C * CS * W, dtype=torch.float32, device=device).reshape(C, CS, W) * 1e-6
    sel = torch.arange(C - 1, -1, -1, dtype=torch.int32, device=device)
    return x, sel


def flags() -> list[int]:
    return [c % 2 for c in range(C)]


def probe_copy_ref(x, sel):
    """Plain version: the kernel's sums in its order (rows of a slab added in
    turn, then the slab's sum added to the running total)."""
    acc = torch.zeros(W, dtype=torch.float32, device=x.device)
    for c, flag in enumerate(flags()):
        if flag:
            slab = x[int(sel[c])]
            s = slab[0]
            for r in range(1, CS):
                s = s + slab[r]
            acc = acc + s
    return acc.expand(OUT_ROWS, W).contiguous()


def reference_np(x: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """The probe's own numpy reference (probe_mosaic.py:69-74), row 0."""
    ref = np.zeros(W, np.float32)
    for c in range(C):
        if c % 2 == 1:
            ref += x[sel[c]].sum(axis=0)
    return ref


def probe_copy(x, sel):
    """[8, W] float32 on x's device: the plain version for CPU tensors, the
    kernel for CUDA tensors (or raise)."""
    if x.device.type == "cpu":
        return probe_copy_ref(x, sel)
    if x.device.type != "cuda":
        raise ValueError(f"probe_copy runs on cpu or cuda tensors, got {x.device}")
    if (x.shape != (C, CS, W) or x.dtype != torch.float32 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"x must be a contiguous, 16-byte aligned float32 {(C, CS, W)} tensor")
    if sel.shape != (C,) or sel.dtype != torch.int32 or sel.device != x.device:
        raise ValueError(f"sel must be int32 [{C}] on {x.device}")
    if not (0 <= int(sel.min()) and int(sel.max()) < C):
        raise ValueError(f"sel must index the {C} slabs")
    out = torch.empty((OUT_ROWS, W), dtype=torch.float32, device=x.device)
    _launch(x, sel.contiguous(), out)
    return out


def _launch(x, sel, out) -> None:
    """Launch the kernel on tensors `probe_copy` has checked (timed alone by
    chip_smoke.py: the check of `sel` waits for the device)."""
    global LAUNCHES
    from optix_renderer_tpu_torch.ops.cuda import _build

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.load().probe_copy_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(sel.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe_copy kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES += 1


def run(device) -> dict:
    """One probe on `device`: (row 0 of the kernel's output, the numpy
    reference, max |error|, reference scale, whether all 8 rows agree)."""
    x, sel = make_inputs(device)
    out = probe_copy(x, sel)
    got = out.cpu().numpy()
    ref = reference_np(x.cpu().numpy(), sel.cpu().numpy())
    return {"got": got[0], "ref": ref, "max_err": float(np.abs(got[0] - ref).max()),
            "scale": float(np.abs(ref).max()), "rows_equal": bool((got == got[0]).all())}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_copy needs a CUDA GPU (torch.cuda.is_available() is False)")
    r = run(torch.device("cuda", 0))
    print("max err:", r["max_err"], "ref scale:", r["scale"])
    ok = r["rows_equal"] and r["max_err"] < 1e-6 * max(1.0, r["scale"])
    print("PROBE OK" if ok else "PROBE MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
