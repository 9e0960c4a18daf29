"""Probe of flag-guarded bulk copies on Hopper:
`python -m optix_renderer_tpu_torch.tools.probe_copy` (needs a CUDA GPU).

Counterpart of `tools/probe_mosaic.py` (its Pallas kernel `kern`, :13-45,
called at :50), which probes what a culled cluster sweep needs: C = 16
cluster flags (c % 2) stored at dynamic indices, then, for each cluster
whose flag is set, a copy of slab `sel[c]` of x [C, 64, 1024] into fast
memory and its sum over rows. The output [8, 1024] holds the accumulated
sum in every row. `probe_copy_ref` is the plain torch version.

The kernel `csrc/probes.cu: probe_copy_kernel` spreads the 2 MB of flagged
slabs over the card and keeps every copy in flight at once: one CTA per
(64-column tile, flagged slab), 128 CTAs, each copying its [64, 64] tile
into shared memory with one TMA tensor copy (`cp.async.bulk.tensor`, the
slab index a coordinate of x's tensor map) that completes on an mbarrier,
then summing its rows. The 8 CTAs of a column tile are one thread-block
cluster: they add their partial sums in c order through distributed
shared memory, and rank k writes output row k. `probe_copy_tiled` is that decomposition as plain
torch; it equals `probe_copy_ref` bit for bit. The script prints the error
against the probe's own numpy reference (`probe_mosaic.py:69-74`) and
"PROBE OK" or "PROBE MISMATCH".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from optix_renderer_tpu_torch.utils import tracing

C, CS, W = 16, 64, 1024
OUT_ROWS = 8
# the kernel's column tile, and its CTAs: one per (tile, flagged slab)
TILE_COLS = 64
CTAS = W // TILE_COLS * C // 2


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


def probe_copy_tiled(x, sel):
    """The kernel's decomposition as plain torch: for each column tile and
    each flagged slab, the tile's rows added in turn (a partial sum); then
    each tile's partials added in c order. Equals `probe_copy_ref` bit for
    bit: both add in the same order."""
    flagged = [c for c, flag in enumerate(flags()) if flag]
    out = torch.empty((OUT_ROWS, W), dtype=torch.float32, device=x.device)
    for col0 in range(0, W, TILE_COLS):
        parts = []
        for c in flagged:
            tile = x[int(sel[c]), :, col0:col0 + TILE_COLS]
            s = torch.zeros(tile.shape[1], dtype=torch.float32, device=x.device)
            for r in range(CS):
                s = s + tile[r]
            parts.append(s)
        acc = torch.zeros_like(parts[0])
        for s in parts:
            acc = acc + s
        out[:, col0:col0 + TILE_COLS] = acc
    return out


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


def _launch(x, sel, out, info=None) -> None:
    """Launch the kernel on tensors `probe_copy` has checked (timed alone by
    chip_smoke.py: the check of `sel` waits for the device). `info`: an
    optional int32 [CTAS, 2] on the device that receives each CTA's SM and
    its cluster's CTA count."""
    from optix_renderer_tpu_torch.ops.cuda import _build

    if info is not None and (info.shape != (CTAS, 2) or info.dtype != torch.int32
                             or info.device != x.device or not info.is_contiguous()):
        raise ValueError(f"info must be a contiguous int32 [{CTAS}, 2] on {x.device}")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.load().probe_copy_launch(ptr(x), ptr(sel), ptr(out), ptr(info),
                                             ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe_copy kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    tracing.count("launch.probe_copy")  # launches by the kernel, not by the plain version


def empty_launch(device) -> None:
    """Launch an empty kernel in the kernel's grid and clusters: the
    latency floor of a launch of that shape."""
    from optix_renderer_tpu_torch.ops.cuda import _build

    with torch.cuda.device(device):
        rc = _build.load().probe_empty_launch(
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")


def torch_yardstick(x, sel):
    """The same sum in a few torch calls (index_select, then two sums over
    other orders): a yardstick of time, not of the result's bits. The
    flagged clusters are the odd c (`flags`), so their slabs are
    sel[1::2], a view that needs no copy from the host."""
    return x.index_select(0, sel[1::2]).sum(dim=1).sum(dim=0).expand(OUT_ROWS, W)


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
