"""Delta and ratio tracking through voxel-grid media: the kernel's wrapper.

The CUDA counterpart of the two `lax.while_loop`s of the JAX package's
`ops/volume_grid.py` (`delta_track` :124 and `ratio_track` :202), which
have no Pallas kernel. `csrc/track.cu` walks every lane to its end in one
thread, then moves every lane's pcg32 state on by the lockstep loop's draws
(2·L or L, L its iteration count) by jump-ahead. Its plain versions, the
lockstep loops, are `ops/volume_grid.py: delta_track_ref / ratio_track_ref`,
which `ops/volume_grid.py: delta_track / ratio_track` run on CPU tensors;
this wrapper takes CUDA tensors only and launches the kernel or raises. It
adds one to `LAUNCHES[name]` where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.core.rng import Pcg32State
from optix_renderer_tpu_torch.ops.cuda import _build
from optix_renderer_tpu_torch.ops.cuda.isect import _ptr, refuse_graph

# kernel launches by the wrapper (each one walk and one advance)
LAUNCHES = {"delta_track": 0, "ratio_track": 0}


def _check(name, x, dtype, shape, device, align: int = 0):
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != device
            or not x.is_contiguous() or (align and x.data_ptr() % align)):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} tensor on {device}"
                         f"{f', {align}-byte aligned' if align else ''}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def track(ratio: bool, media, med_id, state: Pcg32State, ro, rd, t_max):
    """One tracking call on the card → (out [N] float32: t_event, +inf on
    escape, or T; K [N] int32 tentative collisions; the advanced
    `Pcg32State`; L [1] int32 on the device, the lockstep loop's
    iteration count). med_id [N] int32; ro, rd [N,3], t_max [N] float32;
    `media` the scene's `Media` on the same device."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"the tracking kernel runs on cuda tensors, got {dev}")
    n = ro.shape[0]
    if not 0 < n < 2**31:
        raise ValueError(f"the tracking kernel takes 1 to 2^31 - 1 lanes, got {n}")
    refuse_graph("the tracking kernel", ro, rd, t_max,
                 *(x for x in vars(media).values() if isinstance(x, torch.Tensor)))
    ro, rd, t_max, med_id = (x.contiguous() for x in (ro, rd, t_max, med_id))
    state = Pcg32State(*(x.contiguous() for x in state))
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)), ("t_max", t_max, (n,))):
        _check(name, x, torch.float32, shape, dev)
    _check("med_id", med_id, torch.int32, (n,), dev)
    for name, x in zip(Pcg32State._fields, state):
        _check(name, x, torch.int64, (n,), dev)
    n_med, n_vol = media.type.shape[0], media.vol_corners.shape[0]
    D, H, W = media.grid
    if n_vol == 0:
        raise ValueError("the tracking kernel needs a scene with voxel grids")
    for name, dtype, shape in (
            ("type", torch.int32, (n_med,)), ("sigma_a", torch.float32, (n_med, 3)),
            ("sigma_s", torch.float32, (n_med, 3)), ("density_scale", torch.float32, (n_med,)),
            ("vol_id", torch.int32, (n_med,)), ("vol_bbox_min", torch.float32, (n_vol, 3)),
            ("vol_bbox_max", torch.float32, (n_vol, 3)), ("vol_dims", torch.int32, (n_vol, 3)),
            ("vol_majorant", torch.float32, (n_vol,)),
            ("vol_corners", torch.float32, (n_vol, (D + 1) * (H + 1) * (W + 1), 8))):
        _check(f"media.{name}", getattr(media, name), dtype, shape, dev,
               16 if name == "vol_corners" else 0)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    k = torch.empty(n, dtype=torch.int32, device=dev)
    new_hi, new_lo = (torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2))
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load().track_launch(
            int(ratio), _ptr(ro), _ptr(rd), _ptr(t_max), _ptr(med_id), n,
            *(_ptr(x) for x in state),
            *(_ptr(getattr(media, f)) for f in ("type", "sigma_a", "sigma_s", "density_scale",
                                                "vol_id", "vol_bbox_min", "vol_bbox_max",
                                                "vol_dims", "vol_majorant", "vol_corners")),
            D, H, W, _ptr(out), _ptr(k), _ptr(new_hi), _ptr(new_lo), _ptr(iters),
            ctypes.c_void_p(stream))
    name = "ratio_track" if ratio else "delta_track"
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES[name] += 1
    return out, k, Pcg32State(new_hi, new_lo, state.inc_hi, state.inc_lo), iters
