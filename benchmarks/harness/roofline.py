"""The yardstick: published peaks and the work the inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in FP32 outside the tensor cores, 3.35 TB/s of HBM.
The operation counts are the repository's (chip_smoke.py `bound()`,
tools/time_isect.py), frozen here: an FMA counts two operations, the
kernels are built without contraction.
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_MT = 52  # one Möller–Trumbore test
OPS_SPHERE = 39  # one ray–sphere test
OPS_SLAB = 25  # one node's slab test
OPS_RAY = 9  # a ray's direction reciprocal
RAY_BYTES = 48  # o, d, mint, cutoff in; id, t, u, v out


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(ops: float, nbytes: float, seconds: float) -> float:
    """The bound over the time taken, in %."""
    return 100.0 * bound_s(ops, nbytes)[0] / seconds


def pathk_work(work: dict, paths: float, pixels: float) -> tuple[float, float]:
    """(operations, bytes) of path-kernel renders of `paths` camera paths
    over `pixels` pixel columns written: every segment sweeps every
    triangle and sphere once (the closest hit), at least."""
    per_segment = work["triangles"] * OPS_MT + work["spheres"] * OPS_SPHERE + 5
    return paths * work["segments_per_path"] * per_segment, pixels * work["pathk_out_bytes"]


def bvh_ray_ops(nodes: float, leaves: float) -> float:
    """Operations of one ray's walk by the skip-link yardstick."""
    return nodes * OPS_SLAB + leaves * 4 * (OPS_MT + 1) + OPS_RAY


def isect_bvh_work(work: dict, renders: float) -> tuple[float, float]:
    """(operations, bytes) of `renders` renders' `isect_bvh` calls: for each
    kind of ray, the rays a render casts times the yardstick's nodes and
    leaves per ray of that kind."""
    ops = nbytes = 0.0
    for kind in work["isect_bvh"].values():
        ops += kind["rays_per_render"] * bvh_ray_ops(kind["nodes_per_ray"], kind["leaves_per_ray"])
        nbytes += kind["rays_per_render"] * RAY_BYTES
    return ops * renders, nbytes * renders
