"""The yardstick of the path kernel's medium branch: an LBVH walk per segment.

`roofline.pathk_work` counts a sweep of every triangle per segment, which is
the small branch's algorithm. The medium branch (`pathk_staged_kernel`,
65–8,192 triangles) walks the scene's LBVH instead, so a closest-hit segment
costs the skip-link walk's nodes and leaves per ray, counted on the
configuration's own camera and bounce rays (its `work.walk`), as
chip_smoke.py phase 12 counts them: nodes × 25 + leaves × 4 × 53 + 9 for
the walk, the spheres' tests and 5 for the segment. The shadow rays'
any-hit walks are left out, so the count is a lower bound.
"""

from __future__ import annotations

from harness.roofline import OPS_SPHERE, bvh_ray_ops


def segment_ops(work: dict) -> float:
    """Operations of one closest-hit segment of the medium branch."""
    walk = work["walk"]
    return (bvh_ray_ops(walk["nodes_per_ray"], walk["leaves_per_ray"])
            + work["spheres"] * OPS_SPHERE + 5)


def pathk_walk_work(work: dict, paths: float, pixels: float) -> tuple[float, float]:
    """(operations, bytes) of medium-branch renders of `paths` camera paths
    over `pixels` pixel columns written: one walk per closest-hit segment."""
    return paths * work["segments_per_path"] * segment_ops(work), pixels * work["pathk_out_bytes"]
