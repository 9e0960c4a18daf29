"""4x4 homogeneous transforms (numpy, scene-build time only).

Counterpart of the reference `Transform` (include/nori/transform.h) and the
parser's transform accumulation (src/utils/parser.cpp:302-360). Transforms are
applied when lowering the scene to flat arrays — world-space geometry is
precomputed so render-time kernels never multiply by 4x4 matrices per ray
(the reference bakes transforms into OptiX instance matrices similarly).
Uses numpy: this runs at scene-load, not in jit.
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(v) -> np.ndarray:
    m = identity()
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg: float) -> np.ndarray:
    """Rotation about `axis` by degrees (parser.cpp:330-339 uses Eigen AngleAxis)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(angle_deg)
    c, s = np.cos(t), np.sin(t)
    x, y, z = a
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = identity()
    m[:3, :3] = r
    return m


def lookat(origin, target, up) -> np.ndarray:
    """Camera-to-world from origin/target/up (parser.cpp:341-357).

    Matches the reference: dir = normalize(target-origin), left = normalize(up×dir),
    newUp = dir×left; columns = [left, newUp, dir, origin] — note the reference's
    left-handed-ish convention with +z forward and `left` on +x.
    """
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dir_ = target - origin
    dir_ = dir_ / np.linalg.norm(dir_)
    left = np.cross(up / np.linalg.norm(up), dir_)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dir_, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dir_
    m[:3, 3] = origin
    return m


def apply_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform points [..., 3] (with translation + perspective divide)."""
    p = np.asarray(p, np.float64)
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return r / w[..., None]


def apply_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.asarray(v, np.float64) @ m[:3, :3].T


def apply_normal(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose (transform.h)."""
    inv = np.linalg.inv(m[:3, :3])
    return np.asarray(n, np.float64) @ inv
