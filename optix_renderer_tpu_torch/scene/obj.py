"""Wavefront OBJ loader → indexed numpy mesh.

Counterpart of the reference loader (src/shapes/obj.cpp:33-160): v/vt/vn
parsing, per-face-corner vertex dedup, quads split into two triangles as
(v1,v2,v3)+(v4,v1,v3), object-to-world transform applied at load time
(positions by the affine map, normals by rotation & renormalize).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from optix_renderer_tpu_torch.core import transform as tf


def load_obj(
    filename: str | Path, to_world: np.ndarray | None = None
) -> dict[str, np.ndarray]:
    """Returns dict with V [n,3] f32, F [t,3] i32, and optional N [n,3], UV [n,2].

    N/UV are per-vertex (deduped per unique v/vt/vn corner combination, like the
    reference's OBJVertex hashing).
    """
    positions: list[list[float]] = []
    texcoords: list[list[float]] = []
    normals: list[list[float]] = []
    corner_map: dict[tuple[int, int, int], int] = {}
    vert_corners: list[tuple[int, int, int]] = []
    indices: list[int] = []

    def corner_index(token: str) -> int:
        parts = token.split("/")
        p = int(parts[0])
        uv = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        key = (p, uv, n)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(vert_corners)
            corner_map[key] = idx
            vert_corners.append(key)
        return idx

    with open(filename, "r", errors="replace") as f:
        for line in f:
            if not line:
                continue
            c0 = line[0]
            if c0 == "v":
                tok = line.split()
                if tok[0] == "v":
                    positions.append([float(tok[1]), float(tok[2]), float(tok[3])])
                elif tok[0] == "vt":
                    texcoords.append([float(tok[1]), float(tok[2])])
                elif tok[0] == "vn":
                    normals.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif c0 == "f":
                tok = line.split()[1:]
                ci = [corner_index(t) for t in tok[:4]]
                indices += [ci[0], ci[1], ci[2]]
                if len(ci) == 4:
                    # quad → (v4, v1, v3), matching obj.cpp:134-139
                    indices += [ci[3], ci[0], ci[2]]

    P = np.asarray(positions, np.float64)
    if to_world is not None:
        P = tf.apply_point(to_world, P)

    n_verts = len(vert_corners)
    V = np.zeros((n_verts, 3), np.float32)
    has_uv = len(texcoords) > 0
    has_n = len(normals) > 0
    UV = np.zeros((n_verts, 2), np.float32) if has_uv else None
    N = np.zeros((n_verts, 3), np.float32) if has_n else None

    TC = np.asarray(texcoords, np.float32) if has_uv else None
    NN = np.asarray(normals, np.float64) if has_n else None
    if has_n and to_world is not None:
        NN = tf.apply_normal(to_world, NN)
        NN = NN / np.maximum(np.linalg.norm(NN, axis=-1, keepdims=True), 1e-20)

    used_n = False
    used_uv = False
    for i, (pi, uvi, ni) in enumerate(vert_corners):
        V[i] = P[pi - 1]
        if has_uv and uvi != 0:
            UV[i] = TC[uvi - 1]
            used_uv = True
        if has_n and ni != 0:
            N[i] = NN[ni - 1]
            used_n = True

    out = {
        "V": V,
        "F": np.asarray(indices, np.int32).reshape(-1, 3),
    }
    if has_n and used_n:
        out["N"] = N
    if has_uv and used_uv:
        out["UV"] = UV
    return out
