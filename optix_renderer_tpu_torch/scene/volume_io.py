"""Volume-grid loading: .vdb (OpenVDB), .npz/.npy dense grids, procedural.

This package's copy of `optix_renderer_tpu/scene/volume_io.py` (it imports
nothing of that package). Counterpart of the reference's NvdbVolume loader
(src/textures/NvdbVolume.cpp, NvdbVolume.vdb.cpp: loads .nvdb directly or
converts .vdb → NanoVDB with an mtime-invalidated cache). Here every source
is densified to a numpy grid (the renderer keeps dense corner stacks, not
sparse trees):

- `.vdb`  — pure-Python OpenVDB reader (scene/vdb.py) for float 5_4_3 trees,
            with the same `.npz` conversion cache + mtime invalidation as the
            reference's .vdb→.nvdb cache (NvdbVolume.vdb.cpp:9-38);
- `.npz`  — keys: density [D,H,W] (required), temperature [D,H,W],
            bbox_min [3], bbox_max [3];
- `.npy`  — density only, unit-cube bbox.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class VolumeGrid:
    density: np.ndarray  # [D,H,W] float32, (z,y,x) index order
    temperature: np.ndarray | None
    bbox_min: np.ndarray  # [3] world-space
    bbox_max: np.ndarray  # [3]


def load_volume(path) -> VolumeGrid:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npz":
        d = np.load(path)
        density = np.asarray(d["density"], np.float32)
        temperature = (
            np.asarray(d["temperature"], np.float32) if "temperature" in d else None
        )
        bbox_min = np.asarray(d.get("bbox_min", np.zeros(3)), np.float32)
        bbox_max = np.asarray(d.get("bbox_max", np.ones(3)), np.float32)
        return VolumeGrid(density, temperature, bbox_min, bbox_max)
    if suffix == ".npy":
        density = np.asarray(np.load(path), np.float32)
        return VolumeGrid(
            density, None, np.zeros(3, np.float32), np.ones(3, np.float32)
        )
    if suffix == ".vdb":
        return _load_vdb_cached(path)
    raise ValueError(f"unsupported volume format: {path}")


def _cache_root() -> Path:
    import os

    base = os.environ.get("ORT_CACHE_DIR") or str(
        Path.home() / ".cache" / "optix_renderer_tpu_torch"
    )
    d = Path(base) / "vdb"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _load_vdb_cached(path: Path) -> VolumeGrid:
    """.vdb → dense grids, cached as .npz in the user cache dir
    (ORT_CACHE_DIR or ~/.cache/optix_renderer_tpu_torch/vdb), keyed by the source
    path and invalidated by source mtime — the same scheme as the reference's
    .vdb→.nvdb conversion cache (NvdbVolume.vdb.cpp:9-38), but NEVER written
    beside the source: scene trees may be read-only or foreign checkouts."""
    import hashlib

    mtime = path.stat().st_mtime_ns
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:16]
    cache = _cache_root() / f"{path.stem}-{tag}.npz"
    if cache.exists():
        d = np.load(cache)
        if int(d.get("mtime", -1)) == mtime:
            temp = d["temperature"] if "temperature" in d else None
            if temp is not None and temp.size == 0:
                temp = None
            return VolumeGrid(
                d["density"].astype(np.float32),
                temp,
                d["bbox_min"].astype(np.float32),
                d["bbox_max"].astype(np.float32),
            )

    from optix_renderer_tpu_torch.scene import vdb

    grids = vdb.read_vdb(path)
    if "density" not in grids:
        raise ValueError(
            f"{path}: no 'density' float grid (found: {sorted(grids)})"
        )
    den = grids["density"]
    temp = grids.get("temperature")
    out = VolumeGrid(
        density=den.values,
        temperature=temp.values if temp is not None else None,
        bbox_min=den.bbox_min_world,
        bbox_max=den.bbox_max_world,
    )
    try:
        np.savez_compressed(
            cache,
            mtime=mtime,
            density=out.density,
            temperature=out.temperature if out.temperature is not None else np.zeros(0),
            bbox_min=out.bbox_min,
            bbox_max=out.bbox_max,
        )
    except OSError:
        pass
    return out


def make_procedural_fog(res: int = 64, kind: str = "sphere") -> VolumeGrid:
    """Procedural test volumes (sphere falloff / noise-ish shells)."""
    z, y, x = np.mgrid[0:res, 0:res, 0:res].astype(np.float32)
    p = (np.stack([x, y, z], -1) + 0.5) / res - 0.5
    r = np.linalg.norm(p, axis=-1)
    if kind == "sphere":
        density = np.clip(1.0 - r / 0.5, 0.0, 1.0) ** 2
    elif kind == "shell":
        density = np.exp(-(((r - 0.35) / 0.08) ** 2))
    else:
        raise ValueError(kind)
    return VolumeGrid(
        density.astype(np.float32),
        None,
        np.zeros(3, np.float32),
        np.ones(3, np.float32),
    )
