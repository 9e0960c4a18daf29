"""Render-time scene: small dataclasses of tensors, plus `RenderConfig`.

The subset of `optix_renderer_tpu/scene/data.py` that the path kernel and
the general path read: triangles (with their LBVH tables from 257
triangles on) and spheres, the shape/BSDF/texture/medium attachment tables
(constant, checkerboard and image textures, normal maps), emitters with
their triangle CDFs, sphere ids and volume-sampling tables, the media with
their phase functions and voxel-grid corner stacks, the emitter-pick
distribution, the camera and the environment map's lat-long tables with
their pixel distribution, and the photon map that the photon mapper builds
before it renders. Field names and layouts are the JAX package's, so
`scene_from_numpy` can carry a JAX scene across by name. Every table has
`.to(device)`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from optix_renderer_tpu_torch.ops import bvh as bvh_ops


class BsdfType:
    """Mirrors BsdfData.h:11-75 tag values."""

    DIFFUSE = 0
    MIRROR = 1
    DIELECTRIC = 2
    MICROFACET = 3
    DISNEY = 4


class EmitterType:
    """Mirrors EmitterData.h:11-69."""

    POINT = 0
    SPOT = 1
    AREA = 2
    ENVMAP = 3
    DIRECTIONAL = 4
    VOLUME = 5


class MediumType:
    VACUUM = 0
    HOMOG = 1
    HETEROG = 2


class PhaseType:
    ISO = 0
    HG = 1
    SCHLICK = 2


class TextureType:
    CONST = 0
    CHECKER = 1
    IMAGE = 2


class EmitterGeom:
    NONE = 0
    MESH = 1
    SPHERE = 2


class SceneBuildError(Exception):
    """The scene uses something this package cannot render yet."""


class PhotonMap(NamedTuple):
    """Hash-grid photon map (ops/photon.py), sorted by cell hash; the JAX
    package's `PhotonMap` (its ops/photon.py:57-68)."""

    pos: torch.Tensor  # [P,3]
    dir: torch.Tensor  # [P,3] direction the photon arrived from (= −ray.d)
    power: torch.Tensor  # [P,3]
    cell_hash: torch.Tensor  # [P] int32, ascending
    origin: torch.Tensor  # [3] grid origin
    inv_cell: torch.Tensor  # [] 1 / cell size
    radius: torch.Tensor  # [] gather radius
    inv_emitted: torch.Tensor  # [] 1 / photons emitted
    table_size: int  # hash modulus, a power of two

    def _map(self, fn):
        return self._replace(**{k: fn(v) for k, v in self._asdict().items()
                                if isinstance(v, torch.Tensor)})

    def to(self, device):
        return self._map(lambda v: v.to(device))

    def detach(self):
        return self._map(lambda v: v.detach())


def empty_photon_map() -> PhotonMap:
    """The map of a scene that has none (no photon mapper, or not built yet)."""
    return PhotonMap(
        pos=torch.zeros((0, 3)), dir=torch.zeros((0, 3)), power=torch.zeros((0, 3)),
        cell_hash=torch.zeros((0,), dtype=torch.int32), origin=torch.zeros(3),
        inv_cell=torch.tensor(1.0), radius=torch.tensor(0.0), inv_emitted=torch.tensor(0.0),
        table_size=1,
    )


class _Tables:
    """`.to(device)` and `.detach()` over every tensor field, recursing into
    nested tables and the photon map; both are differentiable as `Tensor.to`
    / cut the graph as `Tensor.detach` do."""

    def _map(self, fn):
        def each(v):
            return fn(v) if isinstance(v, (torch.Tensor, _Tables, PhotonMap)) else v

        return dataclasses.replace(
            self, **{f.name: each(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )

    def to(self, device):
        return self._map(lambda v: v.to(device))

    def detach(self):
        return self._map(lambda v: v.detach())


def host_snapshot(x):
    """`x` (a table, a tensor, or a tuple / dict of them) with every tensor
    detached on the host, in one wait: each copy from a card is queued into
    pinned memory, then each card is synchronized once. The host packing
    of a scene that lives on the card reads it so, not field by field."""
    cards = set()

    def each(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                cards.add(v.device)
            return v.detach().to("cpu", non_blocking=True)
        if isinstance(v, (_Tables, PhotonMap)):
            return v._map(each)
        if isinstance(v, dict):
            return {k: each(u) for k, u in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(each(u) for u in v)
        return v

    out = each(x)
    for card in cards:
        torch.cuda.synchronize(card)
    return out


@dataclass(frozen=True)
class Bvh(_Tables):
    """Packed threaded LBVH over the triangles, or over the spheres (ops/bvh.py)."""

    packed: torch.Tensor  # [Nn,8] f32: min(3) max(3) skip bits, first bits
    # triangles [n_leaves,40] f32: 4 × (v0 e1 e2, id bits); spheres
    # [n_leaves,20]: 4 × (center, radius, id bits)
    leaf: torch.Tensor
    # [n_pairs,16] f32: the same tree as child pairs (ops/bvh.pack_child_pairs),
    # the table of the general path's kernel
    pairs: torch.Tensor
    # the tree's levels (ops/bvh.pairs_depth), as the builders return it;
    # computed from `pairs` when 0, which copies the table to the host
    depth: int = 0

    def __post_init__(self):
        if self.depth == 0:
            object.__setattr__(self, "depth",
                               bvh_ops.pairs_depth(self.pairs.detach().cpu().numpy()))


@dataclass(frozen=True)
class Geometry(_Tables):
    """World-space triangle soup (v0 / edges / per-corner normals, UVs) + spheres."""

    tri_v0: torch.Tensor  # [T,3] f32
    tri_e1: torch.Tensor  # [T,3] = v1 - v0
    tri_e2: torch.Tensor  # [T,3] = v2 - v0
    tri_n0: torch.Tensor  # [T,3] shading normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # [T,2]
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_tang: torch.Tensor  # [T,4] UV tangent dp/du + handedness (zero: no UV chart)
    tri_shape: torch.Tensor  # [T] i32 shape id
    sph_center: torch.Tensor  # [S,3]
    sph_radius: torch.Tensor  # [S]
    sph_shape: torch.Tensor  # [S] i32 shape id
    bvh: Bvh | None = None  # from ops/bvh.MIN_TRIS_FOR_BVH triangles on
    sph_bvh: Bvh | None = None  # from ops/bvh.MIN_SPHS_FOR_BVH spheres on
    # [T,9] f32 v0 | e1 | e2 per row, the brute-force kernel's table; packed
    # from tri_v0 / e1 / e2 when not given, so every call reuses one copy
    tri_table: torch.Tensor | None = None

    def __post_init__(self):
        if self.tri_table is None:
            object.__setattr__(self, "tri_table", torch.cat(
                [self.tri_v0, self.tri_e1, self.tri_e2], dim=1).to(torch.float32).contiguous())


@dataclass(frozen=True)
class Shapes(_Tables):
    bsdf: torch.Tensor  # [N] i32 bsdf id, −1 for a pass-through medium boundary
    emitter: torch.Tensor  # [N] i32 emitter id or -1
    interior_medium: torch.Tensor  # [N] i32 medium id or -1
    exterior_medium: torch.Tensor  # [N] i32 medium id or -1
    normal_tex: torch.Tensor  # [N] i32 tangent-space normal-map texture id or -1
    # whether any shape has a normal map; computed when None, so that
    # `integrators/common.trace` skips the map's arithmetic without a sync
    mapped: bool | None = None

    def __post_init__(self):
        if self.mapped is None:
            object.__setattr__(self, "mapped", bool((self.normal_tex >= 0).any()))


@dataclass(frozen=True)
class Bsdfs(_Tables):
    """Tagged-union BSDF table; disney params in disney.cpp:32-41 order."""

    type: torch.Tensor  # [B] i32
    albedo_tex: torch.Tensor  # [B] i32 texture id (diffuse albedo / disney baseColor)
    int_ior: torch.Tensor  # [B]
    ext_ior: torch.Tensor  # [B]
    alpha: torch.Tensor  # [B]
    kd: torch.Tensor  # [B,3]
    ks: torch.Tensor  # [B]
    disney: torch.Tensor  # [B,10]


@dataclass(frozen=True)
class Textures(_Tables):
    """Tagged-union texture table (consttexture / checkerboard / PNGTexture)
    and the stack of its images, padded to the largest."""

    type: torch.Tensor  # [X] i32 TextureType
    value: torch.Tensor  # [X,3] constant value / checker value1 / image: 1
    value2: torch.Tensor  # [X,3] checker value2
    scale_uv: torch.Tensor  # [X,2] checker cell size / image uv repeat
    shift_uv: torch.Tensor  # [X,2] checker delta
    image_id: torch.Tensor  # [X] i32 index into image_data, or -1
    image_data: torch.Tensor  # [I,Hmax,Wmax,3] f32 linear (one zero texel without images)
    image_hw: torch.Tensor  # [I,2] i32 each image's own height, width
    # the TextureTypes in `type`; computed when empty, so that
    # `ops/texture.eval_texture` evaluates only the kinds present, without a sync
    kinds: tuple = ()

    def __post_init__(self):
        if not self.kinds:
            object.__setattr__(self, "kinds", tuple(sorted(set(self.type.tolist()))))


@dataclass(frozen=True)
class Emitters(_Tables):
    type: torch.Tensor  # [E] i32
    radiance: torch.Tensor  # [E,3]
    position: torch.Tensor  # [E,3]
    power: torch.Tensor  # [E,3]
    direction: torch.Tensor  # [E,3]
    cos_falloff_start: torch.Tensor  # [E]
    cos_falloff_end: torch.Tensor  # [E]
    angular_radius: torch.Tensor  # [E]
    geom_kind: torch.Tensor  # [E] i32 EmitterGeom
    tri_offset: torch.Tensor  # [E] i32 first global triangle of the mesh
    tri_count: torch.Tensor  # [E] i32
    tri_cdf: torch.Tensor  # [E, MAXT] normalized area CDF (padded with 1s)
    area: torch.Tensor  # [E]
    sphere_id: torch.Tensor  # [E] i32 sphere of a sphere-area / volume emitter, or -1
    # volume emitters (volumelight.cpp:47-79): the shape's bbox (meshes) or
    # ball (spheres) and its volume; pdf = dist² / volume
    bbox_min: torch.Tensor  # [E,3]
    bbox_extent: torch.Tensor  # [E,3]
    volume: torch.Tensor  # [E]
    # whether any emitter lies on a sphere, and whether any is a volume
    # emitter; computed when None, so that `ops/emitter.sample_emitter` skips
    # those branches without a sync
    sphere_lights: bool | None = None
    volume_lights: bool | None = None

    def __post_init__(self):
        if self.sphere_lights is None:
            object.__setattr__(self, "sphere_lights",
                               bool((self.geom_kind == EmitterGeom.SPHERE).any()))
        if self.volume_lights is None:
            object.__setattr__(self, "volume_lights",
                               bool((self.type == EmitterType.VOLUME).any()))


@dataclass(frozen=True)
class Media(_Tables):
    """Media and their phase functions (medium.h:26-90, homogmedium.cpp,
    heterogmedium.cpp). A heterogeneous medium points into the stack of
    voxel grids, padded to one [D,H,W]; each grid is kept only as its corner
    stack: row i holds the 8 cell-corner values of base voxel i in a
    one-voxel zero-padded index space ((D+1)(H+1)(W+1) rows), so a trilinear
    lookup reads one 32-byte row (`ops/volume_grid.py`)."""

    type: torch.Tensor  # [M] i32 MediumType
    sigma_a: torch.Tensor  # [M,3]
    sigma_s: torch.Tensor  # [M,3]
    phase_type: torch.Tensor  # [M] i32 PhaseType
    phase_g: torch.Tensor  # [M] HG g / Schlick k
    emitter: torch.Tensor  # [M] i32 volume emitter id or -1
    vol_id: torch.Tensor  # [M] i32 index into the volume stack or -1
    density_scale: torch.Tensor  # [M]
    temperature_scale: torch.Tensor  # [M]
    vol_dims: torch.Tensor  # [V,3] i32 each grid's own (D,H,W)
    vol_bbox_min: torch.Tensor  # [V,3] world-space bbox
    vol_bbox_max: torch.Tensor  # [V,3]
    vol_majorant: torch.Tensor  # [V] largest unscaled density
    vol_corners: torch.Tensor  # [V, (D+1)(H+1)(W+1), 8] f32 density corners
    vol_tcorners: torch.Tensor  # [V, ..., 8] f32 temperature corners
    grid: tuple  # the padded (D, H, W) of the stack


@dataclass(frozen=True)
class DiscretePDF(_Tables):
    pmf: torch.Tensor  # [n]
    cdf: torch.Tensor  # [n]


@dataclass(frozen=True)
class EnvmapTables(_Tables):
    """The environment map on its lat-long grid (ops/envmap.py): rows θ ∈ [0, π]
    from +z, columns φ ∈ [0, 2π), radiance scale premultiplied; [1,1,3] for a
    constant envmap (and zeros without one)."""

    img: torch.Tensor  # [H,W,3] f32
    rot: torch.Tensor  # [3,3] world → map rotation (ZXZ Euler angles)


@dataclass(frozen=True)
class Camera(_Tables):
    to_world: torch.Tensor  # [4,4] f32
    fov: torch.Tensor  # [] degrees
    near_clip: torch.Tensor
    far_clip: torch.Tensor
    lens_radius: torch.Tensor
    focal_distance: torch.Tensor


@dataclass(frozen=True)
class SceneData(_Tables):
    geometry: Geometry
    shapes: Shapes
    bsdfs: Bsdfs
    textures: Textures
    emitters: Emitters
    media: Media
    camera: Camera
    emitter_pick: DiscretePDF
    envmap_emitter: int  # emitter id of the envmap, or -1
    envmap: EnvmapTables
    envmap_pick: DiscretePDF  # luminance·sinθ pixel distribution ([1] for a constant map)
    ambient_medium: int  # medium id of the scene's ambient medium, or -1
    photons: PhotonMap  # empty until `render.preprocess` builds it for the photon mapper


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; the same fields and defaults as the JAX
    package's `RenderConfig` (scene/data.py:276-324)."""

    width: int = 1280
    height: int = 720
    sample_count: int = 8
    integrator: str = "normals"
    max_depth: int = 16
    rr_min_depth: int = 0
    sampler: str = "independent"
    seed: int = 0
    rfilter: str = "gaussian"
    adaptive: bool = False
    adaptive_uniform_rounds: int = 4
    shadow_segments: int = 8
    n_tris: int = 0
    n_spheres: int = 0
    n_emitters: int = 0
    iprops: tuple = ()
    denoiser: str = ""
    dprops: tuple = ()

    def dprop(self, key, default=None):
        for k, v in self.dprops:
            if k == key:
                return v
        return default

    def iprop(self, key, default=None):
        for k, v in self.iprops:
            if k == key:
                return v
        return default


def _t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy-convertible → tensor (a copy) of `dtype` on the CPU."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def corner_stack(g: np.ndarray) -> np.ndarray:
    """[V,D,H,W] grids → [V,(D+1)(H+1)(W+1),8]: per base voxel of a
    one-voxel zero-padded index space the 8 cell-corner values, (z, y, x)
    corner order (build.py:863-883 of the JAX package)."""
    V, D, H, W = g.shape
    if V == 0:
        return np.zeros((0, (D + 1) * (H + 1) * (W + 1), 8), np.float32)
    P = np.zeros((V, D + 2, H + 2, W + 2), np.float32)
    P[:, 1:D + 1, 1:H + 1, 1:W + 1] = g
    out = np.empty((V, (D + 1) * (H + 1) * (W + 1), 8), np.float32)
    k = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out[..., k] = P[:, dz:dz + D + 1, dy:dy + H + 1, dx:dx + W + 1].reshape(V, -1)
                k += 1
    return out


def scene_from_numpy(tree) -> SceneData:
    """The JAX package's `SceneData` with numpy leaves → this package's scene.

    Reads fields by name and imports no JAX; a caller converts the leaves
    first (`jax.tree.map(np.asarray, scene)`).
    """
    g, sh, b, tx, em, md = (tree.geometry, tree.shapes, tree.bsdfs, tree.textures,
                            tree.emitters, tree.media)
    i32 = torch.int32

    def lbvh(b):
        if np.asarray(b.packed).shape[0] == 0:
            return None
        return Bvh(packed=_t(b.packed), leaf=_t(b.leaf), pairs=_t(bvh_ops.pack_child_pairs(b.packed)))

    geometry = Geometry(
        **{k: _t(getattr(g, k)) for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
            "tri_uv0", "tri_uv1", "tri_uv2", "tri_tang", "sph_center", "sph_radius")},
        tri_shape=_t(g.tri_shape, i32),
        sph_shape=_t(g.sph_shape, i32),
        bvh=lbvh(g.bvh),
        sph_bvh=lbvh(g.sph_bvh),
    )
    emitters = Emitters(
        **{k: _t(getattr(em, k)) for k in (
            "radiance", "position", "power", "direction", "cos_falloff_start",
            "cos_falloff_end", "angular_radius", "tri_cdf", "area", "bbox_min",
            "bbox_extent", "volume")},
        **{k: _t(getattr(em, k), i32) for k in (
            "type", "geom_kind", "tri_offset", "tri_count", "sphere_id")},
    )
    media = Media(
        **{k: _t(getattr(md, k)) for k in (
            "sigma_a", "sigma_s", "phase_g", "density_scale", "temperature_scale",
            "vol_bbox_min", "vol_bbox_max", "vol_majorant", "vol_corners", "vol_tcorners")},
        **{k: _t(getattr(md, k), i32) for k in (
            "type", "phase_type", "emitter", "vol_id", "vol_dims")},
        grid=tuple(int(x) for x in np.asarray(md.vol_density).shape[1:]),
    )
    cam = tree.camera
    pm = tree.photons
    return SceneData(
        geometry=geometry,
        shapes=Shapes(**{k: _t(getattr(sh, k), i32) for k in (
            "bsdf", "emitter", "interior_medium", "exterior_medium", "normal_tex")}),
        bsdfs=Bsdfs(
            type=_t(b.type, i32), albedo_tex=_t(b.albedo_tex, i32),
            **{k: _t(getattr(b, k)) for k in (
                "int_ior", "ext_ior", "alpha", "kd", "ks", "disney")},
        ),
        textures=Textures(
            **{k: _t(getattr(tx, k)) for k in (
                "value", "value2", "scale_uv", "shift_uv", "image_data")},
            **{k: _t(getattr(tx, k), i32) for k in ("type", "image_id", "image_hw")},
        ),
        emitters=emitters,
        media=media,
        camera=Camera(**{k: _t(getattr(cam, k)) for k in (
            "to_world", "fov", "near_clip", "far_clip", "lens_radius",
            "focal_distance")}),
        emitter_pick=DiscretePDF(pmf=_t(tree.emitter_pick.pmf),
                                 cdf=_t(tree.emitter_pick.cdf)),
        envmap_emitter=int(np.asarray(tree.envmap_emitter)),
        envmap=EnvmapTables(img=_t(tree.envmap.img), rot=_t(tree.envmap.rot)),
        envmap_pick=DiscretePDF(pmf=_t(tree.envmap_pick.pmf), cdf=_t(tree.envmap_pick.cdf)),
        ambient_medium=int(np.asarray(tree.ambient_medium)),
        photons=PhotonMap(
            **{k: _t(getattr(pm, k)) for k in (
                "pos", "dir", "power", "origin", "inv_cell", "radius", "inv_emitted")},
            cell_hash=_t(pm.cell_hash, i32),
            table_size=int(pm.table_size),
        ),
    )


def params_from_numpy(params) -> dict:
    """The JAX `trainable_params` dict with numpy leaves (`jax.tree.map(
    np.asarray, params)`) → the same names as float32 tensors on the CPU,
    for `parallel/shard.py: apply_params`."""
    return {k: _t(v) for k, v in params.items()}


def params_to_numpy(params) -> dict:
    """Tensors by name (parameters or their gradients) → numpy float32, the
    inverse of `params_from_numpy`."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}
