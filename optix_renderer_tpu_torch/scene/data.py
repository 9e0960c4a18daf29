"""Render-time scene: small dataclasses of tensors, plus `RenderConfig`.

The subset of `optix_renderer_tpu/scene/data.py` that the path kernel and
the general path read: triangles (with their LBVH tables from 257
triangles on) and spheres, the shape/BSDF/texture attachment tables,
emitters with their triangle CDFs, the emitter-pick distribution, the
camera and a constant environment radiance. Field names and layouts
are the JAX package's, so `scene_from_numpy` can carry a JAX scene across
by name. Every table has `.to(device)`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


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


class _Tables:
    """`.to(device)` over every tensor field, recursing into nested tables."""

    def to(self, device):
        def move(v):
            return v.to(device) if isinstance(v, (torch.Tensor, _Tables)) else v

        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )


@dataclass(frozen=True)
class Bvh(_Tables):
    """Packed threaded LBVH over the triangles (ops/bvh.py)."""

    packed: torch.Tensor  # [Nn,8] f32: min(3) max(3) skip bits, first bits
    leaf: torch.Tensor  # [n_leaves,40] f32: 4 × (v0 e1 e2, id bits)


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
    # [T,9] f32 v0 | e1 | e2 per row, the brute-force kernel's table; packed
    # from tri_v0 / e1 / e2 when not given, so every call reuses one copy
    tri_table: torch.Tensor | None = None

    def __post_init__(self):
        if self.tri_table is None:
            object.__setattr__(self, "tri_table", torch.cat(
                [self.tri_v0, self.tri_e1, self.tri_e2], dim=1).to(torch.float32).contiguous())


@dataclass(frozen=True)
class Shapes(_Tables):
    bsdf: torch.Tensor  # [N] i32 bsdf id
    emitter: torch.Tensor  # [N] i32 emitter id or -1


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
    """Constant textures only."""

    type: torch.Tensor  # [X] i32 (all TextureType.CONST)
    value: torch.Tensor  # [X,3]


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


@dataclass(frozen=True)
class DiscretePDF(_Tables):
    pmf: torch.Tensor  # [n]
    cdf: torch.Tensor  # [n]


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
    camera: Camera
    emitter_pick: DiscretePDF
    envmap_emitter: int  # emitter id of the constant envmap, or -1
    envmap_radiance: torch.Tensor  # [3] (zeros without an envmap)


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


def check_supported(*, n_media, n_normal_maps, used_tex_types, emitter_types,
                    emitter_geom, envmap_pixels) -> None:
    """Raise `SceneBuildError` for what this package cannot render yet. Shared
    by the XML builder and `scene_from_numpy`; each message names the
    ROADMAP item that will port the feature."""
    if n_media:
        raise SceneBuildError("participating media: ROADMAP Queue 1 item 9")
    if n_normal_maps:
        raise SceneBuildError("normal maps: ROADMAP Queue 1 item 8")
    if np.any(np.asarray(used_tex_types) != TextureType.CONST):
        raise SceneBuildError("checkerboard / image textures: ROADMAP Queue 1 item 8")
    et = np.asarray(emitter_types)
    if np.any(et == EmitterType.VOLUME):
        raise SceneBuildError("volume emitters: ROADMAP Queue 1 item 9")
    if np.any((et == EmitterType.AREA) & (np.asarray(emitter_geom) == EmitterGeom.SPHERE)):
        raise SceneBuildError("sphere-area emitters: ROADMAP Queue 1 item 8")
    if envmap_pixels != 1:
        raise SceneBuildError("image-based environment maps: ROADMAP Queue 1 item 8")


def scene_from_numpy(tree) -> SceneData:
    """The JAX package's `SceneData` with numpy leaves → this package's scene.

    Reads fields by name and imports no JAX; a caller converts the leaves
    first (`jax.tree.map(np.asarray, scene)`). Raises `SceneBuildError` for
    what the port cannot render yet, as `scene.build` does.
    """
    g, sh, b, tx, em = tree.geometry, tree.shapes, tree.bsdfs, tree.textures, tree.emitters
    used = np.asarray(b.albedo_tex)
    used = used[used >= 0]
    env_id = int(np.asarray(tree.envmap_emitter))
    img = np.asarray(tree.envmap.img)
    check_supported(
        n_media=int((np.asarray(sh.interior_medium) >= 0).sum()
                    + (np.asarray(sh.exterior_medium) >= 0).sum()
                    + (np.asarray(tree.ambient_medium) >= 0).sum()),
        n_normal_maps=int((np.asarray(sh.normal_tex) >= 0).sum()),
        used_tex_types=np.asarray(tx.type)[used],
        emitter_types=em.type,
        emitter_geom=em.geom_kind,
        envmap_pixels=img.shape[0] * img.shape[1] if env_id >= 0 else 1,
    )
    i32 = torch.int32
    has_bvh = np.asarray(g.bvh.packed).shape[0] > 0
    geometry = Geometry(
        **{k: _t(getattr(g, k)) for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
            "tri_uv0", "tri_uv1", "tri_uv2", "tri_tang", "sph_center", "sph_radius")},
        tri_shape=_t(g.tri_shape, i32),
        sph_shape=_t(g.sph_shape, i32),
        bvh=Bvh(packed=_t(g.bvh.packed), leaf=_t(g.bvh.leaf)) if has_bvh else None,
    )
    emitters = Emitters(
        **{k: _t(getattr(em, k)) for k in (
            "radiance", "position", "power", "direction", "cos_falloff_start",
            "cos_falloff_end", "angular_radius", "tri_cdf", "area")},
        **{k: _t(getattr(em, k), i32) for k in (
            "type", "geom_kind", "tri_offset", "tri_count")},
    )
    cam = tree.camera
    return SceneData(
        geometry=geometry,
        shapes=Shapes(bsdf=_t(sh.bsdf, i32), emitter=_t(sh.emitter, i32)),
        bsdfs=Bsdfs(
            type=_t(b.type, i32), albedo_tex=_t(b.albedo_tex, i32),
            **{k: _t(getattr(b, k)) for k in (
                "int_ior", "ext_ior", "alpha", "kd", "ks", "disney")},
        ),
        textures=Textures(type=_t(tx.type, i32), value=_t(tx.value)),
        emitters=emitters,
        camera=Camera(**{k: _t(getattr(cam, k)) for k in (
            "to_world", "fov", "near_clip", "far_clip", "lens_radius",
            "focal_distance")}),
        emitter_pick=DiscretePDF(pmf=_t(tree.emitter_pick.pmf),
                                 cdf=_t(tree.emitter_pick.cdf)),
        envmap_emitter=env_id,
        envmap_radiance=_t(img.reshape(-1, 3)[0] if env_id >= 0 else np.zeros(3)),
    )
