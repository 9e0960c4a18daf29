"""Scene compiler without JAX: SceneNode tree → `SceneData` + `RenderConfig`.

The numpy counterpart of `optix_renderer_tpu/scene/build.py` for what the
port renders: OBJ meshes and spheres, the five BSDFs
with constant textures, point / spot / area (mesh) / directional emitters
and a constant environment map. It bakes toWorld into world-space geometry,
builds the emitter-pick distribution (scene.cpp:179-184) and per-area-light
triangle CDFs (mesh.cpp:15-46) exactly as the JAX builder does, so both
produce the same kernel tables, and from 257 triangles on the LBVH tables
of the general path (`ops/bvh.py`). Everything else raises `SceneBuildError`
naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from optix_renderer_tpu_torch.core import transform as tf
from optix_renderer_tpu_torch.ops import bvh as bvh_mod
from optix_renderer_tpu_torch.scene import obj as obj_mod
from optix_renderer_tpu_torch.scene.data import (
    Bsdfs,
    BsdfType,
    Bvh,
    Camera,
    DiscretePDF,
    EmitterGeom,
    Emitters,
    EmitterType,
    Geometry,
    RenderConfig,
    SceneBuildError,
    SceneData,
    Shapes,
    TextureType,
    Textures,
    _t,
    check_supported,
)
from optix_renderer_tpu_torch.scene.parser import SceneNode, load_from_xml

__all__ = ["SceneBuildError", "build_scene", "load_scene"]


def _col(rows, key, dtype=torch.float32, width=None) -> torch.Tensor:
    if not rows:
        return torch.zeros((0,) if width is None else (0, width), dtype=dtype)
    vals = [r[key] for r in rows]
    npdt = np.int32 if dtype == torch.int32 else np.float32
    return _t(np.stack(vals) if width else np.asarray(vals, npdt), dtype)


def _dpdf(weights) -> DiscretePDF:
    """dpdf.build (dpdf.h:74-124) in float32."""
    w = np.maximum(np.asarray(weights, np.float32), np.float32(0))
    total = w.sum(dtype=np.float32)
    inv = np.float32(1.0) / max(total, np.float32(1e-38)) if total > 0 else np.float32(0)
    pmf = w * inv
    return DiscretePDF(pmf=_t(pmf), cdf=_t(np.cumsum(pmf, dtype=np.float32)))


def _uv_tangents(v0, v1, v2, uv0, uv1, uv2) -> np.ndarray:
    """[T,4] UV-aligned tangent dp/du per triangle (mesh.cpp:176-185) and the
    UV handedness sign; zero where the UV chart is degenerate (build.py:620-638
    of the JAX package)."""
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    safe_det = np.where(np.abs(uv_det) > 1e-12, uv_det, 1.0)
    tang = ((v1 - v0) * duv2[:, 1:2] - (v2 - v0) * duv1[:, 1:2]) / safe_det[:, None]
    tang = np.where(np.abs(uv_det)[:, None] > 1e-12, tang, 0.0)
    return np.concatenate([tang, np.sign(safe_det)[:, None]], axis=1).astype(np.float32)


class _Builder:
    def __init__(self, root: SceneNode):
        if root.tag != "scene":
            raise SceneBuildError(
                f"root must be <scene>, got <{root.tag}> "
                "(statistical <test> roots: ROADMAP Queue 1 item 14)"
            )
        self.root = root
        self.origin = Path(root.origin or ".")
        self.tri_v, self.tri_n, self.tri_uv, self.tri_shape = [], [], [], []
        self.spheres = []  # (center, radius, shape_id)
        self.shape_rows, self.bsdf_rows, self.tex_rows, self.em_rows = [], [], [], []
        self.envmap_pixels = 1
        self.n_media = len(root.children_of("medium"))  # ambient media
        self.n_normal_maps = 0

    # -- textures ----------------------------------------------------------

    def add_const_texture(self, value) -> int:
        self.tex_rows.append(dict(type=TextureType.CONST,
                                  value=np.asarray(value, np.float32).reshape(3)))
        return len(self.tex_rows) - 1

    def build_texture(self, node: SceneNode) -> int:
        p = node.props
        if node.type == "constant_color":
            return self.add_const_texture(p.get_color("value", np.full(3, 0.5, np.float32)))
        if node.type == "constant_float":
            return self.add_const_texture(np.full(3, p.get_float("value", 0.5), np.float32))
        raise SceneBuildError(
            f"texture '{node.type}': checkerboard / image textures are "
            "ROADMAP Queue 1 item 8"
        )

    # -- bsdfs -------------------------------------------------------------

    def build_bsdf(self, node: SceneNode | None) -> int:
        """Lower a <bsdf> to a table row. None → default diffuse(0.5)."""
        row = dict(type=BsdfType.DIFFUSE, albedo_tex=-1, int_ior=1.5046,
                   ext_ior=1.000277, alpha=0.1, kd=np.full(3, 0.5, np.float32),
                   ks=0.5, disney=np.zeros(10, np.float32))
        if node is None:
            row["albedo_tex"] = self.add_const_texture([0.5, 0.5, 0.5])
            self.bsdf_rows.append(row)
            return len(self.bsdf_rows) - 1
        p, t = node.props, node.type
        tex_child = node.child("texture")
        if t in ("diffuse", "disney"):
            if tex_child is not None and tex_child.name in ("albedo", ""):
                row["albedo_tex"] = self.build_texture(tex_child)
            else:
                row["albedo_tex"] = self.add_const_texture(
                    p.get_color("albedo", np.full(3, 0.5, np.float32)))
        if t == "diffuse":
            row["type"] = BsdfType.DIFFUSE
        elif t == "mirror":
            row["type"] = BsdfType.MIRROR
        elif t == "dielectric":
            row["type"] = BsdfType.DIELECTRIC
            row["int_ior"] = p.get_float("intIOR", 1.5046)
            row["ext_ior"] = p.get_float("extIOR", 1.000277)
        elif t == "microfacet":
            row["type"] = BsdfType.MICROFACET
            row["alpha"] = p.get_float("alpha", 0.1)
            row["int_ior"] = p.get_float("intIOR", 1.5046)
            row["ext_ior"] = p.get_float("extIOR", 1.000277)
            kd = p.get_color("kd", np.full(3, 0.5, np.float32))
            row["kd"] = kd
            row["ks"] = 1.0 - float(kd.max())  # microfacet.cpp:55
        elif t == "disney":
            row["type"] = BsdfType.DISNEY
            names = ["metallic", "subsurface", "specular", "roughness", "specularTint",
                     "anisotropic", "sheen", "sheenTint", "clearcoat", "clearcoatGloss"]
            defaults = [0.0, 0.0, 0.5, 0.5, 0.0, 0.0, 0.0, 0.5, 0.0, 1.0]
            row["disney"] = np.clip(np.array(
                [p.get_float(n, d) for n, d in zip(names, defaults)], np.float32), 0.0, 1.0)
        else:
            raise SceneBuildError(f"unsupported bsdf type '{t}'")
        self.bsdf_rows.append(row)
        return len(self.bsdf_rows) - 1

    # -- emitters ----------------------------------------------------------

    def build_emitter(self, node: SceneNode, shape_id: int = -1) -> int:
        p = node.props
        row = dict(type=EmitterType.POINT, radiance=np.zeros(3, np.float32),
                   position=np.zeros(3, np.float32), power=np.zeros(3, np.float32),
                   direction=np.array([0, 0, 1], np.float32), cos_falloff_start=1.0,
                   cos_falloff_end=1.0, angular_radius=0.0, shape=shape_id,
                   geom_kind=EmitterGeom.NONE, tri_offset=0, tri_count=0, area=0.0,
                   light_prob=p.get_float("lightWeight", 1.0))
        t = node.type
        if t == "point":
            row["power"] = p.get_color("power")
            row["position"] = p.get_point("position")
            row["radiance"] = row["power"] / (4.0 * math.pi)  # pointlight.cpp
        elif t == "spot":
            row["type"] = EmitterType.SPOT
            row["position"] = p.get_point("position", np.zeros(3, np.float32))
            d = p.get_vector("direction", np.zeros(3, np.float32))
            row["direction"] = d / max(np.linalg.norm(d), 1e-20)
            row["power"] = p.get_color("power", np.zeros(3, np.float32))
            row["cos_falloff_start"] = math.cos(math.radians(p.get_float("falloffstart")))
            row["cos_falloff_end"] = math.cos(math.radians(p.get_float("totalwidth")))
        elif t == "area":
            row["type"] = EmitterType.AREA
            row["radiance"] = p.get_color("radiance")
        elif t == "directional":
            row["type"] = EmitterType.DIRECTIONAL
            d = p.get_vector("direction", np.array([0, 0, 1], np.float32))
            row["direction"] = d / max(np.linalg.norm(d), 1e-20)
            row["radiance"] = p.get_color("radiance", np.zeros(3, np.float32))
            row["angular_radius"] = math.radians(p.get_float("angle", 1.0))
        elif t == "envmap":
            row["type"] = EmitterType.ENVMAP
            row["radiance"] = p.get_color("radiance", np.ones(3, np.float32))
            tex = node.child("texture")
            if tex is not None:
                if tex.type == "constant_color":
                    row["radiance"] = row["radiance"] * tex.props.get_color(
                        "value", np.full(3, 0.5, np.float32))
                elif tex.type == "constant_float":
                    row["radiance"] = row["radiance"] * np.full(
                        3, tex.props.get_float("value", 0.5), np.float32)
                else:
                    self.envmap_pixels = -1  # image map: refused by check_supported
        elif t == "volumelight":
            row["type"] = EmitterType.VOLUME
        else:
            raise SceneBuildError(f"unsupported emitter type '{t}'")
        self.em_rows.append(row)
        return len(self.em_rows) - 1

    # -- shapes ------------------------------------------------------------

    def build_shape(self, node: SceneNode):
        p = node.props
        shape_id = len(self.shape_rows)
        row = dict(bsdf=-1, emitter=-1)
        if node.type == "obj":
            to_world = p.get_transform("toWorld", tf.identity())
            mesh = obj_mod.load_obj(self.origin / p.get_string("filename"), to_world)
            self._append_mesh(mesh, shape_id)
        elif node.type == "sphere":
            self.spheres.append((p.get_point("center", np.zeros(3, np.float32)),
                                 p.get_float("radius", 1.0), shape_id))
        else:
            raise SceneBuildError(f"unsupported shape type '{node.type}'")
        self.n_media += len(node.children_of("medium"))
        tex = node.child("texture")
        self.n_normal_maps += int(tex is not None and tex.name == "normal")
        row["bsdf"] = self.build_bsdf(node.child("bsdf"))
        em_node = node.child("emitter")
        if em_node is not None:
            row["emitter"] = self.build_emitter(em_node, shape_id=shape_id)
        self.shape_rows.append(row)

    def _append_mesh(self, mesh: dict, shape_id: int):
        V, F = mesh["V"], mesh["F"]
        v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        gn = np.cross(v1 - v0, v2 - v0)
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        if "N" in mesh:
            N = mesh["N"]
            n0, n1, n2 = N[F[:, 0]], N[F[:, 1]], N[F[:, 2]]
            for arr in (n0, n1, n2):  # zero-length shading normals → geometric
                bad = np.linalg.norm(arr, axis=-1) < 1e-8
                arr[bad] = gn[bad]
        else:
            n0 = n1 = n2 = gn
        if "UV" in mesh:
            UV = mesh["UV"]
            uv0, uv1, uv2 = UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((len(F), 2), np.float32)
        self.tri_v.append((v0, v1, v2))
        self.tri_n.append((n0, n1, n2))
        self.tri_uv.append((uv0, uv1, uv2))
        self.tri_shape.append(np.full(len(F), shape_id, np.int32))

    # -- top level ---------------------------------------------------------

    def build(self) -> tuple[SceneData, RenderConfig, dict]:
        root = self.root
        if root.child("denoiser") is not None:
            raise SceneBuildError("denoisers: ROADMAP Queue 1 item 13")
        sampler = root.child("sampler")
        if sampler is not None and sampler.type == "adaptive":
            raise SceneBuildError("adaptive sampling: ROADMAP Queue 1 item 11")

        for sh in root.children_of("shape"):
            self.build_shape(sh)
        for em in root.children_of("emitter"):
            self.build_emitter(em)
        n_real_emitters = len(self.em_rows)
        # pad tables to ≥1 row (the dummy emitter has zero radiance/power)
        if not self.shape_rows:
            self.shape_rows.append(dict(bsdf=self.build_bsdf(None), emitter=-1))
        if not self.em_rows:
            self.em_rows.append(dict(
                type=EmitterType.POINT, radiance=np.zeros(3, np.float32),
                position=np.zeros(3, np.float32), power=np.zeros(3, np.float32),
                direction=np.array([0, 0, 1], np.float32), cos_falloff_start=1.0,
                cos_falloff_end=1.0, angular_radius=0.0, shape=-1,
                geom_kind=EmitterGeom.NONE, tri_offset=0, tri_count=0, area=0.0,
                light_prob=1.0))

        # ---- geometry concat
        if self.tri_v:
            cat = lambda xs, i: np.concatenate([x[i] for x in xs], 0).astype(np.float32)
            tri_v0, tri_v1, tri_v2 = (cat(self.tri_v, i) for i in range(3))
            tri_n0, tri_n1, tri_n2 = (cat(self.tri_n, i) for i in range(3))
            tri_uv0, tri_uv1, tri_uv2 = (cat(self.tri_uv, i) for i in range(3))
            tri_shape = np.concatenate(self.tri_shape)
        else:
            tri_v0 = tri_v1 = tri_v2 = tri_n0 = tri_n1 = tri_n2 = np.zeros((0, 3), np.float32)
            tri_uv0 = tri_uv1 = tri_uv2 = np.zeros((0, 2), np.float32)
            tri_shape = np.zeros(0, np.int32)
        if self.spheres:
            sph_center = np.stack([s[0] for s in self.spheres]).astype(np.float32)
            sph_radius = np.array([s[1] for s in self.spheres], np.float32)
            sph_shape = np.array([s[2] for s in self.spheres], np.int32)
        else:
            sph_center = np.zeros((0, 3), np.float32)
            sph_radius = np.zeros(0, np.float32)
            sph_shape = np.zeros(0, np.int32)
        bvh = None
        if len(tri_v0) >= bvh_mod.MIN_TRIS_FOR_BVH:
            packed, leaf = bvh_mod.build_bvh_tables(tri_v0, tri_v1, tri_v2)
            bvh = Bvh(packed=_t(packed), leaf=_t(leaf))
        geometry = Geometry(
            tri_v0=_t(tri_v0), tri_e1=_t(tri_v1 - tri_v0), tri_e2=_t(tri_v2 - tri_v0),
            tri_n0=_t(tri_n0), tri_n1=_t(tri_n1), tri_n2=_t(tri_n2),
            tri_uv0=_t(tri_uv0), tri_uv1=_t(tri_uv1), tri_uv2=_t(tri_uv2),
            tri_tang=_t(_uv_tangents(tri_v0, tri_v1, tri_v2, tri_uv0, tri_uv1, tri_uv2)),
            tri_shape=_t(tri_shape, torch.int32), sph_center=_t(sph_center),
            sph_radius=_t(sph_radius), sph_shape=_t(sph_shape, torch.int32), bvh=bvh,
        )

        # ---- per-area-light triangle CDFs (mesh.cpp:15-46)
        tri_offsets, off = {}, 0
        for arr in self.tri_shape:
            if len(arr):
                tri_offsets[int(arr[0])] = off
                off += len(arr)
        n_em = len(self.em_rows)
        max_t = max([1] + [int(np.sum(tri_shape == r["shape"])) for r in self.em_rows
                           if r["shape"] in tri_offsets])
        em_tri_cdf = np.ones((n_em, max_t), np.float32)
        for ei, row in enumerate(self.em_rows):
            sid = row["shape"]
            if sid < 0:
                continue
            if sid in tri_offsets:
                mask = tri_shape == sid
                count = int(mask.sum())
                a = 0.5 * np.linalg.norm(np.cross(tri_v1[mask] - tri_v0[mask],
                                                  tri_v2[mask] - tri_v0[mask]), axis=-1)
                total = float(a.sum())
                em_tri_cdf[ei, :count] = np.cumsum(a / max(total, 1e-20))
                row.update(geom_kind=EmitterGeom.MESH, tri_offset=tri_offsets[sid],
                           tri_count=count, area=total)
            else:
                r = next(s[1] for s in self.spheres if s[2] == sid)
                row.update(geom_kind=EmitterGeom.SPHERE, area=4.0 * math.pi * r * r)

        i32 = torch.int32
        emitters = Emitters(
            type=_col(self.em_rows, "type", i32),
            radiance=_col(self.em_rows, "radiance", width=3),
            position=_col(self.em_rows, "position", width=3),
            power=_col(self.em_rows, "power", width=3),
            direction=_col(self.em_rows, "direction", width=3),
            cos_falloff_start=_col(self.em_rows, "cos_falloff_start"),
            cos_falloff_end=_col(self.em_rows, "cos_falloff_end"),
            angular_radius=_col(self.em_rows, "angular_radius"),
            geom_kind=_col(self.em_rows, "geom_kind", i32),
            tri_offset=_col(self.em_rows, "tri_offset", i32),
            tri_count=_col(self.em_rows, "tri_count", i32),
            tri_cdf=_t(em_tri_cdf),
            area=_col(self.em_rows, "area"),
        )
        envmap_emitter = max([-1] + [i for i, r in enumerate(self.em_rows)
                                     if r["type"] == EmitterType.ENVMAP])
        if not self.bsdf_rows:
            self.build_bsdf(None)
        albedo_tex = np.array([r["albedo_tex"] for r in self.bsdf_rows])
        check_supported(
            n_media=self.n_media, n_normal_maps=self.n_normal_maps,
            used_tex_types=[self.tex_rows[i]["type"] for i in albedo_tex[albedo_tex >= 0]],
            emitter_types=[r["type"] for r in self.em_rows],
            emitter_geom=[r["geom_kind"] for r in self.em_rows],
            envmap_pixels=self.envmap_pixels,
        )
        bsdfs = Bsdfs(
            type=_col(self.bsdf_rows, "type", i32),
            albedo_tex=_col(self.bsdf_rows, "albedo_tex", i32),
            int_ior=_col(self.bsdf_rows, "int_ior"),
            ext_ior=_col(self.bsdf_rows, "ext_ior"),
            alpha=_col(self.bsdf_rows, "alpha"),
            kd=_col(self.bsdf_rows, "kd", width=3),
            ks=_col(self.bsdf_rows, "ks"),
            disney=_col(self.bsdf_rows, "disney", width=10),
        )
        textures = Textures(type=_col(self.tex_rows, "type", i32),
                            value=_col(self.tex_rows, "value", width=3))
        shapes = Shapes(bsdf=_col(self.shape_rows, "bsdf", i32),
                        emitter=_col(self.shape_rows, "emitter", i32))

        # ---- camera (perspective.cpp:10-96)
        camera = root.child("camera") or SceneNode(tag="camera", type="perspective")
        cp = camera.props
        focal_distance = cp.get_float("focalDistance", 10.0)
        fstop = cp.get_float("fstop", 0.0)
        lens_radius = focal_distance / fstop if fstop != 0.0 else cp.get_float("lensRadius", 0.0)
        rf_node = camera.child("rfilter")
        rfilter = "gaussian"
        if rf_node is not None:
            if rf_node.type not in ("gaussian", "mitchell", "tent", "box"):
                raise SceneBuildError(f"unknown rfilter type '{rf_node.type}'")
            rfilter = rf_node.type
        cam = Camera(
            to_world=_t(cp.get_transform("toWorld", tf.identity())),
            fov=_t(cp.get_float("fov", 30.0)),
            near_clip=_t(cp.get_float("nearClip", 1e-4)),
            far_clip=_t(cp.get_float("farClip", 1e4)),
            lens_radius=_t(lens_radius),
            focal_distance=_t(focal_distance),
        )

        integrator = root.child("integrator")
        iprops = ()
        if integrator is not None:
            iprops = tuple((k, v) for k, v in integrator.props.props.items()
                           if isinstance(v, (int, float, bool, str)))
        config = RenderConfig(
            width=cp.get_integer("width", 1280),
            height=cp.get_integer("height", 720),
            sample_count=sampler.props.get_integer("sampleCount", 1) if sampler else 1,
            integrator=integrator.type if integrator is not None else "normals",
            iprops=iprops,
            rfilter=rfilter,
            sampler=sampler.type if sampler is not None else "independent",
            n_tris=len(tri_v0),
            n_spheres=len(self.spheres),
            n_emitters=n_real_emitters,
            shadow_segments=(integrator.props.get_integer("shadowSegments", 8)
                             if integrator is not None else 8),
        )
        env_rad = (self.em_rows[envmap_emitter]["radiance"] if envmap_emitter >= 0
                   else np.zeros(3, np.float32))
        scene = SceneData(
            geometry=geometry, shapes=shapes, bsdfs=bsdfs, textures=textures,
            emitters=emitters, camera=cam,
            emitter_pick=_dpdf([r["light_prob"] for r in self.em_rows]),
            envmap_emitter=envmap_emitter,
            envmap_radiance=_t(np.asarray(env_rad, np.float32).reshape(3)),
        )
        return scene, config, {"integrator_props": integrator.props if integrator else None}


def build_scene(root: SceneNode) -> tuple[SceneData, RenderConfig, dict]:
    return _Builder(root).build()


def load_scene(filename) -> tuple[SceneData, RenderConfig, dict]:
    """XML file → (SceneData, RenderConfig, extras)."""
    return build_scene(load_from_xml(filename))
