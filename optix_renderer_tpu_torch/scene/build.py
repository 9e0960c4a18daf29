"""Scene compiler without JAX: SceneNode tree → `SceneData` + `RenderConfig`.

The numpy counterpart of `optix_renderer_tpu/scene/build.py` for what the
port renders: OBJ meshes and spheres, the five BSDFs with constant,
checkerboard and PNG textures, tangent-space normal maps, point / spot /
area (mesh or sphere) / directional / volume emitters and an environment
map, constant or read from a PNG / HDR / EXR image, and vacuum,
homogeneous and voxel-grid media with their phase functions, inside
shapes (a shape with a medium and no BSDF is a pass-through boundary) or
as the scene's ambient medium. It bakes toWorld into world-space
geometry, builds the emitter-pick distribution (scene.cpp:179-184), the
per-area-light triangle CDFs (mesh.cpp:15-46), the volume-light tables,
the media's corner stacks and the envmap's tables (`ops/envmap.py`) as
the JAX builder does, row for row, so both produce the same tables, and
from 257 triangles on the LBVH tables of the general path (`ops/bvh.py`),
and from 65 spheres on the spheres' LBVH (JAX build.py:615-618). The
scene lands on the device the caller names, as the JAX `build_scene` puts
its arrays on the default device: the LBVHs are built there (on CUDA by
`csrc/lbvh.cu`) and every other table is built on the host and moved once.
A scene's `<denoiser>` lands in `RenderConfig.denoiser` / `dprops`; its
photon map stays empty until `render.preprocess` builds it. The root may
also be a `<test>` (`validation/xmltest.py` runs it); `build_bsdf_table`
gives the tables of its `<bsdf>` children.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from optix_renderer_tpu_torch.core import dpdf as dpdf_mod
from optix_renderer_tpu_torch.core import transform as tf
from optix_renderer_tpu_torch.ops import bvh as bvh_mod
from optix_renderer_tpu_torch.ops import envmap as envmap_mod
from optix_renderer_tpu_torch.scene import obj as obj_mod
from optix_renderer_tpu_torch.scene import volume_io
from optix_renderer_tpu_torch.scene.data import (
    Bsdfs,
    BsdfType,
    Camera,
    EmitterGeom,
    Emitters,
    EmitterType,
    Geometry,
    Media,
    MediumType,
    PhaseType,
    RenderConfig,
    SceneBuildError,
    SceneData,
    Shapes,
    TextureType,
    Textures,
    _t,
    corner_stack,
    empty_photon_map,
)
from optix_renderer_tpu_torch.utils.device import resolve_device
from optix_renderer_tpu_torch.scene.parser import SceneNode, load_from_xml
from optix_renderer_tpu_torch.utils import imageio as iio
from optix_renderer_tpu_torch.utils import tracing

__all__ = ["SceneBuildError", "build_bsdf_table", "build_scene", "load_scene"]


def _col(rows, key, dtype=torch.float32, width=None) -> torch.Tensor:
    if not rows:
        return torch.zeros((0,) if width is None else (0, width), dtype=dtype)
    vals = [r[key] for r in rows]
    npdt = np.int32 if dtype == torch.int32 else np.float32
    return _t(np.stack(vals) if width else np.asarray(vals, npdt), dtype)


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
    def __init__(self, root: SceneNode, device: torch.device):
        if root.tag not in ("scene", "test"):
            raise SceneBuildError(f"root must be <scene> or <test>, got <{root.tag}>")
        self.root = root
        self.device = device
        self.origin = Path(root.origin or ".")
        self.tri_v, self.tri_n, self.tri_uv, self.tri_shape = [], [], [], []
        self.spheres = []  # (center, radius, shape_id)
        self.shape_rows, self.bsdf_rows, self.tex_rows, self.em_rows = [], [], [], []
        self.med_rows = []
        self.images = []  # [h,w,3] float32 linear, one per image texture
        self.volumes = []  # scene/volume_io.VolumeGrid, one per heterogeneous medium
        self.envmap_source = None  # dict(image, euler) of an image-based envmap

    # -- textures ----------------------------------------------------------

    def add_texture(self, type_, value, value2=(0, 0, 0), scale_uv=(1, 1), shift_uv=(0, 0),
                    image_id=-1) -> int:
        self.tex_rows.append(dict(
            type=type_, value=np.asarray(value, np.float32).reshape(3),
            value2=np.asarray(value2, np.float32).reshape(3),
            scale_uv=np.asarray(scale_uv, np.float32).reshape(-1)[:2],
            shift_uv=np.asarray(shift_uv, np.float32).reshape(-1)[:2], image_id=image_id))
        return len(self.tex_rows) - 1

    def add_const_texture(self, value) -> int:
        return self.add_texture(TextureType.CONST, value)

    def build_texture(self, node: SceneNode) -> int:
        p, t = node.props, node.type
        if t == "constant_color":
            return self.add_const_texture(p.get_color("value", np.full(3, 0.5, np.float32)))
        if t == "constant_float":
            return self.add_const_texture(np.full(3, p.get_float("value", 0.5), np.float32))
        if t in ("checkerboard_color", "checkerboard_float"):
            if t == "checkerboard_color":
                v1 = p.get_color("value1", np.zeros(3, np.float32))
                v2 = p.get_color("value2", np.ones(3, np.float32))
            else:
                v1 = np.full(3, p.get_float("value1", 0.0), np.float32)
                v2 = np.full(3, p.get_float("value2", 1.0), np.float32)
            return self.add_texture(TextureType.CHECKER, v1, v2,
                                    scale_uv=p.props.get("scale", np.ones(2)),
                                    shift_uv=p.props.get("delta", np.zeros(2)))
        if t == "png_texture":
            img = iio.read_image(self.origin / p.get_string("filename"))  # [h,w,3] in [0,1]
            if p.get_boolean("sRGB", True):
                img = iio.srgb_to_linear(img)
            self.images.append(img.astype(np.float32))
            return self.add_texture(TextureType.IMAGE, np.ones(3),
                                    scale_uv=p.props.get("scale", np.ones(2)),
                                    image_id=len(self.images) - 1)
        raise SceneBuildError(f"unsupported texture type '{t}'")

    def bsdf_texture_tables(self) -> tuple[Bsdfs, Textures]:
        """Finish the BSDF and texture tables (a default diffuse row when
        there is none), for a scene build and for `build_bsdf_table`."""
        if not self.bsdf_rows:
            self.build_bsdf(None)
        rows, i32 = self.bsdf_rows, torch.int32
        bsdfs = Bsdfs(
            type=_col(rows, "type", i32), albedo_tex=_col(rows, "albedo_tex", i32),
            int_ior=_col(rows, "int_ior"), ext_ior=_col(rows, "ext_ior"),
            alpha=_col(rows, "alpha"), kd=_col(rows, "kd", width=3), ks=_col(rows, "ks"),
            disney=_col(rows, "disney", width=10))
        return bsdfs, self.texture_table()

    def texture_table(self) -> Textures:
        if not self.tex_rows:
            self.add_const_texture([0.5, 0.5, 0.5])
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            image_data = np.zeros((len(self.images), hmax, wmax, 3), np.float32)
            image_hw = np.zeros((len(self.images), 2), np.int32)
            for i, im in enumerate(self.images):
                image_data[i, :im.shape[0], :im.shape[1]] = im
                image_hw[i] = im.shape[:2]
        else:
            image_data = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)
        rows, i32 = self.tex_rows, torch.int32
        return Textures(
            type=_col(rows, "type", i32), value=_col(rows, "value", width=3),
            value2=_col(rows, "value2", width=3), scale_uv=_col(rows, "scale_uv", width=2),
            shift_uv=_col(rows, "shift_uv", width=2), image_id=_col(rows, "image_id", i32),
            image_data=_t(image_data), image_hw=_t(image_hw, i32))

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

    def build_emitter(self, node: SceneNode, shape_id: int = -1, medium_id: int = -1) -> int:
        p = node.props
        row = dict(type=EmitterType.POINT, radiance=np.zeros(3, np.float32),
                   position=np.zeros(3, np.float32), power=np.zeros(3, np.float32),
                   direction=np.array([0, 0, 1], np.float32), cos_falloff_start=1.0,
                   cos_falloff_end=1.0, angular_radius=0.0, shape=shape_id,
                   geom_kind=EmitterGeom.NONE, tri_offset=0, tri_count=0, area=0.0,
                   sphere_id=-1, light_prob=p.get_float("lightWeight", 1.0),
                   bbox_min=np.zeros(3, np.float32), bbox_extent=np.ones(3, np.float32),
                   volume=1.0, medium=medium_id)
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
            # an image map feeds the envmap's own lat-long tables, not the
            # texture stack (environmentmap.cpp:12-18: constant otherwise)
            tex = node.child("texture")
            if tex is not None:
                tp = tex.props
                if tex.type == "png_texture":
                    fname = self.origin / tp.get_string("filename")
                    img = iio.read_image(fname)
                    # PNGTexture.cpp:26 sRGB default; HDR formats are linear already
                    if tp.get_boolean("sRGB", True) and fname.suffix.lower() not in (".hdr",
                                                                                      ".exr"):
                        img = iio.srgb_to_linear(img)
                    img = img * tp.get_float("intensity", 1.0)
                    euler = np.asarray(tp.props.get("eulerAngles", np.zeros(3)),
                                       np.float32).reshape(-1)[:3]
                    self.envmap_source = dict(image=img, euler=tuple(euler))
                elif tex.type == "constant_color":
                    row["radiance"] = row["radiance"] * tp.get_color(
                        "value", np.full(3, 0.5, np.float32))
                elif tex.type == "constant_float":
                    row["radiance"] = row["radiance"] * np.full(
                        3, tp.get_float("value", 0.5), np.float32)
                else:
                    raise SceneBuildError(f"unsupported envmap texture '{tex.type}'")
        elif t == "volumelight":
            row["type"] = EmitterType.VOLUME
            row["radiance"] = p.get_color("radiance", np.zeros(3, np.float32))
        else:
            raise SceneBuildError(f"unsupported emitter type '{t}'")
        self.em_rows.append(row)
        return len(self.em_rows) - 1

    # -- media -------------------------------------------------------------

    def build_medium(self, node: SceneNode) -> int:
        """A <medium> → a table row (medium.cpp:13-16, homogmedium.cpp,
        heterogmedium.cpp:47-51); its <volumelight> child becomes an emitter."""
        p = node.props
        row = dict(type=MediumType.VACUUM,
                   sigma_a=np.asarray(p.get_color("sigma_a", np.full(3, 0.5, np.float32))
                                      * p.get_float("sigma_a_intensity", 1.0), np.float32),
                   sigma_s=np.asarray(p.get_color("sigma_s", np.zeros(3, np.float32))
                                      * p.get_float("sigma_s_intensity", 1.0), np.float32),
                   phase_type=PhaseType.ISO, phase_g=0.0, emitter=-1, vol_id=-1,
                   density_scale=1.0, temperature_scale=0.0)
        if node.type == "homog":
            row["type"] = MediumType.HOMOG
            density = p.get_float("density", 1.0)
            row["sigma_a"] = row["sigma_a"] * density
            row["sigma_s"] = row["sigma_s"] * density
        elif node.type == "heterog":
            row["type"] = MediumType.HETEROG
            row["density_scale"] = p.get_float("densityScale", 1.0)
            row["temperature_scale"] = p.get_float("temperatureScale", 0.0)
            vol = node.child("volume")
            if vol is None:
                raise SceneBuildError("heterog medium requires a <volume> child")
            self.volumes.append(volume_io.load_volume(
                self.origin / vol.props.get_string("filename")))
            row["vol_id"] = len(self.volumes) - 1
        elif node.type != "vacuum":
            raise SceneBuildError(f"unsupported medium type '{node.type}'")
        ph = node.child("phase")
        if ph is not None:
            g = ph.props.get_float("g", 0.0)
            if ph.type == "isophase":
                row["phase_type"] = PhaseType.ISO
            elif ph.type == "anisophase":
                row.update(phase_type=PhaseType.HG, phase_g=g)
            elif ph.type == "schlick":
                # schlickphase.cpp: k = 1.55g − 0.55g³
                row.update(phase_type=PhaseType.SCHLICK, phase_g=1.55 * g - 0.55 * g**3)
            else:
                raise SceneBuildError(f"unsupported phase '{ph.type}'")
        self.med_rows.append(row)
        med_id = len(self.med_rows) - 1
        em = node.child("emitter")
        if em is not None:
            row["emitter"] = self.build_emitter(em, medium_id=med_id)
        return med_id

    def media_table(self) -> Media:
        """The media rows (a vacuum row when there are none, as
        scene.cpp's cloneAndInit instantiates one) and the volume stack,
        padded to one [D,H,W], as corner stacks."""
        if not self.med_rows:
            self.med_rows.append(dict(
                type=MediumType.VACUUM, sigma_a=np.zeros(3, np.float32),
                sigma_s=np.zeros(3, np.float32), phase_type=PhaseType.ISO, phase_g=0.0,
                emitter=-1, vol_id=-1, density_scale=1.0, temperature_scale=0.0))
        nv = len(self.volumes)
        grid = tuple(max([1] + [v.density.shape[k] for v in self.volumes]) for k in range(3))
        density = np.zeros((nv, *grid), np.float32)
        temperature = np.zeros((nv, *grid), np.float32)
        dims = np.zeros((nv, 3), np.int32)
        bmin, bmax = np.zeros((nv, 3), np.float32), np.ones((nv, 3), np.float32)
        for i, v in enumerate(self.volumes):
            d, h, w = v.density.shape
            density[i, :d, :h, :w] = v.density
            if v.temperature is not None:
                temperature[i, :d, :h, :w] = v.temperature
            dims[i], bmin[i], bmax[i] = (d, h, w), v.bbox_min, v.bbox_max
        rows, i32 = self.med_rows, torch.int32
        return Media(
            type=_col(rows, "type", i32), sigma_a=_col(rows, "sigma_a", width=3),
            sigma_s=_col(rows, "sigma_s", width=3), phase_type=_col(rows, "phase_type", i32),
            phase_g=_col(rows, "phase_g"), emitter=_col(rows, "emitter", i32),
            vol_id=_col(rows, "vol_id", i32), density_scale=_col(rows, "density_scale"),
            temperature_scale=_col(rows, "temperature_scale"),
            vol_dims=_t(dims, i32), vol_bbox_min=_t(bmin), vol_bbox_max=_t(bmax),
            vol_majorant=_t([float(v.density.max()) for v in self.volumes]),
            vol_corners=_t(corner_stack(density)), vol_tcorners=_t(corner_stack(temperature)),
            grid=grid)

    # -- shapes ------------------------------------------------------------

    def build_shape(self, node: SceneNode):
        p = node.props
        shape_id = len(self.shape_rows)
        row = dict(bsdf=-1, emitter=-1, interior_medium=-1, exterior_medium=-1, normal_tex=-1)
        if node.type == "obj":
            to_world = p.get_transform("toWorld", tf.identity())
            mesh = obj_mod.load_obj(self.origin / p.get_string("filename"), to_world)
            self._append_mesh(mesh, shape_id)
        elif node.type == "sphere":
            self.spheres.append((p.get_point("center", np.zeros(3, np.float32)),
                                 p.get_float("radius", 1.0), shape_id))
        else:
            raise SceneBuildError(f"unsupported shape type '{node.type}'")
        # a shape with a medium and no BSDF is a pass-through boundary: no
        # default diffuse (shape.cpp cloneAndInit)
        media = node.children_of("medium")
        bsdf = node.child("bsdf")
        if bsdf is not None or not media:
            row["bsdf"] = self.build_bsdf(bsdf)
        em_node = node.child("emitter")
        if em_node is not None:
            row["emitter"] = self.build_emitter(em_node, shape_id=shape_id)
        for med in media:
            row["exterior_medium" if med.name == "exterior" else "interior_medium"] = (
                self.build_medium(med))
        tex = node.child("texture")
        if tex is not None and tex.name == "normal":
            row["normal_tex"] = self.build_texture(tex)
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
        sampler = root.child("sampler")

        for sh in root.children_of("shape"):
            self.build_shape(sh)
        for em in root.children_of("emitter"):
            self.build_emitter(em)
        ambient_medium = -1
        for med in root.children_of("medium"):
            ambient_medium = self.build_medium(med)
        n_real_emitters = len(self.em_rows)
        # pad tables to ≥1 row (the dummy emitter has zero radiance/power)
        if not self.shape_rows:
            self.shape_rows.append(dict(bsdf=self.build_bsdf(None), emitter=-1,
                                        interior_medium=-1, exterior_medium=-1, normal_tex=-1))
        if not self.em_rows:
            self.em_rows.append(dict(
                type=EmitterType.POINT, radiance=np.zeros(3, np.float32),
                position=np.zeros(3, np.float32), power=np.zeros(3, np.float32),
                direction=np.array([0, 0, 1], np.float32), cos_falloff_start=1.0,
                cos_falloff_end=1.0, angular_radius=0.0, shape=-1,
                geom_kind=EmitterGeom.NONE, tri_offset=0, tri_count=0, area=0.0,
                sphere_id=-1, light_prob=1.0, bbox_min=np.zeros(3, np.float32),
                bbox_extent=np.ones(3, np.float32), volume=1.0, medium=-1))

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
        # the LBVHs are built on the scene's device (ops/bvh.py: on CUDA by
        # csrc/lbvh.cu); every other table on the host, moved once at the end
        bvh = sph_bvh = None
        if len(tri_v0) >= bvh_mod.MIN_TRIS_FOR_BVH:
            bvh = bvh_mod.build_bvh(tri_v0, tri_v1, tri_v2, self.device)
        if len(sph_center) >= bvh_mod.MIN_SPHS_FOR_BVH:
            sph_bvh = bvh_mod.build_sphere_bvh(sph_center, sph_radius, self.device)
        geometry = Geometry(
            tri_v0=_t(tri_v0), tri_e1=_t(tri_v1 - tri_v0), tri_e2=_t(tri_v2 - tri_v0),
            tri_n0=_t(tri_n0), tri_n1=_t(tri_n1), tri_n2=_t(tri_n2),
            tri_uv0=_t(tri_uv0), tri_uv1=_t(tri_uv1), tri_uv2=_t(tri_uv2),
            tri_tang=_t(_uv_tangents(tri_v0, tri_v1, tri_v2, tri_uv0, tri_uv1, tri_uv2)),
            tri_shape=_t(tri_shape, torch.int32), sph_center=_t(sph_center),
            sph_radius=_t(sph_radius), sph_shape=_t(sph_shape, torch.int32), bvh=bvh,
            sph_bvh=sph_bvh,
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
                i = next(i for i, s in enumerate(self.spheres) if s[2] == sid)
                r = self.spheres[i][1]
                row.update(geom_kind=EmitterGeom.SPHERE, sphere_id=i, area=4.0 * math.pi * r * r)

        # ---- volume-light tables (volumelight.cpp:47-79): the governing
        # shape (the emitter's own, or the one whose interior holds its
        # medium), sampled uniformly in its ball (sphere.cpp:139-143) or bbox
        # (shape.cpp:97-101)
        for row in self.em_rows:
            if row["type"] != EmitterType.VOLUME:
                continue
            sid = row["shape"]
            if sid < 0 and row["medium"] >= 0:
                sid = next((i for i, r in enumerate(self.shape_rows)
                            if r["interior_medium"] == row["medium"]), -1)
            if sid < 0:
                raise SceneBuildError("volumelight requires a shape with an attached medium "
                                      "(volumelight.cpp:21-22)")
            row["shape"] = sid
            sph = [i for i, sp in enumerate(self.spheres) if sp[2] == sid]
            if sph:
                c, r = self.spheres[sph[0]][0], self.spheres[sph[0]][1]
                row.update(geom_kind=EmitterGeom.SPHERE, sphere_id=sph[0],
                           bbox_min=np.asarray(c - r, np.float32),
                           bbox_extent=np.full(3, 2.0 * r, np.float32),
                           volume=4.0 / 3.0 * math.pi * r**3)
            else:
                mask = tri_shape == sid
                if not mask.any():
                    raise SceneBuildError("volumelight shape has no geometry")
                pts = np.concatenate([tri_v0[mask], tri_v1[mask], tri_v2[mask]], 0)
                lo, hi = pts.min(axis=0), pts.max(axis=0)
                row.update(geom_kind=EmitterGeom.MESH, bbox_min=lo.astype(np.float32),
                           bbox_extent=(hi - lo).astype(np.float32),
                           volume=float(np.prod(np.maximum(hi - lo, 1e-20))))

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
            sphere_id=_col(self.em_rows, "sphere_id", i32),
            bbox_min=_col(self.em_rows, "bbox_min", width=3),
            bbox_extent=_col(self.em_rows, "bbox_extent", width=3),
            volume=_col(self.em_rows, "volume"),
        )
        envmap_emitter = max([-1] + [i for i, r in enumerate(self.em_rows)
                                     if r["type"] == EmitterType.ENVMAP])
        bsdfs, textures = self.bsdf_texture_tables()
        shapes = Shapes(**{k: _col(self.shape_rows, k, i32) for k in (
            "bsdf", "emitter", "interior_medium", "exterior_medium", "normal_tex")})

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
        # a scene-level <denoiser> (scene.h:41-201) is recorded, so that the
        # CLI runs its pass without a flag (build.py:934-956 of the JAX package)
        den_node = root.child("denoiser")
        denoiser, dprops = "", ()
        if den_node is not None:
            denoiser = den_node.type or "simple"
            dprops = tuple((k, v) for k, v in den_node.props.props.items()
                           if isinstance(v, (int, float, bool, str)))
        config = RenderConfig(
            width=cp.get_integer("width", 1280),
            height=cp.get_integer("height", 720),
            sample_count=sampler.props.get_integer("sampleCount", 1) if sampler else 1,
            integrator=integrator.type if integrator is not None else "normals",
            iprops=iprops,
            rfilter=rfilter,
            denoiser=denoiser,
            dprops=dprops,
            sampler=sampler.type if sampler is not None else "independent",
            # as the JAX builder: `adaptive_uniform_rounds` keeps its default
            adaptive=sampler is not None and sampler.type == "adaptive",
            n_tris=len(tri_v0),
            n_spheres=len(self.spheres),
            n_emitters=n_real_emitters,
            shadow_segments=(integrator.props.get_integer("shadowSegments", 8)
                             if integrator is not None else 8),
        )
        # the envmap's oriented lat-long grid and luminance·sinθ pixel distribution
        env_rad = (self.em_rows[envmap_emitter]["radiance"] if envmap_emitter >= 0
                   else np.zeros(3, np.float32))
        if envmap_emitter >= 0 and self.envmap_source is not None:
            envmap, envmap_pick = envmap_mod.build_tables(
                self.envmap_source["image"], env_rad, self.envmap_source["euler"])
        else:
            envmap, envmap_pick = envmap_mod.constant_tables(env_rad), dpdf_mod.build(np.ones(1))
        scene = SceneData(
            geometry=geometry, shapes=shapes, bsdfs=bsdfs, textures=textures,
            emitters=emitters, media=self.media_table(), camera=cam,
            emitter_pick=dpdf_mod.build([r["light_prob"] for r in self.em_rows]),
            envmap_emitter=envmap_emitter, envmap=envmap, envmap_pick=envmap_pick,
            ambient_medium=ambient_medium, photons=empty_photon_map(),
        )
        extras = {"integrator_props": integrator.props if integrator else None}
        return scene.to(self.device), config, extras


@tracing.traced("scene.load", setup=True)
def build_scene(root: SceneNode, device="cuda") -> tuple[SceneData, RenderConfig, dict]:
    """SceneNode tree → (SceneData, RenderConfig, extras), the scene's
    tensors on `device` (the card unless the caller asks for the CPU;
    "cuda" without a GPU raises)."""
    return _Builder(root, resolve_device(device)).build()


def load_scene(filename, device="cuda") -> tuple[SceneData, RenderConfig, dict]:
    """XML file → (SceneData, RenderConfig, extras) on `device`, as
    `build_scene`."""
    return build_scene(load_from_xml(filename), device)


def build_bsdf_table(nodes, origin=".") -> tuple[Bsdfs, Textures]:
    """The BSDF and texture tables of a list of <bsdf> nodes, row i from
    nodes[i], for the ttest / chi2test runners (ttest.cpp:128-134,
    chi2test.cpp:118-124; build.py:1015 of the JAX package)."""
    b = _Builder(SceneNode(tag="scene", type="", origin=str(origin)), torch.device("cpu"))
    for n in nodes:
        b.build_bsdf(n)
    return b.bsdf_texture_tables()
