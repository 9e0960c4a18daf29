"""Plain reference of the benchmark's renders, in PyTorch, for `correct`.

It imports nothing of the renderer under test and takes nothing it made:
it reads the scene files the benchmark wrote (XML and OBJ), builds its own
tables from them, and traces, for a sample of pixels of one render, every
camera path that render traced for them, with the same sample streams
(pcg32 seeded from tea(pixel, sample ^ seed)). So a pixel of the reference
film equals the program's to the rounding of its sums, unless a path takes
another branch on a last-bit difference (a Russian-roulette or Fresnel test
that lands within an ulp), which a sound program does on few paths.

Two estimators, as the configuration names them:

* `pathk`: the path kernel's (each sample's jitter drawn from the gaussian
  filter, so a sample adds to its own pixel with weight 1; the shadow ray
  of a bounce is resolved with the next bounce's intersections).
* `splat`: the scan path's (box jitter, then the gaussian filter's weights
  into every pixel of the sample's 4 × 4 footprint; the film divides by
  the summed weights).

The arithmetic is a frozen copy, formula for formula and in the same
order, of the renderer's plain versions at the time of the copy
(`ops/cuda/pathk.py: pathk_trace_ref`, `ops/cuda/mega.py`,
`integrators/path.py: li_path_mis`, `integrators/common.py`,
`ops/{intersect,emitter,bsdf,camera}.py`, `ops/bvh.py: mt_lanes`,
`render/film.py`, `core/rng.py`), cut to what these scenes hold: diffuse,
mirror and dielectric BSDFs with constant albedos, triangle meshes and
analytic spheres, one mesh area light, no envmap, no media, no textures,
a camera without depth of field. Departures:

* every path is one lane, traced from its camera ray to its end; the
  kernel's lanes regenerate the pixel's next sample. Each path draws the
  same numbers either way; only the order of the pixel's float32 sums
  differs (relative 1e-7).
* the closest hit of a mesh of more than 64 triangles is found by a sweep
  of the triangles whose mesh's bounding sphere the ray's line meets (the
  program walks an LBVH): the same lowest-index minimum of the
  Möller–Trumbore t, found another way.
* `dtype` sets the float type of every float tensor: float32, which the
  renderer states, for the reference; bfloat16 for the control.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

M32 = 0xFFFFFFFF
BIG = 3.4e38
EPS = 1e-4  # the ray epsilon of both paths
PI_K = 3.14159265358979  # the path kernel's π (ops/cuda/mega.py)
PI_S = 3.14159265358979323846  # the scan path's π (core/math.py)
INV_PI_K = 1.0 / PI_K
INV_PI_S = 1.0 / PI_S
BSDF_DIFFUSE, BSDF_MIRROR, BSDF_DIELECTRIC = 0, 1, 2
SMALL_MESH = 64  # meshes up to this size are swept whole, larger ones behind a bounding sphere
FILTER_RADIUS = 2.0  # gaussian, stddev 0.5 (rfilter.cpp:34-52)

where = torch.where


def big(x) -> float:
    """BIG, or the largest finite value of a narrower float type (the control's)."""
    return BIG if x.dtype in (torch.float32, torch.float64) else float(torch.finfo(x.dtype).max)


# ---------------------------------------------------------------------------
# pcg32 and tea on int64 tensors holding 32-bit words (core/rng.py)
# ---------------------------------------------------------------------------

_MULT = (0x5851F42D, 0x4C957F2D)


def _u32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def _mul_lo32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mul32_wide(a, b):
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    t = a0 * b0
    u = a1 * b0 + (t >> 16)
    v = a0 * b1 + (u & 0xFFFF)
    return (a1 * b1 + (u >> 16) + (v >> 16)) & M32, ((v << 16) | (t & 0xFFFF)) & M32


def _add64(ah, al, bh, bl):
    lo = (al + bl) & M32
    return (ah + bh + (lo < al).to(torch.int64)) & M32, lo


def _mul64_lo(ah, al, bh, bl):
    hi, lo = _mul32_wide(al, bl)
    return (hi + _mul_lo32(al, bh) + _mul_lo32(ah, bl)) & M32, lo


def _step(s):
    hi, lo = _mul64_lo(s[0], s[1], _MULT[0], _MULT[1])
    hi, lo = _add64(hi, lo, s[2], s[3])
    return (hi, lo, s[2], s[3])


def next_float(s, dtype):
    """pcg32 nextFloat: (state', u in [0, 1) as `dtype`)."""
    hi, lo = s[0], s[1]
    x_hi = hi ^ (hi >> 18)
    x_lo = lo ^ (((hi << 14) & M32) | (lo >> 18))
    xs = ((x_hi << 5) & M32) | (x_lo >> 27)
    rot = hi >> 27
    bits = ((xs >> rot) | (xs << ((-rot) & 31))) & M32
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return _step(s), u.to(dtype)


def _tea(v0, v1, rounds: int = 4):
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) & M32) + 0xA341316C) ^ ((v1 + s0) & M32)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & M32
        v1 = (v1 + ((((v0 << 4) & M32) + 0xAD90777D) ^ ((v0 + s0) & M32)
                    ^ ((v0 >> 5) + 0x7E95761E))) & M32
    return v0


def seed_lanes(pix, sample, seed: int):
    """pcg32 per lane: initstate = tea(pixel, sample ^ seed), initseq = pixel."""
    pix, sample = _u32(pix), _u32(sample)
    h = _tea(pix, sample ^ (seed & M32))
    z = torch.zeros_like(h)
    inc_hi = ((z << 1) & M32) | (pix >> 31)
    inc_lo = ((pix << 1) & M32) | 1
    s = _step((z, z, inc_hi, inc_lo))
    hi, lo = _add64(s[0], s[1], z, h)
    return _step((hi, lo, inc_hi, inc_lo))


def draws(s, n, dtype):
    out = []
    for _ in range(n):
        s, u = next_float(s, dtype)
        out.append(u)
    return s, out


# ---------------------------------------------------------------------------
# the scene, from the files the benchmark wrote
# ---------------------------------------------------------------------------


def _floats(s):
    return np.array([float(t) for t in re.split(r"[,\s]+", s.strip()) if t], np.float64)


def _lookat(origin, target, up):
    """Camera to world, float64 (parser.cpp:341-357)."""
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, origin
    return m


def _read_obj(path: Path):
    """Triangles of an OBJ of `v x y z` and `f a b c [d]` lines (positions
    only), as [T, 3, 3] float32; a quad splits as (1, 2, 3) + (4, 1, 3)."""
    vs, tris = [], []
    for line in path.read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "v":
            vs.append(line)
        elif tok[0] == "f":
            ids = [int(t.split("/")[0]) - 1 for t in tok[1:5]]
            tris.append(ids[:3])
            if len(ids) == 4:
                tris.append([ids[3], ids[0], ids[2]])
    pos = np.array(" ".join(v[1:] for v in vs).split(), np.float64).reshape(-1, 3)
    return pos.astype(np.float32)[np.asarray(tris, np.int64)]


@dataclass
class Scene:
    """The reference's tables on one device, in one float type."""

    width: int
    height: int
    max_depth: int
    # triangles [T, 3] and per-triangle attributes
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor  # geometric normal (the meshes carry no normals)
    tri_shape: torch.Tensor  # int64
    groups: list  # (first, end, bounding centre, bounding radius or None) per mesh
    # per shape: bsdf type, albedo (AOV and diffuse), iors, emitter id
    shape_btype: torch.Tensor
    shape_albedo: torch.Tensor  # 1 where the BSDF has no albedo texture
    shape_int_ior: torch.Tensor
    shape_ext_ior: torch.Tensor
    shape_emitter: torch.Tensor  # int64, −1 none
    # spheres (python floats, as the kernel's table reads them)
    spheres: list  # (cx, cy, cz, r, btype, albedo rgb, int_ior, ext_ior)
    # the light: radiance, total area, its triangles and their area CDF
    radiance: torch.Tensor  # [3]
    area: float
    light_tris: list  # global triangle ids
    light_cdf: list  # float32 values as python floats
    # camera
    s2c: torch.Tensor  # [4, 4] sample to camera, float32 made on the host
    to_world: torch.Tensor  # [4, 4]
    near: float
    far: float
    dtype: torch.dtype
    device: torch.device


def load_scene(xml_path, device="cpu", dtype=torch.float32) -> Scene:
    """Build the reference's tables from the scene files at `xml_path`."""
    xml_path = Path(xml_path)
    root = ET.parse(str(xml_path)).getroot()
    f32 = np.float32

    def props(node):
        out = {}
        for ch in node:
            name, val = ch.get("name"), ch.get("value")
            if ch.tag == "integer":
                out[name] = int(val)
            elif ch.tag == "float":
                out[name] = float(val)
            elif ch.tag == "string":
                out[name] = val
            elif ch.tag in ("color", "point", "vector"):
                out[name] = _floats(val).astype(f32)
        return out

    integrator = root.find("integrator").get("type")
    if integrator != "path_mis":
        raise ValueError(f"the reference traces path_mis, not {integrator}")
    cam = root.find("camera")
    cp = props(cam)
    la = cam.find("transform").find("lookat")
    to_world = _lookat(*(_floats(la.get(k)) for k in ("origin", "target", "up")))
    rf = cam.find("rfilter")
    rfilter = rf.get("type") if rf is not None else "gaussian"
    if rfilter != "gaussian":
        raise ValueError(f"the reference has the gaussian filter only, not {rfilter}")

    tri_list, tri_shape, groups = [], [], []
    shapes, textures, spheres = [], [], []
    light = None
    for sid, sh in enumerate(root.findall("shape")):
        b = sh.find("bsdf")
        btype = {"diffuse": BSDF_DIFFUSE, "mirror": BSDF_MIRROR,
                 "dielectric": BSDF_DIELECTRIC}[b.get("type")]
        bp = props(b)
        tex = -1
        if btype == BSDF_DIFFUSE:
            textures.append(bp.get("albedo", np.full(3, 0.5, f32)).astype(f32))
            tex = len(textures) - 1
        row = {"btype": btype, "tex": tex,
               "int_ior": bp.get("intIOR", 1.5046) if btype == BSDF_DIELECTRIC else 1.5046,
               "ext_ior": bp.get("extIOR", 1.000277) if btype == BSDF_DIELECTRIC else 1.000277,
               "emitter": -1}
        em = sh.find("emitter")
        if em is not None:
            if em.get("type") != "area" or light is not None:
                raise ValueError("the reference has one mesh area light")
            row["emitter"] = 0
            light = {"shape": sid, "radiance": props(em)["radiance"]}
        shapes.append(row)
        p = props(sh)
        if sh.get("type") == "obj":
            tris = _read_obj(xml_path.parent / p["filename"])
            first = sum(len(t) for t in tri_list)
            tri_list.append(tris)
            tri_shape.append(np.full(len(tris), sid, np.int64))
            if len(tris) > SMALL_MESH:
                pts = tris.reshape(-1, 3).astype(np.float64)
                c = 0.5 * (pts.min(0) + pts.max(0))
                r = float(np.sqrt(((pts - c) ** 2).sum(1)).max()) * 1.001 + 1e-3
                groups.append((first, first + len(tris), c, r))
            else:
                groups.append((first, first + len(tris), None, None))
        elif sh.get("type") == "sphere":
            spheres.append((sid, p["center"].astype(f32), f32(p["radius"])))
        else:
            raise ValueError(f"unknown shape {sh.get('type')}")
    if light is None:
        raise ValueError("the reference needs the scene's area light")

    tris = np.concatenate(tri_list)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    shape_of = np.concatenate(tri_shape)
    # the geometric normal, mesh by mesh as the loader takes it
    gn = np.cross(v1 - v0, v2 - v0)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    # the light's triangle CDF (mesh.cpp:15-46)
    mask = shape_of == light["shape"]
    a = 0.5 * np.linalg.norm(np.cross(v1[mask] - v0[mask], v2[mask] - v0[mask]), axis=-1)
    total = float(a.sum())
    cdf = np.cumsum(a / max(total, 1e-20))

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device)
    tf = lambda x: t(np.asarray(x, f32)).to(dtype)
    alb_k = [textures[s["tex"]] if s["tex"] >= 0 else np.ones(3, f32) for s in shapes]
    sph = [(float(c[0]), float(c[1]), float(c[2]), float(r), shapes[sid]["btype"],
            tuple(float(x) for x in alb_k[sid]), float(f32(shapes[sid]["int_ior"])),
            float(f32(shapes[sid]["ext_ior"]))) for sid, c, r in spheres]

    # the sample-to-camera matrix, float32 on the host (ops/camera.py)
    far, near = torch.tensor(1e4, dtype=torch.float32), torch.tensor(1e-4, dtype=torch.float32)
    w, h = cp["width"], cp["height"]
    recip = 1.0 / (far - near)
    cot = 1.0 / torch.tan(torch.tensor(cp.get("fov", 30.0), dtype=torch.float32)
                          * (PI_K / 180.0) / 2.0)
    persp = torch.zeros((4, 4), dtype=torch.float32)
    persp[0, 0] = cot
    persp[1, 1] = cot
    persp[2, 2] = far * recip
    persp[2, 3] = -near * far * recip
    persp[3, 2] = 1.0
    screen = torch.tensor([[0.5, 0, 0, 0.5], [0, -0.5 * (w / h), 0, 0.5], [0, 0, 1, 0],
                           [0, 0, 0, 1]], dtype=torch.float32)
    s2c = torch.linalg.inv(screen @ persp)

    return Scene(
        width=w, height=h, max_depth=0,
        v0=tf(v0), e1=tf(v1 - v0), e2=tf(v2 - v0), n0=tf(gn), tri_shape=t(shape_of),
        groups=groups,
        shape_btype=t(np.array([s["btype"] for s in shapes], np.int64)),
        shape_albedo=tf(np.stack(alb_k)),
        shape_int_ior=tf([s["int_ior"] for s in shapes]),
        shape_ext_ior=tf([s["ext_ior"] for s in shapes]),
        shape_emitter=t(np.array([s["emitter"] for s in shapes], np.int64)),
        spheres=sph, radiance=tf(light["radiance"]), area=float(f32(total)),
        light_tris=[int(i) for i in np.nonzero(mask)[0]],
        light_cdf=[float(x) for x in cdf.astype(f32)],
        s2c=s2c, to_world=torch.as_tensor(to_world.astype(f32)),
        near=float(near), far=float(far), dtype=dtype, device=torch.device(device))


# ---------------------------------------------------------------------------
# vector helpers on (x, y, z) triples (ops/cuda/mega.py)
# ---------------------------------------------------------------------------


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vwhere(m, a, b):
    return (where(m, a[0], b[0]), where(m, a[1], b[1]), where(m, a[2], b[2]))


def vnormalize(a):
    return vscale(a, torch.rsqrt(torch.clamp(vdot(a, a), min=1e-24)))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def onb(n):
    nx, ny, nz = n
    sign = where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (1.0 + sign * nx * nx * a, sign * b, -sign * nx), (b, sign + ny * ny * a, -ny)


def to_local(sf, tf, nf, w):
    return (vdot(sf, w), vdot(tf, w), vdot(nf, w))


def to_world(sf, tf, nf, wl):
    return (sf[0] * wl[0] + tf[0] * wl[1] + nf[0] * wl[2],
            sf[1] * wl[0] + tf[1] * wl[1] + nf[1] * wl[2],
            sf[2] * wl[0] + tf[2] * wl[1] + nf[2] * wl[2])


def fresnel(cos_i, ext_ior, int_ior):
    ei = where(cos_i >= 0.0, ext_ior, int_ior)
    et = where(cos_i >= 0.0, int_ior, ext_ior)
    ci = torch.abs(cos_i)
    eta = ei / et
    sin_t2 = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    ct = safe_sqrt(1.0 - sin_t2)
    rs = (ei * ci - et * ct) / torch.clamp(torch.abs(ei * ci + et * ct), min=1e-12)
    rp = (et * ci - ei * ct) / torch.clamp(torch.abs(et * ci + ei * ct), min=1e-12)
    return where(sin_t2 >= 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


# ---------------------------------------------------------------------------
# intersections
# ---------------------------------------------------------------------------


def mt(o, d, v0, e1, e2):
    """Möller–Trumbore (ops/bvh.py: mt_lanes), all [..., 3] → t, u, v, hit."""
    px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
    py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
    pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    det_ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(det_ok, det, 1e-12)
    tx = o[..., 0] - v0[..., 0]
    ty = o[..., 1] - v0[..., 1]
    tz = o[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (d[..., 0] * qx + d[..., 1] * qy + d[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    return t, u, v, det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


PAIRS = 1 << 24  # ray-triangle pairs per chunk


def _sweep(S, o, d, mint, cutoff, any_hit: bool):
    """Closest hit (lowest-index minimum of t in [mint, cutoff)) or any hit
    over the triangles, group by group; o, d [N, 3]. Returns (ids int64
    with −1 for none, t) or the occluded mask."""
    n = o.shape[0]
    best_t = cutoff.clone()
    best_id = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    occl = torch.zeros(n, dtype=torch.bool, device=o.device)
    for first, end, c, r in S.groups:
        if c is None:
            lanes = torch.arange(n, device=o.device)
        else:
            # rays whose line meets the mesh's bounding sphere (float64)
            oc = o.double() - torch.as_tensor(c, device=o.device)
            dd = d.double()
            b = (oc * dd).sum(-1)
            disc = b * b - (dd * dd).sum(-1) * ((oc * oc).sum(-1) - r * r)
            lanes = torch.nonzero(disc >= 0.0).squeeze(1)
            if any_hit:
                lanes = lanes[~occl[lanes]]
        if lanes.numel() == 0:
            continue
        oo, dl, mn = o[lanes], d[lanes], mint[lanes]
        bt, bi = best_t[lanes], best_id[lanes]
        oc_ = torch.zeros(lanes.numel(), dtype=torch.bool, device=o.device)
        chunk = max(1, min(end - first, PAIRS // lanes.numel()))
        rows = torch.arange(lanes.numel(), device=o.device)
        for c0 in range(first, end, chunk):
            c1 = min(c0 + chunk, end)
            t, _, _, h = mt(oo[:, None, :], dl[:, None, :], S.v0[None, c0:c1],
                            S.e1[None, c0:c1], S.e2[None, c0:c1])
            if any_hit:
                oc_ |= (h & (t >= mn[:, None]) & (t < cutoff[lanes][:, None])).any(dim=1)
                continue
            h = h & (t >= mn[:, None]) & (t < bt[:, None])
            tm = torch.where(h, t, big(t))
            j = torch.argmin(tm, dim=1)
            tj = tm[rows, j]
            better = tj < bt
            bt = torch.where(better, tj, bt)
            bi = torch.where(better, j + c0, bi)
        if any_hit:
            occl[lanes] |= oc_
        else:
            best_t[lanes], best_id[lanes] = bt, bi
    return occl if any_hit else (best_id, best_t)


def _sphere_hit(S, o, d, mint, cutoff):
    """Stable quadratic against the spheres (ops/cuda/mega.py: sphere_hit)."""
    best_t = cutoff
    best_id = torch.full_like(cutoff, -1, dtype=torch.int64)
    a = vdot(d, d)
    for j, (cx, cy, cz, r, *_rest) in enumerate(S.spheres):
        oc = (o[0] - cx, o[1] - cy, o[2] - cz)
        b = 2.0 * vdot(oc, d)
        c = vdot(oc, oc) - r * r
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = safe_sqrt(disc)
        q = -0.5 * (b + torch.sign(b) * sq)
        t0 = q / a
        t1 = c / where(torch.abs(q) > 1e-20, q, 1e-20)
        tn, tf_ = torch.minimum(t0, t1), torch.maximum(t0, t1)
        in_n = ok & (tn >= mint) & (tn < best_t)
        in_f = ok & (tf_ >= mint) & (tf_ < best_t)
        t_c = where(in_n, tn, where(in_f, tf_, big(tn)))
        better = t_c < best_t
        best_t = where(better, t_c, best_t)
        best_id = where(better, j, best_id)
    return best_t, best_id


# ---------------------------------------------------------------------------
# the path kernel's estimator (ops/cuda/pathk.py: pathk_trace_ref, path_mis)
# ---------------------------------------------------------------------------


def _bsdf_k(P, wi, wo):
    """f and pdf of the kernel's BSDF switch for diffuse / mirror / dielectric."""
    diff_ok = (wi[2] > 0.0) & (wo[2] > 0.0)
    is_d = P["btype"] == BSDF_DIFFUSE
    f = tuple(where(is_d, where(diff_ok, P["albedo"][c] * INV_PI_K, 0.0), 0.0) for c in range(3))
    pdf = where(is_d, where(diff_ok, INV_PI_K * wo[2], 0.0), 0.0)
    return f, pdf


def _bsdf_sample_k(P, wi, u1, u2):
    cos_i = wi[2]
    one = torch.ones_like(cos_i)
    rho = torch.sqrt(torch.clamp(u1, min=0.0))
    th = u2 * (2.0 * PI_K)
    x, y = rho * torch.cos(th), rho * torch.sin(th)
    wo_diff = (x, y, safe_sqrt(1.0 - (x * x + y * y)))
    w_diff = tuple(where(cos_i > 0.0, P["albedo"][c], 0.0) for c in range(3))
    wo_mirror = (-wi[0], -wi[1], wi[2])
    w_mirror = (where(cos_i > 0.0, one, 0.0),) * 3
    fr = fresnel(cos_i, P["ext_ior"], P["int_ior"])
    reflect_event = u1 < fr
    entering = cos_i >= 0.0
    eta_ratio = where(entering, P["ext_ior"] / P["int_ior"], P["int_ior"] / P["ext_ior"])
    nz = where(entering, 1.0, -1.0).to(cos_i.dtype)
    wi_dot_n = wi[2] * nz
    sq = safe_sqrt(1.0 - eta_ratio * eta_ratio * (1.0 - wi_dot_n * wi_dot_n))
    wo_refr = (-eta_ratio * wi[0], -eta_ratio * wi[1],
               -eta_ratio * (wi[2] - wi_dot_n * nz) - sq * nz)
    wo_diel = vwhere(reflect_event, wo_mirror, wo_refr)
    w_diel = (where(reflect_event, 1.0, 1.0 / (eta_ratio * eta_ratio)),) * 3
    is_mirror = P["btype"] == BSDF_MIRROR
    is_diel = P["btype"] == BSDF_DIELECTRIC
    wo = vwhere(is_mirror, wo_mirror, vwhere(is_diel, wo_diel, wo_diff))
    weight = tuple(where(is_mirror, w_mirror[c], where(is_diel, w_diel[c], w_diff[c]))
                   for c in range(3))
    is_discrete = is_mirror | is_diel
    pdf_cont = where((P["btype"] == BSDF_DIFFUSE) & (cos_i > 0.0),
                     INV_PI_K * torch.clamp(wo[2], min=0.0), 0.0)
    return wo, weight, where(is_discrete, 0.0, pdf_cont), is_discrete


def _camera_k(S, sf, px, py, st, dt):
    """The kernel's camera ray: gaussian filter-importance-sampled jitter."""
    st, (uj1, uj2) = draws(st, 2, dt)
    st, _aperture = draws(st, 2, dt)
    r_ = 0.5 * torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - uj1, min=1e-12)))
    th = 2.0 * PI_K * uj2
    jx = torch.clamp(r_ * torch.cos(th), -FILTER_RADIUS, FILTER_RADIUS) + 0.5
    jy = torch.clamp(r_ * torch.sin(th), -FILTER_RADIUS, FILTER_RADIUS) + 0.5
    x = (px + jx) * sf[36]
    y = (py + jy) * sf[37]
    m = lambda i, j: sf[i * 4 + j]
    nx = m(0, 0) * x + m(0, 1) * y + m(0, 3)
    ny = m(1, 0) * x + m(1, 1) * y + m(1, 3)
    nz = m(2, 0) * x + m(2, 1) * y + m(2, 3)
    wq = m(3, 0) * x + m(3, 1) * y + m(3, 3)
    inv_w = 1.0 / wq
    dl = vnormalize((nx * inv_w, ny * inv_w, nz * inv_w))
    o_cam = (torch.zeros_like(dl[0]),) * 3
    tm = lambda i, j: sf[16 + i * 4 + j]
    o = tuple(tm(r, 0) * o_cam[0] + tm(r, 1) * o_cam[1] + tm(r, 2) * o_cam[2] + tm(r, 3)
              for r in range(3))
    d = tuple(tm(r, 0) * dl[0] + tm(r, 1) * dl[1] + tm(r, 2) * dl[2] for r in range(3))
    inv_z = 1.0 / dl[2]
    return st, o, d, sf[34] * inv_z, sf[35] * inv_z


def trace_pathk(S: Scene, pix, sample, seed: int, counts: dict | None = None):
    """Each lane's path by the kernel's estimator → (ΣL [3], first-hit albedo
    [3], first-hit normal [3]) as (x, y, z) triples of [N] tensors. With
    `counts`, adds the closest-hit segments traced to counts["segments"]."""
    dt, dev = S.dtype, S.device
    n = pix.shape[0]
    n_lights = 1
    sf = (S.s2c.reshape(-1).tolist() + S.to_world.reshape(-1).tolist()
          + [0.0, 10.0, S.near, S.far, float(np.float32(1.0 / S.width)),
             float(np.float32(1.0 / S.height))])
    px = (pix % S.width).to(dt)
    py = (pix // S.width).to(dt)
    zero = torch.zeros(n, dtype=dt, device=dev)
    one = torch.ones_like(zero)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    st, o, d, mint, maxt = _camera_k(S, sf, px, py, seed_lanes(pix, sample, seed), dt)
    depth, active = zero, ~false
    tr, tg, tb = one, one, one
    pdf_prev, prev_disc = zero, false
    sh_o, sh_d, sh_dist, sh_pend = (zero, zero, zero), (zero, zero, one), -one, false
    sh_c = (zero, zero, zero)
    aL = aA = aN = (zero, zero, zero)
    radiance = S.radiance.tolist()
    cdf = S.light_cdf
    lt = torch.as_tensor(S.light_tris, device=dev)
    while bool((active | sh_pend).any()):
        was = active
        first = depth < 0.5
        if counts is not None:
            counts["segments"] = counts.get("segments", 0) + int(was.sum())
        O, D = torch.stack(o, -1), torch.stack(d, -1)
        # only the lanes whose results count: the closest hit of a path in
        # flight, the any hit of a queued shadow ray
        best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
        t_tri = maxt.clone()
        k_c = torch.nonzero(active).squeeze(1)
        if k_c.numel():
            best_id[k_c], t_tri[k_c] = _sweep(S, O[k_c], D[k_c], mint[k_c], maxt[k_c], False)
        occ_tri = torch.zeros(n, dtype=torch.bool, device=dev)
        k_s = torch.nonzero(sh_pend).squeeze(1)
        if k_s.numel():
            occ_tri[k_s] = _sweep(S, torch.stack(sh_o, -1)[k_s], torch.stack(sh_d, -1)[k_s],
                                  torch.full_like(sh_dist[k_s], EPS), sh_dist[k_s], True)
        tri_valid = best_id >= 0
        gid = best_id.clamp(min=0)
        _, u, v, _ = mt(O, D, S.v0[gid], S.e1[gid], S.e2[gid])
        u, v = where(tri_valid, u, 0.0), where(tri_valid, v, 0.0)
        sid_tri = S.tri_shape[gid]
        P = {"btype": where(tri_valid, S.shape_btype[sid_tri], 0),
             "albedo": tuple(where(tri_valid, S.shape_albedo[sid_tri, c], 0.0)
                             for c in range(3)),
             "int_ior": where(tri_valid, S.shape_int_ior[sid_tri], 0.0),
             "ext_ior": where(tri_valid, S.shape_ext_ior[sid_tri], 0.0)}
        _, s_sid = _sphere_hit(S, sh_o, sh_d, torch.full_like(mint, EPS), sh_dist)
        occ = occ_tri | (s_sid >= 0)
        vis = sh_pend & ~occ
        aL = tuple(aL[c] + where(vis, sh_c[c], 0.0) for c in range(3))
        sh_pend = false

        t_sph, sid = _sphere_hit(S, o, d, mint, t_tri)
        sphere_wins = sid >= 0
        t_best = where(sphere_wins, t_sph, t_tri)
        valid = tri_valid | sphere_wins
        n_tri = tuple(where(tri_valid, S.n0[gid, c], 0.0) for c in range(3))
        ns = vnormalize(tuple(n_tri[c] + u * 0.0 + v * 0.0 for c in range(3)))
        p_hit = vadd(o, vscale(d, where(valid, t_best, 1.0)))
        if S.spheres:
            is_s = sphere_wins
            k = sid.clamp(min=0)
            col = lambda f: torch.as_tensor([f(s) for s in S.spheres], dtype=dt, device=dev)[k]
            P = {"btype": where(is_s, torch.as_tensor([s[4] for s in S.spheres],
                                                      device=dev)[k], P["btype"]),
                 "albedo": tuple(where(is_s, col(lambda s, c=c: s[5][c]), P["albedo"][c])
                                 for c in range(3)),
                 "int_ior": where(is_s, col(lambda s: s[6]), P["int_ior"]),
                 "ext_ior": where(is_s, col(lambda s: s[7]), P["ext_ior"])}
            inv_r = 1.0 / torch.clamp(col(lambda s: s[3]), min=1e-12)
            ctr = [col(lambda s, c=c: s[c]) for c in range(3)]
            ns = tuple(where(is_s, (p_hit[c] - ctr[c]) * inv_r, ns[c]) for c in range(3))
        sf_, tf_ = onb(ns)
        em_id = where(tri_valid & ~sphere_wins, S.shape_emitter[sid_tri], -1)

        active = active & valid
        firstm = first & valid
        aA = tuple(aA[c] + where(firstm, P["albedo"][c], 0.0) for c in range(3))
        aN = tuple(aN[c] + where(firstm, ns[c], 0.0) for c in range(3))

        hit_em = active & (em_id >= 0)
        ok_e = em_id == 0
        er, eg, eb = (where(ok_e, radiance[c], 0.0).to(dt) for c in range(3))
        add_em = hit_em & (vdot(ns, vneg(d)) >= 0.0)
        area_tot = where(ok_e, S.area, 0.0).to(dt)
        cos_e = vdot(ns, vneg(vnormalize(d)))
        to_hit = vsub(p_hit, o)
        dist2 = vdot(to_hit, to_hit)
        pdf_ems_here = where(hit_em & (cos_e > 0.0),
                             (1.0 / torch.clamp(area_tot, min=1e-20)) * dist2
                             / torch.clamp(torch.abs(cos_e), min=1e-12) / n_lights, 0.0)
        denom = pdf_prev + pdf_ems_here
        w_mats = where(first | prev_disc, 1.0, where(
            denom > EPS, pdf_prev / torch.clamp(denom, min=1e-20), 1.0))
        ae = where(add_em, w_mats, 0.0)
        aL = (aL[0] + ae * tr * er, aL[1] + ae * tg * eg, aL[2] + ae * tb * eb)

        st, (u_rr,) = draws(st, 1, dt)
        succ = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)), EPS, 0.99)
        die = (u_rr > succ) & active
        inv_s = 1.0 / succ
        tr, tg, tb = (where(active, x * inv_s, x) for x in (tr, tg, tb))
        active = active & ~die

        wi_l = to_local(sf_, tf_, ns, vneg(vnormalize(d)))
        # NEE: the light's triangle by its area CDF, a uniform point on it
        st, (u_pick,) = draws(st, 1, dt)
        st, (ua, ub, _uc) = draws(st, 3, dt)
        eid = torch.zeros_like(u_pick, dtype=torch.int64)
        sel = torch.full_like(eid, -1)
        for k_, c_k in enumerate(cdf):
            sel = where((sel < 0) & (eid == 0) & (c_k > ua), k_, sel)
        found = sel >= 0
        kk = sel.clamp(min=0)
        tid = lt[kk]
        c_hi = torch.as_tensor(cdf, dtype=dt, device=dev)[kk]
        c_lo = torch.as_tensor([0.0] + cdf[:-1], dtype=dt, device=dev)[kk]
        fz = lambda x: where(found, x, 0.0)
        tv0 = tuple(fz(S.v0[tid, c]) for c in range(3))
        te1 = tuple(fz(S.e1[tid, c]) for c in range(3))
        te2 = tuple(fz(S.e2[tid, c]) for c in range(3))
        tn0 = tuple(fz(S.n0[tid, c]) for c in range(3))
        c_hi, c_lo = fz(c_hi), fz(c_lo)
        ua_re = torch.clamp((ua - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12), 0.0, 1.0 - 1e-7)
        su = torch.sqrt(torch.clamp(ua_re, min=0.0))
        b1 = ub * su
        b2 = 1.0 - (1.0 - su) - b1
        zero3 = (zero, zero, zero)
        p_surf = vadd(tv0, vadd(vscale(te1, b1), vscale(te2, b2)))
        n_surf = vnormalize(vadd(tn0, vadd(vscale(zero3, b1), vscale(zero3, b2))))
        to_p = vsub(p_surf, p_hit)
        dist2 = torch.clamp(vdot(to_p, to_p), min=1e-20)
        dist = torch.sqrt(dist2)
        wi_w = vscale(to_p, 1.0 / dist)
        cos_em = vdot(n_surf, vneg(wi_w))
        inv_area = 1.0 / torch.clamp(zero + S.area, min=1e-20)
        pdf_area = inv_area * dist2 / torch.clamp(torch.abs(cos_em), min=1e-12)
        ok_area = (cos_em > 0.0) & (pdf_area > EPS) & found
        inv_pdf = where(ok_area, 1.0 / torch.clamp(pdf_area, min=1e-12), 0.0)
        value = tuple(radiance[c] * inv_pdf for c in range(3))
        pdf_sa = where(ok_area, pdf_area, 0.0)
        shadow_dist = dist - EPS

        wi_light_l = to_local(sf_, tf_, ns, wi_w)
        nz_val = ((torch.abs(value[0]) > EPS) | (torch.abs(value[1]) > EPS)
                  | (torch.abs(value[2]) > EPS))
        cand = nz_val & valid & active
        f_l, pdf_l = _bsdf_k(P, wi_l, wi_light_l)
        cos_l = vdot(wi_w, ns)
        pdf_mat_at = where(cand, pdf_l, 0.0)
        pdf_ems = where(cand, pdf_sa / n_lights, 0.0)
        contrib = tuple(where(cand, value[c] * cos_l * f_l[c] * n_lights, 0.0) for c in range(3))
        w_ems = where(pdf_ems + pdf_mat_at > EPS,
                      pdf_ems / torch.clamp(pdf_ems + pdf_mat_at, min=1e-20), 0.0)
        st, (um1, um2) = draws(st, 2, dt)
        wo_l, bw, bpdf, bdisc = _bsdf_sample_k(P, wi_l, um1, um2)
        amask = where(cand, where(bdisc, 0.0, w_ems), 0.0)
        sh_pend = ((amask * contrib[0] != 0.0) | (amask * contrib[1] != 0.0)
                   | (amask * contrib[2] != 0.0))
        sh_c = (amask * tr * contrib[0], amask * tg * contrib[1], amask * tb * contrib[2])
        sh_o, sh_d, sh_dist = p_hit, wi_w, shadow_dist
        tr, tg, tb = (where(active, x * bw[c], x) for c, x in enumerate((tr, tg, tb)))
        active = active & ((torch.abs(tr) > 1e-12) | (torch.abs(tg) > 1e-12)
                           | (torch.abs(tb) > 1e-12))
        wo_w = to_world(sf_, tf_, ns, wo_l)
        o = vwhere(active, p_hit, o)
        d = vwhere(active, wo_w, d)
        mint = where(active, EPS, mint)
        maxt = where(active, big(maxt), maxt)
        depth = depth + 1.0
        end = was & (~active | (depth > S.max_depth - 0.5))
        active = active & ~end
        pdf_prev, prev_disc = bpdf, bdisc
    return aL, aA, aN


# ---------------------------------------------------------------------------
# the scan path's estimator (integrators/path.py: li_path_mis)
# ---------------------------------------------------------------------------


def _normalize(a):
    n2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2])[..., None]
    return a * torch.where(n2 > 1e-20, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)), 0.0)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _frame(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t, n


def _local(f, v):
    return torch.stack([_dot(v, f[0]), _dot(v, f[1]), _dot(v, f[2])], dim=-1)


def _world(f, v):
    return f[0] * v[..., 0:1] + f[1] * v[..., 1:2] + f[2] * v[..., 2:3]


def _xform_point(m, p):
    r = [p[:, 0] * m[i, 0] + p[:, 1] * m[i, 1] + p[:, 2] * m[i, 2] + m[i, 3] for i in range(4)]
    return torch.stack(r[:3], dim=-1) / r[3][:, None]


def _intersect_s(S, o, d, mint, maxt, lanes):
    """The scan path's closest hit on `lanes`: the winner's id, then t, u, v
    recomputed by Möller–Trumbore (ops/intersect.py: intersect)."""
    n = o.shape[0]
    best_t = torch.where(torch.isinf(maxt), big(maxt), maxt)
    ids = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if lanes.numel():
        ids[lanes] = _sweep(S, o[lanes], d[lanes], mint[lanes], best_t[lanes], False)[0]
    found = ids >= 0
    gid = ids.clamp(min=0)
    t_r, u_r, v_r, _ = mt(o, d, S.v0[gid], S.e1[gid], S.e2[gid])
    return (found, torch.where(found, t_r, best_t), torch.where(found, u_r, 0.0),
            torch.where(found, v_r, 0.0), gid)


def trace_scan(S: Scene, pix, sample, seed: int):
    """Each lane's sample by the scan path → (pos [N, 2], L, albedo, normal
    [N, 3]): `render._round_layers` with `li_path_mis`."""
    if S.spheres:
        raise ValueError("the scan-path reference has no analytic spheres")
    dt, dev = S.dtype, S.device
    n = pix.shape[0]
    n_lights = 1.0
    st = seed_lanes(pix, sample, seed)
    st, (j1, j2) = draws(st, 2, dt)
    st, _aperture = draws(st, 2, dt)
    pos = torch.stack([(pix % S.width).to(dt), (pix // S.width).to(dt)], dim=-1) \
        + torch.stack([j1, j2], dim=-1)
    s2c = S.s2c.to(device=dev, dtype=dt)
    near_p = _xform_point(s2c, torch.stack(
        [pos[:, 0] / S.width, pos[:, 1] / S.height, torch.zeros_like(pos[:, 0])], dim=-1))
    d_local = _normalize(near_p)
    tw = S.to_world.to(device=dev, dtype=dt)
    ro = _xform_point(tw, torch.zeros_like(d_local))
    rd = torch.stack([d_local[:, 0] * tw[i, 0] + d_local[:, 1] * tw[i, 1]
                      + d_local[:, 2] * tw[i, 2] for i in range(3)], dim=-1)
    inv_z = 1.0 / d_local[:, 2]
    mint0, maxt0 = torch.tensor(S.near, dtype=dt) * inv_z, torch.tensor(S.far, dtype=dt) * inv_z

    t = torch.ones((n, 3), dtype=dt, device=dev)
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    pdf_prev = torch.zeros(n, dtype=dt, device=dev)
    prev_disc = torch.zeros(n, dtype=torch.bool, device=dev)
    w_mats_prev = torch.ones(n, dtype=dt, device=dev)
    albedo = normal = None
    cdf = torch.as_tensor(S.light_cdf, dtype=dt, device=dev)
    lt = torch.as_tensor(S.light_tris, device=dev)
    rad = S.radiance.to(dev)
    area = torch.tensor(S.area, dtype=dt, device=dev)
    for bounce in range(S.max_depth):
        first = bounce == 0
        mint = mint0 if first else torch.full_like(mint0, EPS)
        maxt = maxt0 if first else torch.full_like(maxt0, float("inf"))
        valid, t_hit, u, v, gid = _intersect_s(S, ro, rd, mint, maxt,
                                               torch.nonzero(active).squeeze(1))
        t_safe = torch.where(valid, t_hit, 1.0)
        p = ro + rd * t_safe[..., None]
        w = 1.0 - u - v
        n0 = S.n0[gid]
        n_s = _normalize(n0 * w[..., None] + n0 * u[..., None] + n0 * v[..., None])
        n_s = torch.where(valid[..., None], n_s, 0.0)
        shape = torch.where(valid, S.tri_shape[gid], 0)
        btype = torch.where(valid, S.shape_btype[shape], S.shape_btype[0])
        alb = S.shape_albedo[torch.where(valid, shape, 0)]
        emitter_id = torch.where(valid, S.shape_emitter[shape], -1)
        frame = _frame(_normalize(n_s))

        active = active & valid
        if first:
            albedo = torch.where(valid[..., None], alb, 0.0)
            normal = torch.where(valid[..., None], frame[2], 0.0)

        hit_em = active & (emitter_id >= 0)
        wi_n = _normalize(rd)
        cos_e = _dot(frame[2], -wi_n)
        dist2 = _dot(p - ro, p - ro)
        pdf_area = torch.where(cos_e > 0.0, (1.0 / torch.clamp(area, min=1e-20)) * dist2
                               / torch.clamp(torch.abs(cos_e), min=1e-12), 0.0)
        pdf_ems_here = torch.where(emitter_id >= 0, pdf_area, 0.0) / n_lights
        denom = pdf_prev + pdf_ems_here
        w_mats = torch.where(denom > EPS, pdf_prev / torch.clamp(denom, min=1e-20), w_mats_prev)
        w_mats = torch.where(prev_disc | first, 1.0, w_mats)
        front = _dot(frame[2], -wi_n) >= 0.0
        le = torch.where(front[..., None], rad, 0.0)
        le = torch.where(emitter_id[..., None] >= 0, le, 0.0)
        L = L + torch.where(hit_em[..., None], w_mats[..., None] * t * le, 0.0)

        st, (u_rr,) = draws(st, 1, dt)
        succ = torch.clamp(torch.amax(t, dim=-1), EPS, 0.99)
        die = (u_rr > succ) & active
        t = torch.where(active[..., None], t / succ[..., None], t)
        active = active & ~die

        wo_local = _local(frame, -_normalize(rd))
        st, (_u_pick,) = draws(st, 1, dt)
        st, (ue1, ue2, _ue3) = draws(st, 3, dt)
        # the light's triangle by its CDF (sampleReuse), a uniform point on it
        local = torch.searchsorted(cdf, ue1.contiguous(), right=True)
        local = torch.minimum(torch.clamp(local, min=0), torch.tensor(len(S.light_tris) - 1))
        lo = torch.where(local > 0, cdf[torch.clamp(local - 1, min=0)], 0.0)
        hi = cdf[local]
        ux_re = torch.clamp((ue1 - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0 - 1e-7)
        tri = lt[local]
        su1 = torch.sqrt(ux_re)
        bu = 1.0 - su1
        bv = ue2 * su1
        bc = torch.stack([bu, bv, 1.0 - bu - bv], dim=-1)
        ln = S.n0[tri]
        p_surf = S.v0[tri] + S.e1[tri] * bc[..., 1:2] + S.e2[tri] * bc[..., 2:3]
        n_surf = _normalize(ln * bc[..., 0:1] + ln * bc[..., 1:2] + ln * bc[..., 2:3])
        inv_area = 1.0 / torch.clamp(area, min=1e-20)
        to_p = p_surf - p
        d2a = _dot(to_p, to_p)
        dist_a = torch.sqrt(torch.clamp(d2a, min=1e-20))
        wi_e = to_p / dist_a[..., None]
        cos_em = _dot(n_surf, -wi_e)
        pdf_e = inv_area * d2a / torch.clamp(torch.abs(cos_em), min=1e-12)
        val_e = torch.where(((cos_em > 0.0) & (pdf_e > EPS))[..., None],
                            rad / torch.clamp(pdf_e, min=1e-12)[..., None], 0.0)
        wi_local = _local(frame, wi_e)
        nonzero = torch.any(torch.abs(val_e) > EPS, dim=-1)
        sh_lanes = torch.nonzero(nonzero & valid & active).squeeze(1)
        occl = torch.zeros(n, dtype=torch.bool, device=dev)
        if sh_lanes.numel():
            sh_max = dist_a - EPS
            occl[sh_lanes] = _sweep(S, p[sh_lanes], wi_e[sh_lanes],
                                    torch.full_like(sh_max[sh_lanes], EPS), sh_max[sh_lanes],
                                    True)
        visible = nonzero & ~occl & valid
        diff_ok = (wo_local[..., 2] > 0.0) & (wi_local[..., 2] > 0.0)
        is_d = btype == BSDF_DIFFUSE
        f = torch.where((is_d & diff_ok)[..., None], alb * INV_PI_S, 0.0)
        cos = _dot(wi_e, frame[2])
        contrib = torch.where(visible[..., None], val_e * cos[..., None] * f * n_lights, 0.0)
        pdf_mat = torch.where(visible & is_d & diff_ok, INV_PI_S * wi_local[..., 2], 0.0)
        pdf_ems = torch.where(visible, pdf_e / n_lights, 0.0)
        w_ems = torch.where(pdf_ems + pdf_mat > EPS,
                            pdf_ems / torch.clamp(pdf_ems + pdf_mat, min=1e-20), 0.0)

        st, (um1, um2) = draws(st, 2, dt)
        cos_i = wo_local[..., 2]
        rho = torch.sqrt(um1)
        th = um2 * 2.0 * PI_S
        dx, dy = rho * torch.cos(th), rho * torch.sin(th)
        wo_diff = torch.stack([dx, dy, torch.sqrt(torch.clamp(1.0 - (dx * dx + dy * dy),
                                                              min=1e-12))], dim=-1)
        w_diff = torch.where((cos_i > 0.0)[..., None], alb, 0.0)
        wo_mir = torch.stack([-wo_local[..., 0], -wo_local[..., 1], wo_local[..., 2]], dim=-1)
        w_mir = torch.where((cos_i > 0.0)[..., None], torch.ones_like(wo_local), 0.0)
        is_m = btype == BSDF_MIRROR
        if bool((btype == BSDF_DIELECTRIC).any()):
            raise ValueError("the scan-path reference has no dielectric")
        wo = torch.where(is_m[..., None], wo_mir, wo_diff)
        weight = torch.where(is_m[..., None], w_mir, w_diff)
        pdf_b = torch.where(is_m, 0.0, torch.where(
            is_d & (cos_i > 0.0), INV_PI_S * torch.clamp(wo[..., 2], min=0.0), 0.0))
        w_ems = torch.where(is_m, 0.0, w_ems)
        L = L + torch.where(active[..., None], w_ems[..., None] * t * contrib, 0.0)
        t = torch.where(active[..., None], t * weight, t)
        active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)
        ro = torch.where(active[..., None], p, ro)
        rd = torch.where(active[..., None], _world(frame, wo), rd)
        pdf_prev, prev_disc, w_mats_prev = pdf_b, is_m, w_mats
    L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    return pos, L, albedo, normal


def _gauss(x):
    ax = torch.abs(x)
    alpha = -1.0 / (2.0 * 0.5 * 0.5)
    return torch.clamp(torch.exp(alpha * ax * ax) - math.exp(alpha * 2.0 * 2.0), min=0.0)


# ---------------------------------------------------------------------------
# films of sampled pixels
# ---------------------------------------------------------------------------


def film_pixels(S: Scene, estimator: str, pixels, spp: int, seed: int,
                lanes_per_call: int = 1 << 21) -> dict:
    """The reference's layers at `pixels` (flat ids [P] int64) of a render
    of `spp` samples per pixel (sample indices 0 … spp − 1) with `seed`:
    {"composite", "albedo", "normal": [P, 3], "weights": [P]} as float32
    numpy arrays, as `render()` returns them at those pixels."""
    dev = S.device
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    n_px = pixels.shape[0]
    acc = torch.zeros((n_px, 3, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros(n_px, dtype=torch.float32, device=dev)
    if estimator == "pathk":
        step = max(1, lanes_per_call // spp)
        smp = torch.arange(spp, device=dev)
        for p0 in range(0, n_px, step):
            px = pixels[p0:p0 + step]
            lp = px.repeat_interleave(spp)
            ls = smp.repeat(px.shape[0])
            aL, aA, aN = trace_pathk(S, lp, ls, seed)
            lay = torch.stack([torch.stack(x, -1) for x in (aL, aA, aN)], 1).float()
            lay = torch.nan_to_num(lay, nan=0.0, posinf=0.0, neginf=0.0)
            acc[p0:p0 + step] = lay.view(px.shape[0], spp, 3, 3).sum(1)
            wsum[p0:p0 + step] = float(spp)
    elif estimator == "splat":
        # every sample of the 5 × 5 pixels around each pixel can reach it
        off = torch.arange(-2, 3, device=dev)
        oy, ox = torch.meshgrid(off, off, indexing="ij")
        qx = (pixels % S.width)[:, None] + ox.reshape(-1)
        qy = (pixels // S.width)[:, None] + oy.reshape(-1)
        inside = (qx >= 0) & (qx < S.width) & (qy >= 0) & (qy < S.height)
        owner, nb = torch.nonzero(inside, as_tuple=True)
        q = (qy * S.width + qx)[owner, nb]
        tx, ty = (pixels % S.width).to(torch.float32), (pixels // S.width).to(torch.float32)
        step = max(1, lanes_per_call // spp)
        smp = torch.arange(spp, device=dev)
        for q0 in range(0, q.shape[0], step):
            qq, ow = q[q0:q0 + step], owner[q0:q0 + step]
            lp, ls, lo = qq.repeat_interleave(spp), smp.repeat(qq.shape[0]), \
                ow.repeat_interleave(spp)
            pos, L, alb, nrm = trace_scan(S, lp, ls, seed)
            pos, lay = pos.float(), torch.stack([L, alb, nrm], 1).float()
            w = _gauss(pos[:, 0] - 0.5 - tx[lo]) * _gauss(pos[:, 1] - 0.5 - ty[lo])
            acc.index_add_(0, lo, lay * w[:, None, None])
            wsum.index_add_(0, lo, w)
    else:
        raise ValueError(f"no estimator {estimator!r}")
    w = wsum[:, None, None]
    layers = torch.where(w > 1e-9, acc / torch.clamp(w, min=1e-9), 0.0).cpu().numpy()
    return {"composite": layers[:, 0], "albedo": layers[:, 1], "normal": layers[:, 2],
            "weights": wsum.cpu().numpy()}


def reference_film(xml_path, pixels, spp: int, seed: int, *, max_depth: int, estimator: str,
                   device="cpu", dtype=torch.float32) -> dict:
    """Load the scene at `xml_path` and render `pixels` (see `film_pixels`).
    A configuration names it as its `reference`, `estimator` in its
    `reference_args`."""
    S = load_scene(xml_path, device, dtype)
    S.max_depth = max_depth
    with torch.no_grad():
        return film_pixels(S, estimator, pixels, spp, seed)
