"""Photon mapping: wavefront photon tracing and a hash-grid radiance estimate.

Counterpart of `optix_renderer_tpu/ops/photon.py` (the reference's
src/integrators/photonmapper.cpp, include/nori/{photon,kdtree}.h):

* **Tracing** (`trace_photons`): one photon per lane, emitter picked by the
  lightProb distribution, stored at every diffuse hit, Russian roulette
  after 3 bounces with min(max W, 0.99) survival, continued by BSDF
  sampling. The JAX `lax.scan` over depth is a Python loop of masked steps
  that draws the sampler in the same order; its intersections launch the
  port's kernels on a CUDA device (`integrators/common.trace`).
* **Map** (`build_photon_map`, `make_photon_map`): the photons are hashed
  by grid cell (cell size = gather radius) and sorted by hash on the host
  in numpy, as in the JAX package, so a map is bit-equal to the JAX one
  for the same photons.
* **Gather** (`estimate_radiance`): Σ power·f(wo, wi) / (π r² · emitted)
  over the photons within r, found in the 27 neighbouring cells by a
  binary search of the sorted hashes, at most `MAX_PER_CELL` photons per
  cell and each distinct hash once. A torch loop over the slot index, as
  the JAX `fori_loop`; there is no Pallas kernel to port.

The uint32 arithmetic of the JAX package (the hash, the stream ids) is
done in int64 and masked to 32 bits, so it wraps as uint32 does.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.core import dpdf, warp
from optix_renderer_tpu_torch.core.math import (
    EPSILON,
    PI,
    Frame,
    Ray,
    frame_to_local,
    frame_to_world,
    make_frame,
    normalize,
)
from optix_renderer_tpu_torch.core.rng import M32
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import envmap as envmap_ops
from optix_renderer_tpu_torch.ops.emitter import _sample_shape_surface
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import (
    BsdfType,
    EmitterGeom,
    EmitterType,
    PhotonMap,
    SceneData,
    empty_photon_map,
)

MAX_PER_CELL = 16
# photon-storing (isDiffuse) BSDF types: diffuse.cpp:142, disney.cpp:229
DIFFUSE_TYPES = (BsdfType.DIFFUSE, BsdfType.DISNEY)
# the 27 neighbour cells, in the JAX package's order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
# Teschner et al.'s hash primes
_PRIMES = (73856093, 19349663, 83492791)
# the sample-index offset that keeps photon streams apart from camera streams
_STREAM_BASE = 0x9E3779B9
# lanes per chunk of the gather: [n, 27] slots, each a BSDF evaluation
GATHER_LANES = 1 << 18


def _hash_cells(cx, cy, cz, table_size: int) -> torch.Tensor:
    """Spatial hash of integer cell coordinates → int32 in [0, table_size):
    the JAX uint32 hash, each coordinate wrapped to 32 bits and each
    product masked (< 2^59, so int64 holds it)."""
    h = None
    for c, prime in zip((cx, cy, cz), _PRIMES):
        term = ((c.to(torch.int64) & M32) * prime) & M32
        h = term if h is None else h ^ term
    return (h & (table_size - 1)).to(torch.int32)


def _hash_cells_np(c: np.ndarray, table_size: int) -> np.ndarray:
    h = (c[:, 0].astype(np.uint32) * np.uint32(_PRIMES[0])
         ^ c[:, 1].astype(np.uint32) * np.uint32(_PRIMES[1])
         ^ c[:, 2].astype(np.uint32) * np.uint32(_PRIMES[2]))
    return (h & np.uint32(table_size - 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Emission (the Emitter::samplePhoton counterparts)
# ---------------------------------------------------------------------------


def _scene_bounding_sphere(scene: SceneData):
    """World bounding sphere (center [3], radius []) over all primitives."""
    geom = scene.geometry
    los, his = [], []
    if geom.tri_v0.shape[0] > 0:
        verts = torch.cat([geom.tri_v0, geom.tri_v0 + geom.tri_e1, geom.tri_v0 + geom.tri_e2])
        los.append(verts.amin(dim=0))
        his.append(verts.amax(dim=0))
    if geom.sph_center.shape[0] > 0:
        r = geom.sph_radius[:, None]
        los.append((geom.sph_center - r).amin(dim=0))
        his.append((geom.sph_center + r).amax(dim=0))
    if not los:
        return torch.zeros(3, device=geom.tri_v0.device), torch.tensor(1.0)
    lo = torch.stack(los).amin(dim=0)
    hi = torch.stack(his).amax(dim=0)
    return 0.5 * (lo + hi), 0.5 * torch.linalg.norm(hi - lo) + 1e-3


def sample_photon(scene: SceneData, em_id, u2a, u2b, u1):
    """One photon per lane from emitter `em_id` → (ray_o, ray_d, W).

    As the JAX `sample_photon` (its photon.py:133-237):
    - area (arealight.cpp:127-144): a surface point and a cosine-weighted
      direction about its normal, W = π·area·radiance;
    - point: a uniform direction, W = power;
    - envmap (environmentmap.cpp:133-145): an importance-sampled direction
      wi, the origin uniform on a disk of the scene's bounding-sphere radius
      R beyond the sphere, W = L(wi)·πR²/pdf(wi);
    - volume: a uniform point of the shape's ball or bbox and a uniform
      direction, W = 4π·V·radiance;
    - other emitters: W = 0, the lane dies at once.

    `u2a` / `u2b` are [N,2]; `u1` is [N] (the third volume axis, the disk's
    first).
    """
    em = scene.emitters
    geom = scene.geometry
    et = em.type[em_id]

    p_s, n_s, inv_area = _sample_shape_surface(scene, em_id, u2a)
    d_area = frame_to_world(make_frame(n_s), warp.square_to_cosine_hemisphere(u2b))
    w_area = (PI / torch.clamp(inv_area, min=1e-20))[..., None] * em.radiance[em_id]

    d_point = warp.square_to_uniform_sphere(u2b)
    w_point = em.power[em_id]

    # photons travel −wi from a disk outside the bounding sphere; the flux
    # through it is πR²·∫L dω, so a uniform disk origin carries L·πR²/pdf
    wi_env, pdf_env, rad_env = envmap_ops.sample_dir(scene.envmap, scene.envmap_pick, u2a)
    c_w, r_w = _scene_bounding_sphere(scene)
    fr_env = make_frame(-wi_env)
    disk = warp.square_to_uniform_disk(torch.stack([u1, u2b[..., 0]], dim=-1)) * r_w
    o_env = c_w + wi_env * (2.0 * r_w) + fr_env.s * disk[..., 0:1] + fr_env.t * disk[..., 1:2]
    w_env = rad_env * (PI * r_w * r_w) / torch.clamp(pdf_env, min=1e-20)[..., None]

    u3 = torch.stack([u2a[..., 0], u2a[..., 1], u1], dim=-1)
    p_vol = em.bbox_min[em_id] + em.bbox_extent[em_id] * u3
    if geom.sph_center.shape[0] > 0:
        sid = torch.clamp(em.sphere_id[em_id], min=0).long()
        p_ball = (geom.sph_center[sid]
                  + geom.sph_radius[sid][..., None] * warp.square_to_uniform_sphere_volume(u3))
        p_vol = torch.where((em.geom_kind[em_id] == EmitterGeom.SPHERE)[..., None], p_ball, p_vol)
    w_vol = (4.0 * PI * em.volume[em_id])[..., None] * em.radiance[em_id]

    is_area = (et == EmitterType.AREA)[..., None]
    is_point = (et == EmitterType.POINT)[..., None]
    is_env = (et == EmitterType.ENVMAP)[..., None]
    is_vol = (et == EmitterType.VOLUME)[..., None]
    ro = torch.where(is_area, p_s, torch.where(is_env, o_env,
                                               torch.where(is_vol, p_vol, em.position[em_id])))
    rd = torch.where(is_area, d_area, torch.where(is_env, -wi_env, d_point))
    W = torch.where(is_area, w_area, torch.where(
        is_point, w_point, torch.where(is_env, w_env, torch.where(is_vol, w_vol, 0.0))))
    # surface-emitter origins step off the surface
    ro = ro + torch.where(is_area | is_env, rd * EPSILON, 0.0)
    return ro, rd, W


def is_diffuse(scene: SceneData, bsdf_id) -> torch.Tensor:
    """Whether each lane's BSDF stores photons and ends a camera path (isDiffuse)."""
    bt = scene.bsdfs.type[torch.clamp(bsdf_id, min=0).long()]
    return (bt == DIFFUSE_TYPES[0]) | (bt == DIFFUSE_TYPES[1])


def trace_photons(scene: SceneData, n_emit: int, max_depth: int, n_lights: int, stream: int):
    """Trace `n_emit` photons (one wavefront on the scene's device) for
    `max_depth` bounces → (pos [D,N,3], dir_in [D,N,3], power [D,N,3],
    valid [D,N]): slot [d,i] is photon i's candidate store at depth d,
    valid where the surface is diffuse (photonmapper.cpp:107-124).

    Lane i's sampler is `make_sampler(i, 0x9E3779B9 + stream)` with seed 0,
    the stream wrapped to 32 bits, as in the JAX package.
    """
    dev = scene.geometry.tri_v0.device
    n = n_emit
    s = smp.make_sampler(torch.arange(n, dtype=torch.int64, device=dev),
                         (_STREAM_BASE + stream) & M32)
    s, u_pick = smp.next_1d(s)
    em_id = dpdf.sample(scene.emitter_pick, u_pick)
    s, u2a = smp.next_2d(s)
    s, u2b = smp.next_2d(s)
    s, u1 = smp.next_1d(s)
    ro, rd, W = sample_photon(scene, em_id, u2a, u2b, u1)
    W = W * float(n_lights)  # photonmapper.cpp:92 (× getLights().size())
    active = torch.any(W > 0.0, dim=-1)

    mint = torch.full((n,), EPSILON, device=dev)
    maxt = torch.full((n,), float("inf"), device=dev)
    out_pos, out_dir, out_pow, out_valid = [], [], [], []
    for depth in range(max_depth):
        ctx = common.trace(scene, Ray(o=ro, d=rd, mint=mint, maxt=maxt))
        active = active & ctx.its.valid
        out_pos.append(ctx.its.p)
        out_dir.append(-normalize(rd))
        out_pow.append(W)
        out_valid.append(active & is_diffuse(scene, ctx.bsdf_id))

        # Russian roulette after 3 bounces (photonmapper.cpp:126-139)
        s, u_rr = smp.next_1d(s)
        if depth >= 3:
            succ = torch.clamp(torch.amax(W, dim=-1), max=0.99)
            die = (u_rr > succ) & active
            W = torch.where(active[..., None], W / torch.clamp(succ, min=1e-12)[..., None], W)
            active = active & ~die

        # continue by BSDF sampling (photonmapper.cpp:141-149)
        wo_local = common.to_local(ctx, -normalize(rd))
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                  ctx.its.uv, u2)
        W = torch.where(active[..., None], W * bs.weight, W)
        active = active & torch.any(torch.abs(W) > 1e-12, dim=-1)
        ro = torch.where(active[..., None], ctx.its.p, ro)
        rd = torch.where(active[..., None], common.to_world(ctx, bs.wo), rd)
    return (torch.stack(out_pos), torch.stack(out_dir), torch.stack(out_pow),
            torch.stack(out_valid))


def auto_radius(scene: SceneData) -> float:
    """The scene's bbox diagonal / 500 (photonmapper.cpp:75-77), at least 1e-4."""
    g = scene.geometry
    pts = []
    if g.tri_v0.shape[0] > 0:
        v0 = g.tri_v0.detach().cpu().numpy()
        pts += [v0, v0 + g.tri_e1.detach().cpu().numpy(), v0 + g.tri_e2.detach().cpu().numpy()]
    if g.sph_center.shape[0] > 0:
        c = g.sph_center.detach().cpu().numpy()
        r = g.sph_radius.detach().cpu().numpy()[:, None]
        pts += [c - r, c + r]
    allp = np.concatenate(pts, 0) if pts else np.zeros((1, 3), np.float32)
    extents = allp.max(0) - allp.min(0)
    return max(float(np.linalg.norm(extents) / 500.0), 1e-4)


def build_photon_map(scene: SceneData, photon_count: int, radius: float, max_depth: int,
                     n_lights: int, seed: int = 0, device="cuda") -> PhotonMap:
    """Emit photons in batches of max(photon_count // 2, 1024) on `device`
    until `photon_count` are stored (at most 64 batches; none stored after 3
    ends the loop), keep the first `photon_count` of the stored slots in
    depth-major order, batch after batch, and hash-sort them on the host
    (`make_photon_map`) → the map on `device`. `radius` ≤ 0 takes
    `auto_radius`. Batch k's stream is seed·65599 + k·7919 (mod 2^32)."""
    from optix_renderer_tpu_torch.render.render import resolve_device

    device = resolve_device(device)
    scene = scene.to(device)
    if radius <= 0.0:
        radius = auto_radius(scene)
    batch = max(photon_count // 2, 1024)
    stored_pos, stored_dir, stored_pow = [], [], []
    stored = emitted = 0
    for round_i in range(64):
        with torch.no_grad():
            pos, dir_in, power, valid = trace_photons(
                scene, batch, max_depth, n_lights, (seed * 65599 + round_i * 7919) & M32)
        # compact on the device; boolean indexing keeps the depth-major order
        v = valid.reshape(-1)
        p = pos.reshape(-1, 3)[v].cpu().numpy()
        stored_pos.append(p)
        stored_dir.append(dir_in.reshape(-1, 3)[v].cpu().numpy())
        stored_pow.append(power.reshape(-1, 3)[v].cpu().numpy())
        emitted += batch
        stored += len(p)
        if stored >= photon_count:
            break
        if round_i >= 2 and stored == 0:
            break  # no diffuse surface, or no emitter that emits photons

    def cut(parts):
        return np.concatenate(parts, 0)[:photon_count] if stored else np.zeros((0, 3), np.float32)

    return make_photon_map(cut(stored_pos), cut(stored_dir), cut(stored_pow), radius,
                           emitted).to(device)


def make_photon_map(pos, dir_in, power, radius: float, emitted: int) -> PhotonMap:
    """Hash-sort raw photons into a queryable map on the CPU (the
    m_photonMap->build() analog, photonmapper.cpp:154): cell size = gather
    radius, a table of the next power of two ≥ 2·P buckets, a stable sort
    by hash. numpy throughout, as in the JAX package, so the map is
    bit-equal to the JAX one."""
    pos = np.asarray(pos, np.float32)
    dir_in = np.asarray(dir_in, np.float32)
    power = np.asarray(power, np.float32)
    n_ph = len(pos)
    if n_ph == 0:
        return empty_photon_map()
    table_size = 1 << max(int(np.ceil(np.log2(max(2 * n_ph, 2)))), 1)
    origin = pos.min(0).astype(np.float32)
    inv_cell = np.float32(1.0 / radius)
    cells = np.floor((pos - origin) * inv_cell).astype(np.int32)
    hashes = _hash_cells_np(cells, table_size)
    order = np.argsort(hashes, kind="stable")
    return PhotonMap(
        pos=torch.from_numpy(pos[order]),
        dir=torch.from_numpy(dir_in[order]),
        power=torch.from_numpy(power[order]),
        cell_hash=torch.from_numpy(hashes[order]),
        origin=torch.from_numpy(origin),
        inv_cell=torch.tensor(inv_cell, dtype=torch.float32),
        radius=torch.tensor(radius, dtype=torch.float32),
        inv_emitted=torch.tensor(1.0 / emitted, dtype=torch.float32),
        table_size=table_size,
    )


# ---------------------------------------------------------------------------
# Radiance estimate (the kd-tree range search replacement)
# ---------------------------------------------------------------------------


def cell_ranges(pm: PhotonMap, p: torch.Tensor):
    """For points p [N,3] → (lo, hi) [N,27] int64: the photons of each of the
    27 neighbour cells are pm rows lo … hi − 1, at most `MAX_PER_CELL`, and
    an empty range where an earlier cell of the 27 has the same hash, so a
    hash collision never counts a bucket twice."""
    base = torch.floor((p - pm.origin) * pm.inv_cell).to(torch.int32)
    off = torch.tensor(_OFFSETS, dtype=torch.int32, device=p.device)  # [27,3]
    c = base[:, None, :] + off[None]
    hs = _hash_cells(c[..., 0], c[..., 1], c[..., 2], pm.table_size).contiguous()  # [N,27]
    tri = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=p.device), diagonal=-1)
    dup = torch.any((hs[:, :, None] == hs[:, None, :]) & tri, dim=2)
    lo = torch.searchsorted(pm.cell_hash, hs, right=False)
    hi = torch.searchsorted(pm.cell_hash, hs, right=True)
    hi = torch.minimum(hi, lo + MAX_PER_CELL)
    return lo, torch.where(dup, lo, hi)


def _estimate(pm: PhotonMap, scene: SceneData, p, frame: Frame, bsdf_id, uv, wo_local):
    """`estimate_radiance` on one chunk of lanes."""
    n = p.shape[0]
    n_ph = pm.pos.shape[0]
    lo, hi = cell_ranges(pm, p)
    r2 = pm.radius * pm.radius
    # loop-invariant per-slot inputs of the BSDF: lane i's row repeated 27 times
    frame27 = Frame(*(torch.repeat_interleave(a, 27, dim=0) for a in frame))
    bsdf27 = torch.repeat_interleave(bsdf_id, 27, dim=0)
    wo27 = torch.repeat_interleave(wo_local, 27, dim=0)
    uv27 = torch.repeat_interleave(uv, 27, dim=0)
    acc = torch.zeros((n, 3), device=p.device)
    for k in range(MAX_PER_CELL):
        idx = torch.clamp(lo + k, 0, n_ph - 1)  # [N,27]
        ph_p = pm.pos[idx]
        d = ph_p - p[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        valid = ((lo + k) < hi) & (d2 < r2)
        # f(wi = the camera's wo, wo = the photon's direction), local frame
        wi = frame_to_local(frame27, pm.dir[idx].reshape(-1, 3))
        f = bsdf_ops.eval_bsdf(scene.bsdfs, scene.textures, bsdf27, wo27, wi, uv27)
        contrib = torch.where(valid[..., None], pm.power[idx] * f.reshape(n, 27, 3), 0.0)
        acc = acc + contrib.sum(dim=1)
    return acc * (pm.inv_emitted / (PI * r2))


def estimate_radiance(pm: PhotonMap, scene: SceneData, ctx: common.ShadingCtx,
                      wo_local: torch.Tensor) -> torch.Tensor:
    """Photon-density radiance estimate [N,3] at each lane's hit point
    (photonmapper.cpp:212-236): Σ power · f(wo, wi_photon) / (π r² ·
    emitted) over the photons within r in the 27 neighbour cells, slot k
    of every cell at step k (the JAX order: k outer, cells inner). Lanes
    go in chunks of `GATHER_LANES`, which bounds the [n·27] BSDF
    evaluation's memory. Every lane must hold a valid hit."""
    n = wo_local.shape[0]
    if pm.pos.shape[0] == 0:
        return torch.zeros((n, 3), device=wo_local.device)
    parts = []
    for a in range(0, n, GATHER_LANES):
        sl = slice(a, a + GATHER_LANES)
        parts.append(_estimate(pm, scene, ctx.its.p[sl], Frame(*(f[sl] for f in ctx.frame)),
                               ctx.bsdf_id[sl], ctx.its.uv[sl], wo_local[sl]))
    return parts[0] if len(parts) == 1 else torch.cat(parts)
