"""The scan path's shading kernel: a bounce of a `path_mis` / `path_mats`
round as one launch between its intersection launches.

`csrc/scan.cu: shade_kernel<MIS>` does, one thread per lane, what the torch
chain of `integrators/path.py: li_path_mis` / `li_path_mats` does between
its `isect_*` launches: the winner's replay, the shading frame, the envmap
and emitter terms, Russian roulette, NEE's emitter sample and BSDF terms,
the BSDF sample and the lane's new state. Its NEE term waits in the lane's
state (`pending`) for the any-hit launch of its shadow ray and is added at
the next launch (or by a last fold-only launch), so L sums its terms in the
chain's order. `integrators/path.py: li_path_fused` is the bounce loop
around it.

The lane state is one `Lanes` of tensors at fixed shapes, so that a
round captured as a CUDA graph holds them. `shade` launches the
kernel (a failed launch raises); `shade_ref` is the same contract in plain
torch over the chain's own helpers, in the kernel's order.

Which rounds take the kernel is decided in the render layer, by the rule
`shade_scene` beside the scan round's CUDA graph, once per render; every
other round runs the torch chain. This module keeps no state.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.ops import intersect as isect_ops
from optix_renderer_tpu_torch.ops.bvh import BIG, MIN_SPHS_FOR_BVH
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.render import sampler as smp

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _CScene(ctypes.Structure):
    """`csrc/scan.cu: sc::Scene`, field for field."""

    _fields_ = [(name, _vp) for name in (
        "v0", "e1", "e2", "n0", "n1", "n2", "tri_shape", "sph_c", "sph_r", "sph_shape",
        "shape_bsdf", "shape_em", "b_type", "b_tex", "b_int", "b_ext", "b_alpha", "b_ks", "b_kd",
        "b_dis", "tex_val", "e_type", "e_rad", "e_pos", "e_pow", "e_dir", "e_cs", "e_ce",
        "e_ang", "e_area", "e_toff", "e_tcnt", "e_cdf", "pick_cdf", "env")] + [
        (name, _i) for name in ("t_cnt", "n_sph", "e_cols", "n_pick", "has_env")] + [
        ("n_lights", _f), ("inv_n_lights", _f)]


class _CLanes(ctypes.Structure):
    """`csrc/scan.cu: sc::Lanes`, field for field."""

    _fields_ = [(name, _vp) for name in (
        "ro", "rd", "mint", "cut", "tri", "sph", "sph_t", "occ_tri", "occ_sph", "sh_o", "sh_d",
        "sh_mint", "sh_cut", "pending", "thr", "L", "albedo", "normal", "pdf_prev", "w_prev",
        "pend", "active", "prev_disc", "st_hi", "st_lo", "inc_hi", "inc_lo")] + [("n", _i)]


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class ShadeScene:
    """The scene's tables as the kernel reads them (every one float32 or
    int32 and contiguous, as `scene/build.py` makes them), and the C struct
    that points at them."""

    def __init__(self, scene, config):
        g, sh, b, em = scene.geometry, scene.shapes, scene.bsdfs, scene.emitters
        self.scene, self.config = scene, config
        self.mis = config.integrator == "path_mis"
        n_lights = max(config.n_emitters, 1)
        self.tensors = (
            g.tri_v0, g.tri_e1, g.tri_e2, g.tri_n0, g.tri_n1, g.tri_n2, g.tri_shape,
            g.sph_center, g.sph_radius, g.sph_shape, sh.bsdf, sh.emitter, b.type, b.albedo_tex,
            b.int_ior, b.ext_ior, b.alpha, b.ks, b.kd, b.disney, scene.textures.value, em.type,
            em.radiance, em.position, em.power, em.direction, em.cos_falloff_start,
            em.cos_falloff_end, em.angular_radius, em.area, em.tri_offset, em.tri_count,
            em.tri_cdf, scene.emitter_pick.cdf, scene.envmap.img)
        for x in self.tensors:
            if x.dtype not in (torch.float32, torch.int32) or not x.is_contiguous():
                raise ValueError(f"the shading kernel reads contiguous float32 / int32 tables, "
                                 f"got {x.dtype} {tuple(x.shape)}")
        self.c = _CScene(
            *(_ptr(x) for x in self.tensors),
            int(g.tri_v0.shape[0]), int(g.sph_center.shape[0]), int(em.tri_cdf.shape[1]),
            int(scene.emitter_pick.cdf.shape[0]), int(scene.envmap_emitter >= 0),
            float(n_lights), float(np.float32(1.0) / np.float32(n_lights)))


@dataclasses.dataclass
class Lanes:
    """A round's lanes between bounces (`csrc/scan.cu: sc::Lanes`): the
    rays and throughput, L and the first hit's AOVs, the MIS state, the
    pcg32 streams (32-bit words in int64, as `core/rng.py` keeps them) and
    the shadow rays with their pending NEE terms."""

    ro: torch.Tensor  # [N,3]
    rd: torch.Tensor
    thr: torch.Tensor
    L: torch.Tensor
    albedo: torch.Tensor
    normal: torch.Tensor
    pending: torch.Tensor  # w_ems * t * contrib of the last NEE, before visibility
    sh_o: torch.Tensor
    sh_d: torch.Tensor
    sh_mint: torch.Tensor  # [N]; an empty interval [BIG, -1) where no shadow ray is due
    sh_cut: torch.Tensor
    pdf_prev: torch.Tensor
    w_prev: torch.Tensor
    active: torch.Tensor  # [N] bool
    pend: torch.Tensor  # a pending NEE term waits on its shadow ray
    prev_disc: torch.Tensor
    st_hi: torch.Tensor  # [N] int64
    st_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor

    @classmethod
    def start(cls, ray: Ray, sampler) -> "Lanes":
        n, dev = ray.o.shape[0], ray.o.device

        def full(shape, v, dtype=torch.float32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        st = sampler.state
        return cls(
            ro=ray.o.detach().clone(memory_format=torch.contiguous_format),
            rd=ray.d.detach().clone(memory_format=torch.contiguous_format), thr=full((n, 3), 1.0),
            L=full((n, 3), 0.0), albedo=full((n, 3), 0.0), normal=full((n, 3), 0.0),
            pending=full((n, 3), 0.0), sh_o=full((n, 3), 0.0), sh_d=full((n, 3), 0.0),
            sh_mint=full((n,), BIG), sh_cut=full((n,), -1.0), pdf_prev=full((n,), 0.0),
            w_prev=full((n,), 1.0), active=full((n,), True, torch.bool),
            pend=full((n,), False, torch.bool), prev_disc=full((n,), False, torch.bool),
            st_hi=st.state_hi.contiguous().clone(), st_lo=st.state_lo.contiguous().clone(),
            inc_hi=st.inc_hi.contiguous(), inc_lo=st.inc_lo.contiguous())

    def sampler(self) -> smp.Sampler:
        return smp.Sampler(rng.Pcg32State(self.st_hi, self.st_lo, self.inc_hi, self.inc_lo))


class Hits(NamedTuple):
    """One bounce's closest hits: the rays' interval and the kernels' winners."""

    mint: torch.Tensor  # [N]
    cut: torch.Tensor  # [N], BIG for an infinite maxt
    tri: torch.Tensor | None  # [N] int32 triangle ids (None: no triangles)
    sph: tuple | None  # (id, t) of the spheres' LBVH (None: analytic spheres)


class Occluders(NamedTuple):
    """The any hits of the shadow rays of the last launch."""

    tri: torch.Tensor | None  # [N] int32
    sph: torch.Tensor | None  # [N] int32 (spheres' LBVH only)


def winners(geom, lanes: Lanes, mint, cut) -> Hits:
    """The intersection launches of a bounce: the triangle kernel's closest
    hits, then (from `MIN_SPHS_FOR_BVH` spheres) the spheres' LBVH cut at the
    triangle's t, as `ops/intersect.py: intersect` cuts it."""
    tri = sph = None
    mint, cut = mint.contiguous(), cut.contiguous()  # the kernel reads them by pointer
    if geom.tri_v0.shape[0] > 0:
        tri, t_tri = isect_ops.triangle_winner(geom, lanes.ro, lanes.rd, mint, cut, False)
    if geom.sph_center.shape[0] >= MIN_SPHS_FOR_BVH:
        cut_s = cut if tri is None else torch.where(tri >= 0, t_tri, cut)
        sph = isect.isect_spheres(geom.sph_bvh.detach(), lanes.ro, lanes.rd, mint, cut_s)
    return Hits(mint, cut, tri, sph)


def occluders(geom, lanes: Lanes) -> Occluders:
    """The any-hit launches of the shadow rays the last shade wrote; the
    analytic spheres are tested by the next shade."""
    tri = sph = None
    args = (lanes.sh_o, lanes.sh_d, lanes.sh_mint, lanes.sh_cut)
    if geom.tri_v0.shape[0] > 0:
        tri, _ = isect_ops.triangle_winner(geom, *args, True)
    if geom.sph_center.shape[0] >= MIN_SPHS_FOR_BVH:
        sph, _ = isect.isect_spheres(geom.sph_bvh.detach(), *args, any_hit=True)
    return Occluders(tri, sph)


def _c_lanes(lanes: Lanes, hits: Hits | None, occ: Occluders | None) -> _CLanes:
    h = hits or Hits(None, None, None, None)
    o = occ or Occluders(None, None)
    sph_id, sph_t = h.sph if h.sph is not None else (None, None)
    return _CLanes(*(_ptr(x) for x in (
        lanes.ro, lanes.rd, h.mint, h.cut, h.tri, sph_id, sph_t, o.tri, o.sph, lanes.sh_o,
        lanes.sh_d, lanes.sh_mint, lanes.sh_cut, lanes.pending, lanes.thr, lanes.L,
        lanes.albedo, lanes.normal, lanes.pdf_prev, lanes.w_prev, lanes.pend, lanes.active,
        lanes.prev_disc, lanes.st_hi, lanes.st_lo, lanes.inc_hi, lanes.inc_lo)),
        lanes.ro.shape[0])


def shade(sc: ShadeScene, lanes: Lanes, bounce: int, hits: Hits | None,
          occ: Occluders | None, fold_only: bool = False) -> None:
    """One launch of `shade_kernel`: a bounce of every lane, in place (with
    `fold_only`, only the last pending NEE terms)."""
    dev = lanes.ro.device
    if dev.type != "cuda":
        raise ValueError(f"the shading kernel runs on a CUDA device, not {dev}: "
                         "`shade_ref` is its plain version")
    c = _c_lanes(lanes, hits, occ)
    isect._launch("scan_shade_launch", "scan_fold" if fold_only else "scan_shade",
                  ctypes.addressof(sc.c), ctypes.addressof(c), bounce, int(sc.mis),
                  int(fold_only), device=dev)


def _w(mask, a, b):
    return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)


def shade_ref(sc: ShadeScene, lanes: Lanes, bounce: int, hits: Hits | None,
              occ: Occluders | None, fold_only: bool = False) -> None:
    """Plain version of one launch of `shade_kernel` (the same contract and
    state, in the kernel's order), over the chain's helpers: each lane
    takes the kernel's branches by masks, and a lane draws only while it
    lives."""
    scene, config, mis = sc.scene, sc.config, sc.mis
    geom = scene.geometry
    n_lights = max(config.n_emitters, 1)
    had = lanes.pend
    if mis and occ is not None:  # bounce 0 has no shadow ray to fold
        blocked = torch.zeros_like(had)
        if occ.tri is not None:
            blocked = blocked | (occ.tri >= 0)
        if occ.sph is not None:
            blocked = blocked | (occ.sph >= 0)
        elif 0 < geom.sph_center.shape[0] < MIN_SPHS_FOR_BVH:
            sh = Ray(lanes.sh_o, lanes.sh_d, lanes.sh_mint, lanes.sh_cut)
            hit = isect_ops.hit_from_winner(geom, sh, lanes.sh_cut, None, any_hit=True)
            blocked = blocked | (hit.prim_kind != isect_ops.PRIM_NONE)
        lanes.L = _w(had & ~blocked, lanes.L + lanes.pending, lanes.L)
        lanes.pend = torch.zeros_like(had)
    if fold_only:
        return
    live = lanes.active
    first = bounce == 0
    ro, rd, t, L = lanes.ro, lanes.rd, lanes.thr, lanes.L
    ray = Ray(ro, rd, hits.mint, hits.cut)
    hit = isect_ops.hit_from_winner(geom, ray, hits.cut, hits.tri, hits.sph)
    ctx = common.shading_ctx(scene, isect_ops.make_interaction(geom, ray, hit))
    valid = ctx.its.valid
    if first:
        lanes.albedo, lanes.normal = common.first_hit_aovs(scene, ctx)

    # a miss: the envmap term, and the lane ends
    miss = live & ~valid
    env = emitter_ops.eval_envmap(scene, rd)
    if mis:
        pdf_env = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
        denom = lanes.pdf_prev + pdf_env
        w_env = torch.where(denom > EPSILON, lanes.pdf_prev / torch.clamp(denom, min=1e-20), 1.0)
        w_env = torch.where(lanes.prev_disc | first, 1.0, w_env)
        L = _w(miss, L + w_env[..., None] * t * env, L)
    else:
        L = _w(miss, L + t * env, L)

    # an emitter hit
    on = live & valid
    le = common.hit_emitter_radiance(scene, ctx, rd)
    if mis:
        pdf_here = emitter_ops.pdf_hit_emitter(scene, ctx.emitter_id, ro, ctx.its.p, ctx.frame.n,
                                               normalize(rd)) / float(n_lights)
        denom = lanes.pdf_prev + pdf_here
        w_mats = torch.where(denom > EPSILON, lanes.pdf_prev / torch.clamp(denom, min=1e-20),
                             lanes.w_prev)
        w_mats = torch.where(lanes.prev_disc | first, 1.0, w_mats)
        L = _w(on & (ctx.emitter_id >= 0), L + w_mats[..., None] * t * le, L)
    else:
        L = _w(on & (ctx.emitter_id >= 0), L + t * le, L)

    # Russian roulette
    s0 = lanes.sampler()
    s, u_rr = smp.next_1d(s0)
    s_rr = s
    if mis:
        succ = torch.clamp(torch.amax(t, dim=-1), EPSILON, 0.99)
        die = u_rr > succ
        t = _w(on, t / succ[..., None], t)
    elif bounce >= 3:
        succ = torch.clamp(torch.amax(t, dim=-1), max=0.99)
        die = u_rr > succ
        t = _w(on, t / torch.clamp(succ, min=1e-12)[..., None], t)
    else:
        die = torch.zeros_like(on)
    go = on & ~die  # the lanes that go on to NEE and the BSDF sample

    wo_local = common.to_local(ctx, -normalize(rd))
    if mis:
        s, u_pick = smp.next_1d(s)
        em_id = common.pick_emitter(scene, u_pick)
        s, u_ems = smp.next_3d(s)
        shadow, contrib, pdf_ems, pdf_mat, nonzero = common.nee_sample(
            scene, ctx, wo_local, em_id, u_ems, n_lights)
        sum_p = pdf_ems + pdf_mat
        w_ems = torch.where(sum_p > EPSILON, pdf_ems / torch.clamp(sum_p, min=1e-20), 0.0)
    s, u_mats = smp.next_2d(s)
    bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv,
                              u_mats)
    if mis:
        w_ems = torch.where(bs.is_discrete, 0.0, w_ems)
        ray_due = go & nonzero
        lanes.pending = _w(go, w_ems[..., None] * t * contrib, lanes.pending)
        lanes.pend = ray_due
        lanes.sh_o = _w(ray_due, shadow.o, lanes.sh_o)
        lanes.sh_d = _w(ray_due, shadow.d, lanes.sh_d)
        cut = torch.where(torch.isinf(shadow.maxt), BIG, shadow.maxt)
        empty = (live & ~ray_due) | (had & ~live)
        lanes.sh_mint = torch.where(ray_due, EPSILON, torch.where(empty, BIG, lanes.sh_mint))
        lanes.sh_cut = torch.where(ray_due, cut, torch.where(empty, -1.0, lanes.sh_cut))
        lanes.pdf_prev = torch.where(go, bs.pdf, lanes.pdf_prev)
        lanes.prev_disc = torch.where(go, bs.is_discrete, lanes.prev_disc)
        lanes.w_prev = torch.where(go, w_mats, lanes.w_prev)
    t_new = t * bs.weight
    alive = go & torch.any(torch.abs(t_new) > 1e-12, dim=-1)
    lanes.thr = _w(go, t_new, t)
    lanes.ro = _w(alive, ctx.its.p, ro)
    lanes.rd = _w(alive, common.to_world(ctx, bs.wo), rd)
    lanes.L = L
    lanes.active = alive
    # a miss draws nothing, a lane killed by roulette its roulette number
    lanes.st_hi, lanes.st_lo = (
        torch.where(go, getattr(s.state, f), torch.where(on, getattr(s_rr.state, f),
                                                         getattr(s0.state, f)))
        for f in ("state_hi", "state_lo"))
