"""Marginal per-iteration cost of loop bodies on the card:
`python -m optix_renderer_tpu_torch.tools.prof_parts` (needs a CUDA GPU).

Counterpart of `tools/prof_parts2.py` (its Pallas kernel `make → kern`,
:14-48, called at :40). NB = 32 groups of 4,096 lanes (the TPU's [8, 512]
block) each run `n_it` iterations of one body on a per-lane `acc`:

* `empty`: acc + 1;
* `reduce`: acc + max(acc over the group) · 1e-12 + 1;
* `madd100`: 100 dependent multiply-adds y·1.000001 + 0.5, then acc + y·1e-12;
* `isect`: the path kernel's Möller–Trumbore over 14 rows of a [16, 48]
  table filled with 0.3, closest hit of the ray (acc, acc+1, acc+2) ·
  (0.3, 0.5, −0.8) and any hit of the same ray as a shadow ray:
  acc + t·1e-12 + kd_r·1e-12 (+ 1e-12 when occluded, which on these
  degenerate triangles it never is).

The kernel is `csrc/probes.cu: iter_cost_kernel<MODE>`: a group is 4 CTAs
of 1,024 threads, one lane per thread (`lane_map`), so the 32 groups run on
128 of the H100's 132 SMs. `reduce` launches each group as a thread-block
cluster and takes the group max per CTA, then across the 4 CTAs through
distributed shared memory. `isect` stages the table in shared memory, runs
one test per triangle for both the closest and the shadow test, and takes
the division's fast path in line (`walk.cuh: rcp_fast`). `iter_cost_ref`
is the plain torch version; `iter_cost_design` is the kernel's
decomposition of `reduce` and `isect` as plain torch, equal to it bit for
bit. Each mode runs at 64 and 1,024 iterations, each launch timed on the
device alone (`kernel_ms`), and the script prints the marginal µs per
iteration of the whole launch, per group-iteration ((t₁₀₂₄ − t₆₄) / 960 /
NB, the TPU script's per-block figure) and, the figure that compares with
one lane of a kernel's loop, the ns per lane-iteration ((t₁₀₂₄ − t₆₄) / 960
/ 131,072 lanes).
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.ops.bvh import mt_lanes
from optix_renderer_tpu_torch.ops.cuda import pathk

NB = 32
S, L = 8, 512
LANES = S * L
# a group's CTAs and their threads (one lane each)
CTAS, THREADS = 4, 1024
TRIS = 14
MODES = ("empty", "reduce", "madd100", "isect")
# the H100 SXM's SMs, the warp instructions each issues per clock, and its
# published boost clock
SMS, ISSUE_PER_CLOCK, BOOST_HZ = 132, 4, 1.98e9
ITERS = (64, 1024)

# kernel launches by `iter_cost` (not by the plain version)
LAUNCHES = 0


def make_inputs(device="cpu", nb: int = NB):
    """x [nb, 8, 8, 512] of ones and the [16, 48] triangle table of 0.3
    (prof_parts2.py:50-51)."""
    x = torch.ones((nb, 8, S, L), dtype=torch.float32, device=device)
    tri = torch.full((16, pathk.TR_COLS), 0.3, dtype=torch.float32, device=device)
    return x, tri


def _isect_step(acc, tri):
    zero = acc * 0.0
    o = (acc, acc + 1.0, acc + 2.0)
    d = (zero + 0.3, zero + 0.5, zero - 0.8)
    t, _, _, _, attrs, occl = pathk._isect(tri, TRIS, o, d, zero, zero + 1e9, o, d, zero + 5.0)
    return acc + t * 1e-12 + attrs[:, 26] * 1e-12 + torch.where(occl, 1e-12, 0.0)


def iter_cost_ref(x, tri, n_it: int, mode: str):
    """Plain version: [8, nb, 8, 512] float32, every row the lanes' acc."""
    nb = x.shape[0]
    acc = x[:, 0].reshape(nb, LANES) * 0.0
    for _ in range(n_it):
        if mode == "empty":
            acc = acc + 1.0
        elif mode == "reduce":
            acc = acc + acc.amax(dim=1, keepdim=True) * 1e-12 + 1.0
        elif mode == "madd100":
            y = acc
            for _ in range(100):
                y = y * 1.000001 + 0.5
            acc = acc + y * 1e-12
        elif mode == "isect":
            acc = _isect_step(acc.reshape(-1), tri).reshape(nb, LANES)
        else:
            raise ValueError(f"unknown mode '{mode}'")
    return acc.reshape(1, nb, S, L).expand(8, nb, S, L).contiguous()


def lane_map(nb: int):
    """int64 [nb · CTAS, THREADS]: the flat lane (group · 4,096 + lane) that
    thread t of CTA q serves. CTA q is rank q % CTAS of cluster q // CTAS,
    which is group q // CTAS."""
    q = torch.arange(nb * CTAS)[:, None]
    return (q // CTAS) * LANES + (q % CTAS) * THREADS + torch.arange(THREADS)[None]


def _group_max_clustered(acc):
    """The group max as the kernel takes it: per CTA, then across the
    group's CTAs (a max is exact in any order)."""
    per_cta = acc.reshape(-1)[lane_map(acc.shape[0]).to(acc.device)].amax(dim=1)
    return per_cta.reshape(-1, CTAS).amax(dim=1, keepdim=True)


def _isect_step_one_test(acc, tri):
    """The kernel's isect body: one Möller–Trumbore test per triangle, whose
    (t, hit) serves both the closest test ([0, 1e9), lowest-index minimum)
    and the shadow test ([EPS, 5))."""
    o = torch.stack((acc, acc + 1.0, acc + 2.0), -1)
    d = torch.stack((acc * 0.0 + 0.3, acc * 0.0 + 0.5, acc * 0.0 - 0.8), -1)
    t, _, _, hit = mt_lanes(o[:, None], d[:, None], tri[None, :TRIS, 0:3], tri[None, :TRIS, 3:6],
                            tri[None, :TRIS, 6:9])
    t_best = torch.full_like(acc, 1e9)
    kdr = torch.zeros_like(acc)
    occ = torch.zeros_like(acc, dtype=torch.bool)
    for j in range(TRIS):
        take = hit[:, j] & (t[:, j] >= 0.0) & (t[:, j] < t_best)
        t_best = torch.where(take, t[:, j], t_best)
        kdr = torch.where(take, tri[j, 26], kdr)
        occ = occ | (hit[:, j] & (t[:, j] >= pathk.EPS) & (t[:, j] < 5.0))
    return acc + t_best * 1e-12 + kdr * 1e-12 + torch.where(occ, 1e-12, 0.0)


def iter_cost_design(x, tri, n_it: int, mode: str):
    """`iter_cost_ref`'s function as the kernel decomposes it: `reduce` takes
    the group max per CTA, then across CTAs; `isect` runs one test per
    triangle for both tests. Equal to `iter_cost_ref` bit for bit."""
    if mode not in ("reduce", "isect"):
        return iter_cost_ref(x, tri, n_it, mode)
    nb = x.shape[0]
    acc = x[:, 0].reshape(nb, LANES) * 0.0
    for _ in range(n_it):
        if mode == "reduce":
            acc = acc + _group_max_clustered(acc) * 1e-12 + 1.0
        else:
            acc = _isect_step_one_test(acc.reshape(-1), tri).reshape(nb, LANES)
    return acc.reshape(1, nb, S, L).expand(8, nb, S, L).contiguous()


def iter_cost(x, tri, n_it: int, mode: str, info=None):
    """`iter_cost_ref`'s contract: the plain version for CPU tensors, the
    kernel for CUDA tensors (or raise). `info`, an optional int32
    [nb · CTAS, 2] on the device, receives each CTA's SM and its cluster's
    CTA count (4 for `reduce`, whose groups launch as clusters; 1 for the
    other modes)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return iter_cost_ref(x, tri, n_it, mode)
    if x.device.type != "cuda":
        raise ValueError(f"iter_cost runs on cpu or cuda tensors, got {x.device}")
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}'")
    nb = x.shape[0]
    if x.shape[1:] != (8, S, L) or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [nb, 8, {S}, {L}] tensor")
    if (tri.shape[0] < TRIS or tri.shape[1:] != (pathk.TR_COLS,) or tri.dtype != torch.float32
            or not tri.is_contiguous() or tri.device != x.device):
        raise ValueError(f"tri must be a contiguous float32 [>= {TRIS}, {pathk.TR_COLS}] table")
    if not 0 <= n_it < 2**31 or not 0 < nb < 2**31 // (8 * LANES):
        raise ValueError(f"n_it {n_it} or nb {nb} out of range")
    if info is not None and (info.shape != (nb * CTAS, 2) or info.dtype != torch.int32
                             or info.device != x.device or not info.is_contiguous()):
        raise ValueError(f"info must be a contiguous int32 [{nb * CTAS}, 2] on {x.device}")
    from optix_renderer_tpu_torch.ops.cuda import _build

    out = torch.empty((8, nb, S, L), dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.load().iter_cost_launch(ptr(x), ptr(tri), ptr(out), nb, n_it,
                                            MODES.index(mode), ptr(info),
                                            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"iter_cost kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES += 1
    return out


def isect_per_pair(sass: str) -> float | None:
    """Instructions per lane-triangle of the `isect` loop in the output of
    `cuobjdump -sass` on the built library (`time_isect.py: sweep_loops`;
    None without cuobjdump)."""
    from optix_renderer_tpu_torch.tools.time_isect import sweep_loops

    loops = [loop for found in sweep_loops(sass, "iter_cost_kernelILi3E").values()
             for loop in found]
    return loops[0]["per_pair"] if loops else None


def issue_limit_ms(per_pair: float, n_it: int, nb: int = NB) -> float:
    """The least time the card takes to issue `per_pair` instructions per
    lane-triangle, TRIS triangles per lane-iteration, for nb · 4,096 lanes
    over n_it iterations: 4 warp instructions per clock on each of 132 SMs
    at the published 1,980 MHz boost clock."""
    warp_instructions = per_pair * TRIS * n_it * nb * LANES / 32
    return warp_instructions / (SMS * ISSUE_PER_CLOCK * BOOST_HZ) * 1e3


def kernel_ms(fn, reps: int = 3) -> float:
    """Device time in ms of the one kernel that `fn()` launches, the mean of
    `reps` launches after one warm-up. Each launch sits between two CUDA
    events queued behind a ~1 ms spin kernel (`torch.cuda._sleep`), so the
    interval holds the kernel alone and not the host's time to enqueue it,
    which is longer than a launch of a few µs."""
    fn()
    total = 0.0
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
    return total / reps


def run(device) -> dict:
    """Time every mode at 64 and 1,024 iterations → {mode: {"ms": {n_it: ms},
    "us_per_iter": …, "us_per_block_iter": …, "ns_per_lane_iter": …}}."""
    x, tri = make_inputs(device)
    res = {}
    for mode in MODES:
        ms = {n: kernel_ms(lambda n=n: iter_cost(x, tri, n, mode)) for n in ITERS}
        res[mode] = {"ms": ms, **marginals(ms, x.shape[0])}
    return res


def marginals(ms: dict, nb: int = NB) -> dict:
    """The marginal cost per iteration from {64: ms, 1024: ms}: µs per
    iteration of the whole launch, per group-iteration and ns per
    lane-iteration."""
    per_iter = (ms[ITERS[1]] - ms[ITERS[0]]) / (ITERS[1] - ITERS[0]) * 1e3
    return {"us_per_iter": per_iter, "us_per_block_iter": per_iter / nb,
            "ns_per_lane_iter": per_iter * 1e3 / (nb * LANES)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("prof_parts needs a CUDA GPU (torch.cuda.is_available() is False)")
    for mode, r in run(torch.device("cuda", 0)).items():
        t64, t1024 = (r["ms"][n] for n in ITERS)
        print(f"{mode:10s}: t64={t64:9.4f}ms t1024={t1024:9.4f}ms "
              f"marginal={r['us_per_iter']:8.4f} us/iter, {r['us_per_block_iter']:8.5f} "
              f"us/block-iter, {r['ns_per_lane_iter']:.7f} ns/lane-iter")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
