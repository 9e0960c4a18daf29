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

The kernel is `csrc/probes.cu: iter_cost_kernel<MODE>` (one CUDA block of
1,024 threads, 4 lanes each, per group); `iter_cost_ref` is its plain torch
version. Each mode runs at 64 and 1,024 iterations, each launch timed on
the device alone (`kernel_ms`), and the script prints the marginal µs per
iteration of the whole launch and, as the TPU script did, per
block-iteration ((t₁₀₂₄ − t₆₄) / 960 / NB). On the TPU the grid ran its
blocks one after another; on the card the 32 blocks run at once on 32 of
the SMs, so the per-launch figure is the one that compares with a
kernel's loop.
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.ops.cuda import pathk

NB = 32
S, L = 8, 512
LANES = S * L
TRIS = 14
MODES = ("empty", "reduce", "madd100", "isect")
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


def iter_cost(x, tri, n_it: int, mode: str):
    """`iter_cost_ref`'s contract: the plain version for CPU tensors, the
    kernel for CUDA tensors (or raise)."""
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
    from optix_renderer_tpu_torch.ops.cuda import _build

    out = torch.empty((8, nb, S, L), dtype=torch.float32, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.load().iter_cost_launch(ptr(x), ptr(tri), ptr(out), nb, n_it,
                                            MODES.index(mode), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"iter_cost kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES += 1
    return out


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
    "us_per_iter": …, "us_per_block_iter": …}}."""
    x, tri = make_inputs(device)
    res = {}
    for mode in MODES:
        ms = {n: kernel_ms(lambda n=n: iter_cost(x, tri, n, mode)) for n in ITERS}
        per_iter = (ms[ITERS[1]] - ms[ITERS[0]]) / (ITERS[1] - ITERS[0]) * 1e3
        res[mode] = {"ms": ms, "us_per_iter": per_iter, "us_per_block_iter": per_iter / NB}
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("prof_parts needs a CUDA GPU (torch.cuda.is_available() is False)")
    for mode, r in run(torch.device("cuda", 0)).items():
        t64, t1024 = (r["ms"][n] for n in ITERS)
        print(f"{mode:10s}: t64={t64:9.4f}ms t1024={t1024:9.4f}ms "
              f"marginal={r['us_per_iter']:8.4f} us/iter, {r['us_per_block_iter']:8.5f} "
              f"us/block-iter")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
