"""Film: reconstruction-filtered sample splatting into weighted image planes.

Counterpart of `optix_renderer_tpu/render/film.py` (reference ImageBlock +
ReconstructionFilter, block.h:49-129, rfilter.cpp:28-210): each sample at a
continuous position adds into its filter-support neighbourhood; channel 3
accumulates the filter weight; `to_bitmap` divides it out. `.at[].add`
becomes, on a CUDA film, one launch of `csrc/film.cu: splat_kernel`
(`ops/cuda/film.py`), whose float4 atomic adds land in an order that varies
from run to run, so a film there differs from run to run in its last bits;
where autograd follows a card's `splat`, its backward is one launch of the
kernel's adjoint, `splat_grad_kernel`. On the CPU the plain body
`_splat_plain_` splats, one `index_put_(..., accumulate=True)` a filter
tap, and autograd follows it: the kernels' contract.
"""

from __future__ import annotations

import math

import torch

from optix_renderer_tpu_torch.ops.cuda import film as film_kernel

# filter radii per type (rfilter.cpp defaults)
FILTER_RADIUS = {"gaussian": 2.0, "mitchell": 2.0, "tent": 1.0, "box": 0.5}


def _filter_eval(name: str, x: torch.Tensor) -> torch.Tensor:
    """1D filter kernels, matching src/cameras/rfilter.cpp."""
    ax = torch.abs(x)
    if name == "gaussian":
        # radius 2, stddev 0.5 (rfilter.cpp:34-52)
        alpha = -1.0 / (2.0 * 0.5 * 0.5)
        return torch.clamp(torch.exp(alpha * ax * ax) - math.exp(alpha * 2.0 * 2.0), min=0.0)
    if name == "mitchell":
        # Mitchell–Netravali B = C = 1/3 (rfilter.cpp:60-93)
        B = C = 1.0 / 3.0
        x2 = ax * ax
        x3 = x2 * ax
        inner = ((12.0 - 9.0 * B - 6.0 * C) * x3 + (-18.0 + 12.0 * B + 6.0 * C) * x2
                 + (6.0 - 2.0 * B)) * (1.0 / 6.0)
        outer = ((-B - 6.0 * C) * x3 + (6.0 * B + 30.0 * C) * x2 + (-12.0 * B - 48.0 * C) * ax
                 + (8.0 * B + 24.0 * C)) * (1.0 / 6.0)
        return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))
    if name == "tent":
        return torch.clamp(1.0 - ax, min=0.0)
    if name == "box":
        return torch.where(ax <= 0.5, 1.0, 0.0)
    raise ValueError(f"unknown rfilter '{name}'")


def _support(rfilter: str) -> int:
    """Pixels per axis that one sample's filter footprint covers."""
    return int(2 * FILTER_RADIUS[rfilter] + 0.999)


def in_footprints(mask, rfilter: str, k: int) -> bool:
    """True when the set pixels of `mask` [H,W] lie inside at most `k` filter
    footprints (support × support windows, what one sample can touch), that
    is, when k samples that took another value could explain them."""
    s = _support(rfilter)

    def cover(pts, k):
        if not pts:
            return True
        if k == 0:
            return False
        y, x = pts[0]  # the first pixel in row order: some window holds it
        return any(cover([(py, px) for py, px in pts
                          if not (y0 <= py < y0 + s and x0 <= px < x0 + s)], k - 1)
                   for y0 in range(y - s + 1, y + 1) for x0 in range(x - s + 1, x + 1))

    return cover([(int(y), int(x)) for y, x in torch.nonzero(torch.as_tensor(mask)).tolist()], k)


def splat_(img: torch.Tensor, rfilter: str, pos: torch.Tensor, layers: torch.Tensor,
           mask: torch.Tensor | None = None) -> None:
    """Scatter-add filtered samples into `img` [K,H,W,4] (rgb·w, w) in place.

    pos [N,2] continuous pixel coordinates; layers [K,N,3] per-sample values.
    A sample outside the image (or a padding lane) adds nothing, nor does a
    lane where `mask` [N] bool is False: its filter weight becomes 0 and it
    keeps its in-bounds position, as in the JAX `film.splat` (film.py:59-85),
    so the masked lanes of `render/wavefront.py` (most of each iteration's)
    do not all add into one pixel.

    A CUDA film takes one launch of the kernel, which raises where `pos` or
    `layers` requires grad (autograd follows `splat`); a CPU film the plain
    body `_splat_plain_`.
    """
    if img.is_cuda:
        film_kernel.splat(img, rfilter, pos, layers, mask)
    else:
        _splat_plain_(img, rfilter, pos, layers, mask)


def _splat_plain_(img: torch.Tensor, rfilter: str, pos: torch.Tensor, layers: torch.Tensor,
                  mask: torch.Tensor | None = None) -> None:
    """`splat_` in plain torch, one accumulating `index_put_` a filter tap:
    the CPU's splat, which autograd follows (through `splat`), and the
    kernels' contract."""
    k, height, width, _ = img.shape
    radius = FILTER_RADIUS[rfilter]
    support = _support(rfilter)
    px = pos[:, 0] - 0.5
    py = pos[:, 1] - 0.5
    x0 = torch.floor(px - radius + 1.0).to(torch.int64)
    y0 = torch.floor(py - radius + 1.0).to(torch.int64)
    flat = img.view(k, height * width, 4)
    for dy in range(support):
        for dx in range(support):
            ix = x0 + dx
            iy = y0 + dy
            w = _filter_eval(rfilter, px - ix.to(torch.float32)) * _filter_eval(
                rfilter, py - iy.to(torch.float32))
            inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
            if mask is not None:
                inside = inside & mask
            w = torch.where(inside, w, 0.0)
            idx = torch.clamp(iy, 0, height - 1) * width + torch.clamp(ix, 0, width - 1)
            vals = torch.cat([layers * w[None, :, None], w.expand(k, -1)[..., None]], dim=-1)
            flat.index_put_((torch.arange(k, device=img.device)[:, None], idx[None, :]), vals,
                            accumulate=True)


def splat(width: int, height: int, rfilter: str, pos: torch.Tensor,
          layers: torch.Tensor) -> torch.Tensor:
    """`splat_` into a fresh zero film → [K,H,W,4] (the JAX `film.splat`),
    differentiable with respect to `layers`. On the CPU autograd follows the
    plain body's accumulating `index_put_` (and, through the filter weights,
    `pos`); on a card `_CardSplat`, whose backward gathers the film's
    gradient at each lane's taps in one launch, and which refuses a `pos`
    that requires grad: no caller's positions carry a gradient."""
    if layers.is_cuda:
        if pos.requires_grad:
            raise ValueError("a card's splat takes no gradient to pos: detach it")
        return _CardSplat.apply(width, height, rfilter, pos, layers)
    img = torch.zeros((layers.shape[0], height, width, 4), dtype=torch.float32,
                      device=layers.device)
    _splat_plain_(img, rfilter, pos, layers)
    return img


class _CardSplat(torch.autograd.Function):
    """`splat` on a card: forward one launch of `splat_kernel` into a fresh
    film, backward one of its adjoint, `splat_grad_kernel` (the `layers`
    gradient, linear in the film's; the plain body's backward is the same
    gather, tap by tap)."""

    @staticmethod
    def forward(ctx, width, height, rfilter, pos, layers):
        img = torch.zeros((layers.shape[0], height, width, 4), dtype=torch.float32,
                          device=layers.device)
        film_kernel.splat(img, rfilter, pos, layers.detach())
        ctx.save_for_backward(pos)
        ctx.rfilter = rfilter
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        return None, None, None, None, film_kernel.splat_grad(grad, ctx.rfilter, pos)


def to_bitmap(img: torch.Tensor) -> torch.Tensor:
    """[..,H,W,4] weighted → [..,H,W,3] normalized (block.cpp:76-91)."""
    w = img[..., 3:4]
    return torch.where(w > 1e-9, img[..., :3] / torch.clamp(w, min=1e-9), 0.0)
