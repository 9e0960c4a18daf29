"""The filter splat as one CUDA kernel: a round's samples added into the
weighted film in one launch, and its adjoint for a film autograd follows.

`csrc/film.cu: splat_kernel` does, one thread per lane, what
`render/film.py: _splat_plain_` does with one accumulating `index_put_` a
filter tap: each tap's weight is the product of the lane's x and y filter
weights, and each layer adds (rgb · w, w) into its pixel, here by one float4
atomic add. The values added are the plain body's; the order in which
colliding samples add varies from run to run. A masked-off lane, a tap
outside the image and a padding lane far outside it add nothing.
`splat_grad_kernel` gathers a film's gradient back to the layers: each
lane's taps' rgb gradient times their weights, summed.

`splat` and `splat_grad` launch on CUDA tensors or raise: `render/film.py`
decides which films take them. Each launch adds one to the counter
`launch.film_splat` or `launch.film_splat_grad` (`utils/tracing.py`).
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.ops.cuda import isect

# render/film.py's filters as csrc/film.cu numbers them
FILTER_CODE = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 3}


def _check(img: torch.Tensor, rfilter: str, pos: torch.Tensor, layers: torch.Tensor | None,
           mask: torch.Tensor | None) -> None:
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"the splat kernel runs on a CUDA device, not {dev}: "
                         "`render/film.py: _splat_plain_` is its plain version")
    if rfilter not in FILTER_CODE:
        raise ValueError(f"unknown rfilter '{rfilter}'")
    if (img.dim() != 4 or img.shape[-1] != 4 or img.dtype != torch.float32
            or not img.is_contiguous() or img.data_ptr() % 16):
        raise ValueError(f"img must be a contiguous, 16-byte aligned float32 [K,H,W,4] "
                         f"tensor, got {img.dtype} {tuple(img.shape)}")
    n = pos.shape[0]
    for name, x, shape, dtype in (("pos", pos, (n, 2), torch.float32),
                                  ("layers", layers, (img.shape[0], n, 3), torch.float32),
                                  ("mask", mask, (n,), torch.bool)):
        if x is not None and (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev):
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if n >= 2**31:
        raise ValueError(f"{n} lanes exceed the kernel's 32-bit lane index")


def _launch(img, rfilter, pos, layers, mask, grad: bool) -> None:
    k, h, w, _ = img.shape
    isect._launch("film_splat_launch", "film_splat_grad" if grad else "film_splat",
                  isect._ptr(img), isect._ptr(pos), isect._ptr(layers), isect._ptr(mask),
                  k, h, w, pos.shape[0], FILTER_CODE[rfilter], int(grad), device=img.device)


def splat(img: torch.Tensor, rfilter: str, pos: torch.Tensor, layers: torch.Tensor,
          mask: torch.Tensor | None = None) -> None:
    """One launch of `splat_kernel`: the samples at `pos` [N,2] with values
    `layers` [K,N,3] (and, where `mask` [N] bool is given, only its set
    lanes) added into `img` [K,H,W,4] float32 in place."""
    isect.refuse_graph("film_splat", img, pos, layers)
    _check(img, rfilter, pos, layers, mask)
    if pos.shape[0] == 0:
        return
    mask = None if mask is None else mask.contiguous()
    _launch(img, rfilter, pos.contiguous(), layers.contiguous(), mask, grad=False)


def splat_grad(grad: torch.Tensor, rfilter: str, pos: torch.Tensor) -> torch.Tensor:
    """One launch of `splat_grad_kernel`: the gradient [K,N,3] of the layers
    splatted at `pos` [N,2] (no mask), given the film's gradient `grad`
    [K,H,W,4]."""
    grad = grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    isect.refuse_graph("film_splat_grad", grad, pos)
    _check(grad, rfilter, pos, None, None)
    out = torch.zeros((grad.shape[0], pos.shape[0], 3), dtype=torch.float32,
                      device=grad.device)
    if pos.shape[0]:
        _launch(grad, rfilter, pos.contiguous(), out, None, grad=True)
    return out
