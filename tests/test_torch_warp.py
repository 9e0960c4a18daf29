"""The port's warps and their pdfs (`core/warp.py`) against the JAX
package's, and `warptest` on the CPU.

* every pdf that `cmd_warptest` and the JAX `core/warp.py` name, on the
  same float32 points (the warp's own samples, points just off its domain,
  and random points), to 1e-5 relative, in one parametrised test;
* each pdf integrates to 1 over its domain (midpoint rule) within 1e-3;
* `warptest --device cpu` passes its seven χ² cases through `cli.main`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core import warp as jwarp
from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.core import warp

# name → (warp, pdf, parameters): the warps whose pdfs this port added, and
# the two phase functions that `warptest` also runs
CASES = {
    "uniform_square": ("square_to_uniform_square", "square_to_uniform_square_pdf", ()),
    "uniform_disk": ("square_to_uniform_disk", "square_to_uniform_disk_pdf", ()),
    "uniform_sphere": ("square_to_uniform_sphere", "square_to_uniform_sphere_pdf", ()),
    "sphere_cap": ("square_to_uniform_sphere_cap", "square_to_uniform_sphere_cap_pdf", (0.5,)),
    "uniform_hemisphere": ("square_to_uniform_hemisphere", "square_to_uniform_hemisphere_pdf",
                           ()),
    "cosine_hemisphere": ("square_to_cosine_hemisphere", "square_to_cosine_hemisphere_pdf", ()),
    "beckmann": ("square_to_beckmann", "square_to_beckmann_pdf", (0.3,)),
    "henyey_greenstein": ("square_to_henyey_greenstein", "square_to_henyey_greenstein_pdf",
                          (0.5,)),
    "schlick": ("square_to_schlick", "square_to_schlick_pdf", (0.5,)),
}


def _params(params, torch_side):
    return tuple(torch.tensor(p) if torch_side else p for p in params)


def _points(fn, params) -> np.ndarray:
    """The warp's samples, the same points scaled just off the domain, and
    random points of the warp's dimension, float32."""
    r = np.random.default_rng(7)
    u = r.random((2000, 2), dtype=np.float32)
    on = fn(torch.from_numpy(u), *_params(params, True)).numpy()
    dim = on.shape[-1]
    rand = r.uniform(-1.2, 1.2, (2000, dim)).astype(np.float32)
    if dim == 3:
        rand[:1000] /= np.linalg.norm(rand[:1000], axis=-1, keepdims=True)
    return np.concatenate([on, on * np.float32(1.001), rand, -on])


@pytest.mark.parametrize("name", list(CASES))
def test_pdf_matches_jax(name):
    w, pdf, params = CASES[name]
    pts = _points(getattr(warp, w), params)
    ours = getattr(warp, pdf)(torch.from_numpy(pts), *_params(params, True)).numpy()
    theirs = np.asarray(getattr(jwarp, pdf)(jnp.asarray(pts), *params))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7)
    if name not in ("henyey_greenstein", "schlick"):  # the phase functions have no zeros
        assert (ours > 0).any() and (ours == 0).any()
    # the warp itself agrees too
    u = np.random.default_rng(3).random((500, 2), dtype=np.float32)
    np.testing.assert_allclose(getattr(warp, w)(torch.from_numpy(u), *_params(params, True)),
                               np.asarray(getattr(jwarp, w)(jnp.asarray(u), *params)),
                               rtol=1e-5, atol=1e-6)


def _sphere_integral(pdf_fn, n=450) -> float:
    # n = 450 puts θ = π/3 (the cap) and π/2 (the hemispheres) on cell edges
    t = (np.arange(n) + 0.5) * np.pi / n
    p = (np.arange(2 * n) + 0.5) * np.pi / n
    tt, pp = np.meshgrid(t, p, indexing="ij")
    d = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1)
    v = pdf_fn(torch.from_numpy(d.reshape(-1, 3).astype(np.float32))).double().numpy()
    return float((v.reshape(tt.shape) * np.sin(tt)).sum() * (np.pi / n) ** 2)


def _plane_integral(pdf_fn, lo, hi, n=800) -> float:
    x = lo + (np.arange(n) + 0.5) * (hi - lo) / n
    xx, yy = np.meshgrid(x, x, indexing="ij")
    v = pdf_fn(torch.from_numpy(np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)))
    return float(v.double().sum() * ((hi - lo) / n) ** 2)


@pytest.mark.parametrize("name", list(CASES))
def test_pdf_integrates_to_one(name):
    _, pdf, params = CASES[name]
    fn = lambda x: getattr(warp, pdf)(x, *_params(params, True))  # noqa: E731
    if name == "uniform_square":
        total = _plane_integral(fn, -0.5, 1.5)
    elif name == "uniform_disk":
        total = _plane_integral(fn, -1.5, 1.5)
    else:
        total = _sphere_integral(fn)
    assert abs(total - 1.0) < 1e-3, total


def test_warptest_cli_cpu(capsys):
    assert cli.main(["warptest", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 7 and all(ln.startswith("PASS") for ln in lines)
