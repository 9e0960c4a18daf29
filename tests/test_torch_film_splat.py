"""The filter splat's kernels (`csrc/film.cu: splat_kernel`, its adjoint
`splat_grad_kernel`, `ops/cuda/film.py`) and who takes them
(`render/film.py: splat_`, `splat`).

On the CPU: the kernels' lane bodies built by g++ (`film_splat_host`,
serial) against the plain body `_splat_plain_` and its autograd for the four
filters, one and three layers, positions on the image's edges and corners, a
masked subset and padding lanes far outside the image (within 1e-6 of each
layer's largest value: only the order of the adds differs); a card's
autograd function `_CardSplat` on those host builds against the plain
body's film and gradient; the CPU's films take the plain body, a
differentiable `splat` keeps its gradient, a scene that requires grad
renders the film it renders without, the wrapper refuses what the kernel
does not take, and a traced CPU round counts `scan.rounds_splatted` 0.

On a card (`-m card`; they skip without one): the kernel against the plain
body on config A's and config B's real 800x600 round and on a masked
wavefront-like batch, its launches through a replayed round, the counter,
the refusal of inputs that require grad, `splat`'s film and gradient (one
launch each way) against the CPU's, `train_step`'s gradients against the
CPU's and `render()` of a scene that requires grad. This file imports no
JAX:

    python -m pytest tests/test_torch_film_splat.py -m card --noconftest -p no:cacheprovider
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.ops.cuda import film as film_kernel
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import render as render_mod
from optix_renderer_tpu_torch.render import scan_graph
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.utils import tracing

CSRC = Path(film.__file__).resolve().parents[1] / "csrc"
FILTERS = ["box", "tent", "gaussian", "mitchell"]
W, H = 16, 12


def _samples(n=600, k=3, seed=0, width=W, height=H):
    """(pos [N,2], layers [K,N,3], mask [N]): random positions over the image
    and a margin around it, the edges and corners exactly, lanes just
    outside, and padding lanes far outside (the scan path's and beyond)."""
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 2), generator=gen) * torch.tensor([width + 6.0, height + 6.0]) - 3.0
    edges = torch.tensor([[0.0, 0.0], [width, 0.0], [0.0, height], [width, height],
                          [width * 0.5, 0.0], [0.0, height * 0.5], [width, height * 0.5],
                          [width * 0.5, height], [-0.5, -0.5], [width + 0.5, height + 0.5],
                          [-1.9, 3.0], [width + 1.9, 3.0], [3.0, -2.5], [3.0, height + 2.5],
                          [0.25, 0.75], [width - 0.25, height - 0.75]])
    pad = torch.tensor([[0.3, -4.0 + 0.6], [-4.0 * max(width, height), 2.0], [1e9, 1e9],
                        [-1e9, 5.0], [5.0, 1e9]])
    pos = torch.cat([pos, edges, pad])
    m = pos.shape[0]
    layers = torch.randn((k, m, 3), generator=gen)
    mask = torch.rand(m, generator=gen) < 0.3
    return pos, layers, mask


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`csrc/film.cu`'s lane bodies built by g++ (`film_splat_host`), or a
    skip."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("film_host") / "libfilm.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-x", "c++", "-o", str(so), str(CSRC / "film.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.film_splat_host.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i]
    lib.film_splat_host.restype = i
    return lib


def _host_call(lib, img, rfilter, pos, layers, mask, grad):
    k, h, w, _ = img.shape
    assert img.is_contiguous() and layers.is_contiguous()
    pos = pos.contiguous()
    rc = lib.film_splat_host(img.data_ptr(), pos.data_ptr(), layers.data_ptr(),
                             None if mask is None else mask.contiguous().data_ptr(),
                             k, h, w, pos.shape[0], film_kernel.FILTER_CODE[rfilter], int(grad))
    assert rc == 0


@pytest.fixture(scope="module")
def host_splat(host_lib):
    """`film_splat_host` as a `splat_`."""

    def splat_(img, rfilter, pos, layers, mask=None):
        _host_call(host_lib, img, rfilter, pos, layers.contiguous(), mask, grad=False)

    return splat_


@pytest.fixture(scope="module")
def host_splat_grad(host_lib):
    """`film_splat_host`'s adjoint as `ops/cuda/film.py: splat_grad`."""

    def splat_grad(grad, rfilter, pos):
        out = torch.zeros((grad.shape[0], pos.shape[0], 3))
        _host_call(host_lib, grad.contiguous(), rfilter, pos, out, None, grad=True)
        return out

    return splat_grad


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rfilter", FILTERS)
def test_the_kernels_body_on_the_host_gives_the_plain_film(host_splat, rfilter, k, masked):
    pos, layers, mask = _samples(k=k, seed=k + 7 * FILTERS.index(rfilter))
    mask = mask if masked else None
    got = torch.zeros((k, H, W, 4))
    host_splat(got, rfilter, pos, layers, mask)
    want = torch.zeros((k, H, W, 4))
    film._splat_plain_(want, rfilter, pos, layers, mask)
    assert float(want[..., 3].sum()) > 0
    # mitchell's negative lobes cancel: the tolerance scales with each layer's largest value
    scale = want.abs().amax(dim=(1, 2, 3), keepdim=True)
    assert torch.all((got - want).abs() <= 1e-6 * (want.abs() + scale)), \
        float((got - want).abs().max())
    # the padding lanes (the last five), whose footprints miss the image, add nothing
    alone = torch.zeros((k, H, W, 4))
    host_splat(alone, rfilter, pos[-5:], layers[:, -5:], None)
    assert not alone.any()


@pytest.mark.parametrize("rfilter", FILTERS)
def test_a_masked_off_lane_adds_nothing_on_the_host(host_splat, rfilter):
    pos, layers, mask = _samples(seed=3)
    full = torch.zeros((3, H, W, 4))
    host_splat(full, rfilter, pos, layers, mask)
    subset = torch.zeros((3, H, W, 4))
    host_splat(subset, rfilter, pos[mask], layers[:, mask])
    assert torch.equal(full, subset)  # the same adds in the same order


def _plain_grad(rfilter, pos, layers0, big_g):
    """(film, gradient of <film, big_g> with respect to the layers) of the
    plain body, which autograd follows."""
    layers = layers0.clone().requires_grad_(True)
    img = torch.zeros(big_g.shape)
    film._splat_plain_(img, rfilter, pos, layers)
    (g,) = torch.autograd.grad((img * big_g).sum(), layers)
    return img.detach(), g


def _close(got, want):
    """Within 1e-6 of each layer's largest value."""
    scale = want.abs().amax(dim=tuple(range(1, want.dim())), keepdim=True)
    assert torch.all((got - want).abs() <= 1e-6 * (want.abs() + scale)), \
        float((got - want).abs().max())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("rfilter", FILTERS)
def test_the_adjoints_body_on_the_host_gives_the_plain_gradient(host_splat_grad, rfilter, k):
    pos, layers, _ = _samples(k=k, seed=41 + k + 7 * FILTERS.index(rfilter))
    big_g = torch.randn((k, H, W, 4), generator=torch.Generator().manual_seed(k))
    _, want = _plain_grad(rfilter, pos, layers, big_g)
    got = host_splat_grad(big_g, rfilter, pos)
    assert float(want.abs().max()) > 0
    _close(got, want)
    # the padding lanes (the last five) and the lanes outside the image get 0
    assert not got[:, -5:].any()


@pytest.mark.parametrize("rfilter", FILTERS)
def test_the_card_autograd_function_on_the_host_bodies_gives_the_plain_film_and_gradient(
        host_splat, host_splat_grad, monkeypatch, rfilter):
    """`_CardSplat` with the kernels' wrappers swapped for their g++ builds:
    its forward splats the layers detached into a fresh film, its backward
    hands the adjoint's gradient to `layers` alone."""
    monkeypatch.setattr(film_kernel, "splat", lambda img, rf, pos, layers, mask=None: (
        host_splat(img, rf, pos, layers, mask)))
    monkeypatch.setattr(film_kernel, "splat_grad", host_splat_grad)
    pos, layers0, _ = _samples(seed=43 + FILTERS.index(rfilter))
    big_g = torch.randn((3, H, W, 4), generator=torch.Generator().manual_seed(6))
    want_img, want_g = _plain_grad(rfilter, pos, layers0, big_g)
    layers = layers0.clone().requires_grad_(True)
    out = film._CardSplat.apply(W, H, rfilter, pos, layers)
    assert out.requires_grad
    _close(out.detach(), want_img)
    (g,) = torch.autograd.grad((out * big_g).sum(), layers)
    _close(g, want_g)


# ---------------------------------------------------------------- who takes it


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernel's wrapper raises if called."""

    def refuse(*a, **kw):
        raise AssertionError("a CPU film reached the kernel's wrapper")

    monkeypatch.setattr(film_kernel, "splat", refuse)


@pytest.mark.parametrize("rfilter", FILTERS)
def test_a_cpu_film_takes_the_plain_body(no_kernel, rfilter):
    pos, layers, mask = _samples(seed=11)
    for m in (None, mask):
        got = torch.zeros((3, H, W, 4))
        film.splat_(got, rfilter, pos, layers, mask=m)
        want = torch.zeros((3, H, W, 4))
        film._splat_plain_(want, rfilter, pos, layers, m)
        assert torch.equal(got, want)
    fresh = film.splat(W, H, rfilter, pos, layers)
    want = torch.zeros((3, H, W, 4))
    film._splat_plain_(want, rfilter, pos, layers)
    assert torch.equal(fresh, want)


@pytest.mark.parametrize("rfilter", FILTERS)
def test_splat_of_layers_that_require_grad_keeps_its_gradient(no_kernel, rfilter):
    """`splat` with `layers.requires_grad` runs the plain body, whose
    gradient is the adjoint of the splat (linear in `layers`)."""
    pos, layers0, _ = _samples(seed=13)
    layers = layers0.clone().requires_grad_(True)
    out = film.splat(W, H, rfilter, pos, layers)
    assert out.requires_grad
    big_g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    inner = (out * big_g).sum()
    (g,) = torch.autograd.grad(inner, layers)
    img = torch.zeros((3, H, W, 4))
    ref_layers = layers0.clone().requires_grad_(True)
    film._splat_plain_(img, rfilter, pos, ref_layers)
    (g_ref,) = torch.autograd.grad((img * big_g).sum(), ref_layers)
    assert torch.equal(g, g_ref)
    wsum = (out.detach()[..., 3] * big_g[..., 3]).sum()  # the weights' part holds no layer
    assert float((layers0 * g).sum()) == pytest.approx(float(inner.detach() - wsum), rel=1e-5)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    pos, layers, mask = _samples(seed=17)
    img = torch.zeros((3, H, W, 4))
    with pytest.raises(ValueError, match="detached"):
        film_kernel.splat(img, "gaussian", pos, layers.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="detached"):
        film_kernel.splat(img, "gaussian", pos.clone().requires_grad_(True), layers)
    with pytest.raises(ValueError, match="CUDA device"):
        film_kernel.splat(img, "gaussian", pos, layers, mask)
    with pytest.raises(ValueError, match="CUDA device"):
        film_kernel.splat_grad(img, "gaussian", pos)


def test_a_scene_that_requires_grad_renders_the_film_of_one_that_does_not(tmp_path):
    """`render()` of a scene whose tables require grad splats its layers
    detached (the film carries no gradient): the same film bit for bit."""
    xml = presets.cornell_box_xml(tmp_path, 8, 6, 2, "path_mis")
    scene, cfg, _ = build.load_scene(str(xml), device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=2)
    want = render_mod.render(scene, cfg, sample_count=2, device="cpu", mega=False)
    live = dataclasses.replace(scene, bsdfs=dataclasses.replace(
        scene.bsdfs, kd=scene.bsdfs.kd.clone().requires_grad_(True)))
    got = render_mod.render(live, cfg, sample_count=2, device="cpu", mega=False)
    for name in ("composite", "albedo", "normal", "weights"):
        assert np.array_equal(got[name], want[name]), name


def test_a_traced_cpu_round_counts_no_splatted_round(tmp_path):
    xml = presets.cornell_box_xml(tmp_path, 8, 6, 2, "path_mis")
    scene, cfg, _ = build.load_scene(str(xml), device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=2)
    tracing.enable()
    try:
        before = tracing.counters("scan.rounds")
        render_mod.render(scene, cfg, sample_count=2, device="cpu", mega=False)
    finally:
        tracing.enable(False)
    after = tracing.counters("scan.rounds")
    got = {k: v - before.get(k, 0) for k, v in after.items()}
    assert got["scan.rounds"] == 2 and got["scan.rounds_splatted"] == 0


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from optix_renderer_tpu_torch.ops.cuda import _build

    _build.load()
    return torch.device("cuda", 0)


def _film_close(got, want):
    """Films that added the same samples in another order: the tolerance of
    `tests/test_torch_scan_graph.py: _film_close`, layer by layer."""
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    for c in range(want.shape[0]):
        for part, sl in (("rgb", slice(0, 3)), ("w", slice(3, 4))):
            x, y = got[c, ..., sl], want[c, ..., sl]
            np.testing.assert_allclose(x, y, rtol=1e-5,
                                       atol=1e-6 * max(1.0, float(np.abs(y).max())),
                                       err_msg=f"layer {c} {part}")


def _kernel_and_plain(rfilter, pos, layers, mask, h, w):
    dev = pos.device
    got = torch.zeros((layers.shape[0], h, w, 4), device=dev)
    before = tracing.counter("launch.film_splat")
    film.splat_(got, rfilter, pos, layers, mask=mask)
    assert tracing.counter("launch.film_splat") == before + 1
    want = torch.zeros_like(got)
    film._splat_plain_(want, rfilter, pos, layers, mask)
    torch.cuda.synchronize()
    return got, want


@pytest.fixture(scope="module")
def card_scenes():
    """{name: (scene, config)} on the card at 800x600: config A (depth 8,
    gaussian) and config B (the Cornell box, depth 16, mitchell)."""
    dev = _card()
    a, cfg_a, _ = presets.make_tessellated_cornell(800, 600, 4, "path_mis", device=dev)
    b, cfg_b, _ = presets.make_cornell_box(800, 600, 4, "path_mis", device=dev)
    return {"configA": (a, dataclasses.replace(cfg_a, max_depth=8)),
            "configB": (b, dataclasses.replace(cfg_b, max_depth=16, rfilter="mitchell"))}


@pytest.mark.card
@pytest.mark.parametrize("name", ["configA", "configB"])
def test_the_kernel_gives_the_plain_film_on_a_real_round(card_scenes, name):
    """One sample round of every pixel, chunked (and padded, where it pads)
    as `render.scan_step` does it."""
    scene, cfg = card_scenes[name]
    dev = _card()
    n_pix = cfg.width * cfg.height
    pad = -n_pix % min(render_mod.MAX_LANES, n_pix)
    ids = torch.cat([torch.arange(n_pix), torch.full((pad,), -4 * max(cfg.width, cfg.height))])
    sc = scan_graph.shade_scene(scene, cfg, dev)
    pos, layers = render_mod._round_layers(scene, cfg, ids.to(dev), 5, sc)
    got, want = _kernel_and_plain(cfg.rfilter, pos, layers, None, cfg.height, cfg.width)
    assert float(want[0, ..., 3].min()) > 0
    _film_close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("rfilter", FILTERS)
def test_the_kernel_gives_the_plain_film_on_a_masked_batch(rfilter):
    """A wavefront-like batch: 2^19 lanes over and around an 800x600 image,
    a fifth of them set in the mask."""
    dev = _card()
    gen = torch.Generator().manual_seed(23)
    n = 1 << 19
    pos = (torch.rand((n, 2), generator=gen) * torch.tensor([806.0, 606.0]) - 3.0).to(dev)
    layers = torch.randn((3, n, 3), generator=gen).to(dev)
    mask = (torch.rand(n, generator=gen) < 0.2).to(dev)
    got, want = _kernel_and_plain(rfilter, pos, layers, mask, 600, 800)
    _film_close(got, want)
    one, one_want = _kernel_and_plain(rfilter, pos[:1000], layers[:1, :1000], None, 600, 800)
    _film_close(one, one_want)


@pytest.mark.card
def test_a_replayed_scan_render_splats_once_a_round():
    """`launch.film_splat` is 4 per 4-spp render through a replayed round,
    and a traced render counts every round in `scan.rounds_splatted`."""
    dev = _card()
    scene, cfg, _ = presets.make_tessellated_cornell(160, 120, 4, "path_mis", device=dev)
    cfg = dataclasses.replace(cfg, max_depth=8, seed=31)
    render_mod.render(scene, cfg, sample_count=2, device="cuda", mega=False)  # the capture
    captures = tracing.counter("scan.graph_captures")
    before = tracing.counter("launch.film_splat")
    render_mod.render(scene, dataclasses.replace(cfg, seed=32), sample_count=4, device="cuda",
                      mega=False)
    assert tracing.counter("launch.film_splat") - before == 4
    tracing.enable()
    try:
        old = tracing.counters("scan.rounds")
        render_mod.render(scene, dataclasses.replace(cfg, seed=33), sample_count=3,
                          device="cuda", mega=False)
    finally:
        tracing.enable(False)
    got = {k: v - old.get(k, 0) for k, v in tracing.counters("scan.rounds").items()}
    assert got["scan.rounds"] == got["scan.rounds_splatted"] == got["scan.rounds_graphed"] == 3
    assert tracing.counter("scan.graph_captures") == captures


@pytest.mark.card
def test_a_card_splat_of_layers_that_require_grad_raises():
    """`splat_` on a card takes detached inputs; `splat` takes `layers`
    that require grad, not `pos`."""
    dev = _card()
    pos, layers, _ = _samples(seed=19)
    img = torch.zeros((3, H, W, 4), device=dev)
    with pytest.raises(ValueError, match="detached"):
        film.splat_(img, "gaussian", pos.to(dev), layers.to(dev).requires_grad_(True))
    with pytest.raises(ValueError, match="no gradient to pos"):
        film.splat(W, H, "gaussian", pos.to(dev).requires_grad_(True), layers.to(dev))


@pytest.mark.card
@pytest.mark.parametrize("rfilter", FILTERS)
def test_a_card_splat_follows_autograd_as_the_cpu_does(rfilter):
    dev = _card()
    pos, layers, _ = _samples(n=5000, seed=29, width=64, height=48)
    big_g = torch.randn((3, 48, 64, 4), generator=torch.Generator().manual_seed(4))
    grads, films = [], []
    for d in ("cpu", dev):
        before = tracing.counters("launch.film_splat")
        lay = layers.to(d).requires_grad_(True)
        out = film.splat(64, 48, rfilter, pos.to(d), lay)
        assert out.requires_grad
        (g,) = torch.autograd.grad((out * big_g.to(d)).sum(), lay)
        grads.append(g)
        films.append(out.detach())
        moved = {k: v - before.get(k, 0) for k, v in tracing.counters("launch.film_splat").items()}
        want = 1 if d == dev else 0  # one launch forward, one backward, on the card
        assert moved.get("launch.film_splat", 0) == moved.get("launch.film_splat_grad", 0) == want
    _film_close(films[1], films[0])
    np.testing.assert_allclose(grads[1].cpu().numpy(), grads[0].numpy(), rtol=1e-5,
                               atol=1e-6 * max(1.0, float(grads[0].abs().max())))


@pytest.mark.card
def test_a_card_train_step_gives_the_cpus_gradients():
    """`parallel/shard.py: train_step` at 64x48, depth 3, on the box with its
    odd diffuse rows made microfacet (so that every key reaches the loss):
    each key's directional derivative on the card within 1e-3 of the CPU's,
    through one splat launch forward and one backward."""
    from optix_renderer_tpu_torch.parallel.shard import train_step
    from optix_renderer_tpu_torch.scene.data import BsdfType

    dev = _card()
    scene, cfg, _ = presets.make_cornell_box(64, 48, 1, "path_mis", device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=3)
    b = scene.bsdfs
    odd = (torch.arange(b.type.shape[0]) % 2 == 1) & (b.type == BsdfType.DIFFUSE)
    scene = dataclasses.replace(scene, bsdfs=dataclasses.replace(
        b, type=torch.where(odd, BsdfType.MICROFACET, b.type).to(b.type.dtype),
        ks=torch.where(odd, 0.3, b.ks), alpha=torch.where(odd, 0.3, b.alpha)))
    target = torch.from_numpy(np.random.default_rng(22).uniform(0, 1, (48, 64, 3))
                              .astype(np.float32))
    dirs = {}
    for d in ("cpu", dev):
        before = tracing.counters("launch.film_splat")
        _, grads = train_step(scene, cfg, target, torch.arange(64 * 48), 0, device=d)
        moved = {k: v - before.get(k, 0) for k, v in tracing.counters("launch.film_splat").items()}
        if d == dev:
            assert moved == {"launch.film_splat": 1, "launch.film_splat_grad": 1}
        gen = torch.Generator().manual_seed(20)
        dirs[str(d)] = {k: float((g.cpu() * torch.randn(g.shape, generator=gen)).sum())
                        for k, g in grads.items()}
    cpu, card = dirs["cpu"], dirs[str(dev)]
    assert set(cpu) == {"tex_value", "bsdf_kd", "bsdf_alpha", "em_radiance"}
    for k, v in cpu.items():
        assert v != 0 and abs(card[k] - v) <= 1e-3 * abs(v), (k, card[k], v)


@pytest.mark.card
def test_a_card_render_of_a_scene_that_requires_grad_splats_detached():
    """`render()` of a scene whose `kd` requires grad takes the eager round
    (not `graphable`) and the torch chain, splats its layers detached in the
    kernel and gives the film of the same scene without the gradient (the
    shading kernel's, replayed): the weights up to the order of adds, the
    layers within the shading tests' 1e-4 × (|value| + 1e-3) outside a
    few pixels, where a lane's path took another branch."""
    dev = _card()
    scene, cfg, _ = presets.make_cornell_box(160, 120, 2, "path_mis", device=dev)
    cfg = dataclasses.replace(cfg, max_depth=4, seed=37)
    want = render_mod.render(scene, cfg, sample_count=2, device="cuda", mega=False)
    live = dataclasses.replace(scene, bsdfs=dataclasses.replace(
        scene.bsdfs, kd=scene.bsdfs.kd.clone().requires_grad_(True)))
    before = tracing.counter("launch.film_splat")
    got = render_mod.render(live, cfg, sample_count=2, device="cuda", mega=False)
    assert tracing.counter("launch.film_splat") - before == 2
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=1e-5, atol=1e-6)
    for name in ("composite", "albedo", "normal"):
        off = np.abs(got[name] - want[name]) > 1e-4 * (np.abs(want[name]) + 1e-3)
        assert off.any(axis=-1).mean() <= 0.02, (name, off.any(axis=-1).mean())
