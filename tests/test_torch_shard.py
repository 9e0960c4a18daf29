"""The port's multi-device rendering (`parallel/shard.py`) on the CPU, with
meshes of repeated CPU entries, against itself and the JAX package.

* `make_mesh` factors n entries as the JAX `make_mesh` factors n devices
  (8 → (4, 2));
* `pathk_trace_ref` over pixel ranges (`pix0`) equals one call bit for bit,
  on the small and the medium branch, at range boundaries that are not
  multiples of 32 or 640;
* `render_sharded` on the kernel path equals `render()` bit for bit, with
  one launch per mesh entry and group;
* on the scan path each slab's per-lane layers (`render._round_layers`)
  equal the whole image's bit for bit, and the film is within 2e-4 of
  `render()` (atol; tests/test_render.py:83 holds the JAX package so: the
  partial films are summed in another order);
* the film against the JAX `render_sharded(..., mega=False)` on the
  conftest's 8 virtual CPU devices (24×16 Cornell, depth 3, 2 spp) by
  tests/test_mega.py:203-211's statistic (median relative error < 1e-3,
  means within 10 %), as tests/test_torch_general.py holds the scan path;
* resuming from a checkpoint whose samples are not a multiple of the
  sample axis raises `ValueError`; previews come every k samples;
* `sharded_train_step` equals `train_step` on all lanes: loss rel 1e-5,
  gradients within 1e-5 (atol; the films are summed in another order),
  finite, `em_radiance`'s non-zero (tests/test_render.py:120-150).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.parallel import shard as jshard
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.parallel import shard
from optix_renderer_tpu_torch.render import render as render_mod
from optix_renderer_tpu_torch.render.render import render, save_checkpoint
from optix_renderer_tpu_torch.scene import presets

CPU = torch.device("cpu")
LAYERS = ("composite", "albedo", "normal", "weights")


def _mesh(n: int):
    return shard.make_mesh(devices=[CPU] * n)


def _cornell(w=24, h=16, spp=2, depth=3, rfilter="gaussian"):
    s, c, _ = presets.make_cornell_box(w, h, spp, "path_mis", device="cpu")
    return s, dataclasses.replace(c, max_depth=depth, rfilter=rfilter)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12])
def test_make_mesh_factors_like_jax(n):
    mesh = _mesh(n)
    jmesh = jshard.make_mesh(devices=(jax.devices() * 2)[:n]) if n <= 8 else None
    want = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2), 6: (3, 2), 8: (4, 2), 9: (3, 3),
            12: (4, 3)}[n]
    assert mesh.shape == want and mesh.size == n and len(mesh.flat) == n
    assert mesh.first == CPU and mesh.distinct == [CPU]
    if jmesh is not None:
        assert tuple(jmesh.devices.shape) == want


def test_a_cuda_mesh_without_a_gpu_raises():
    """No fallback: the default mesh, the multi-process mesh and joining a
    process group on `cuda` raise where torch sees no GPU."""
    from optix_renderer_tpu_torch.parallel import multihost

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for fn in (shard.make_mesh, multihost.make_multihost_mesh,
               lambda: multihost.init_distributed("localhost:1", 1, 0, backend="gloo")):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    with pytest.raises(RuntimeError, match="cuda"):
        shard.render_sharded(*_cornell())


@pytest.mark.parametrize("branch", ["small", "medium"])
def test_split_ranges_equal_one_call(branch):
    if branch == "small":
        scene, cfg = _cornell()
    else:
        scene, cfg, _ = presets.make_tessellated_cornell(24, 16, 2, "path_mis", nu=12, nv=7,
                                                         device="cpu")
        cfg = dataclasses.replace(cfg, max_depth=3)
    tables, meta = pathk.build_pathk_tables(scene, cfg)
    assert (meta["t_cnt"] > pathk.VPU_MAX_TRIS) == (branch == "medium")
    n_pix = cfg.width * cfg.height
    whole = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=1, n_spp=2)
    cuts = (0, 101, 267, n_pix)
    parts = [pathk.pathk_trace(tables, meta, cfg, n_pix=b - a, spp0=1, n_spp=2, pix0=a)
             for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts, dim=1), whole)
    with pytest.raises(ValueError, match="out of range"):
        pathk._check_sizes(cfg, 10, 0, 2, pix0=2**31 - 5)


def test_pixel_ranges_and_tile_slabs_cover_the_image():
    assert shard.pixel_ranges(10, 4) == [(0, 3), (3, 3), (6, 3), (9, 1)]
    assert sum(n for _, n in shard.pixel_ranges(384, 8)) == 384
    _, cfg = _cornell()
    mesh = _mesh(8)
    slabs = shard.tile_slabs(cfg, mesh)
    assert len(slabs) == 4 and all(s.numel() == 96 for s in slabs)
    assert torch.equal(torch.cat(slabs), torch.arange(384))
    ids = shard.tile_slabs(cfg, _mesh(5))  # (5, 1): 384 lanes padded to 385
    assert ids[-1][-1] == -4 * 24 and torch.cat(ids)[:384].equal(torch.arange(384))


def test_kernel_path_equals_render(monkeypatch):
    scene, cfg = _cornell()
    ref = render(scene, cfg, device="cpu")
    calls = []
    trace = pathk.pathk_trace

    def counted(*a, **k):
        calls.append(k["pix0"])
        return trace(*a, **k)

    monkeypatch.setattr(pathk, "pathk_trace", counted)
    out = shard.render_sharded(scene, cfg, _mesh(8))
    assert out["spp_done"] == 2
    assert sorted(calls) == [0, 48, 96, 144, 192, 240, 288, 336]  # one launch per entry
    for k in LAYERS:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def scan_pair():
    scene, cfg = _cornell(rfilter="mitchell")
    return scene, cfg, render(scene, cfg, device="cpu", mega=False)


def test_scan_path_lanes_equal_and_film_close(scan_pair):
    scene, cfg, ref = scan_pair
    mesh = _mesh(8)
    for si in range(2):
        pos, layers = render_mod._round_layers(scene, cfg, torch.arange(384), si)
        for t, slab in enumerate(shard.tile_slabs(cfg, mesh)):
            p, lay = render_mod._round_layers(scene, cfg, slab, si)
            assert torch.equal(p, pos[slab]) and torch.equal(lay, layers[:, slab]), (si, t)
    out = shard.render_sharded(scene, cfg, mesh, mega=False)
    assert out["spp_done"] == 2
    for k in LAYERS:
        np.testing.assert_allclose(out[k], ref[k], atol=2e-4, err_msg=k)


def test_scan_film_matches_jax_render_sharded():
    js, jc, _ = jpresets.make_cornell_box(width=24, height=16, spp=2, integrator="path_mis")
    jc = dataclasses.replace(jc, max_depth=3)
    jmesh = jshard.make_mesh()
    assert tuple(jmesh.devices.shape) == (4, 2)
    ref = jshard.render_sharded(js, jc, jmesh, sample_count=2, mega=False)
    scene, cfg = _cornell(rfilter=jc.rfilter)
    got = shard.render_sharded(scene, cfg, _mesh(8), sample_count=2, mega=False)
    assert got["spp_done"] == ref["spp_done"] == 2
    a, b = np.asarray(ref["composite"]), got["composite"]
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


def test_resume_off_the_sample_axis_raises(tmp_path, scan_pair):
    scene, cfg, ref = scan_pair
    ckpt = str(tmp_path / "ck.npz")
    acc = torch.zeros((3, cfg.height, cfg.width, 4))
    save_checkpoint(ckpt, acc, 1, cfg)
    with pytest.raises(ValueError, match="not a multiple of this mesh's sample axis"):
        shard.render_sharded(scene, cfg, _mesh(8), checkpoint_path=ckpt, resume=True, mega=False)
    # a checkpoint of a whole round resumes, and the previews come per round
    save_checkpoint(ckpt, acc, 2, cfg)
    seen = []
    out = shard.render_sharded(scene, cfg, _mesh(8), sample_count=6, checkpoint_path=ckpt,
                               resume=True, mega=False, preview_every=2,
                               preview_callback=lambda layers, n: seen.append(n))
    assert out["spp_done"] == 6 and seen == [4, 6]


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_train_step_equals_train_step(n):
    """On a mesh of n entries ((2, 1) or (4, 2)) against `train_step` on
    every lane at each of the mesh's samples in one film."""
    scene, cfg = _cornell(w=16, h=12, depth=2)
    target = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (12, 16, 3))
                              .astype(np.float32))
    ids = torch.arange(16 * 12)
    mesh = _mesh(n)
    loss, grads = shard.sharded_train_step(scene, cfg, mesh, target, ids, 5)
    n_s = mesh.shape[1]
    all_ids = torch.cat([ids] * n_s)
    samples = torch.cat([torch.full_like(ids, 5 + s) for s in range(n_s)])
    ref_loss, ref = shard.train_step(scene, cfg, target, all_ids,
                                     samples if n_s > 1 else 5, device="cpu")
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert set(grads) == {"tex_value", "bsdf_kd", "bsdf_alpha", "em_radiance"}
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert float(grads["em_radiance"].abs().sum()) > 0
