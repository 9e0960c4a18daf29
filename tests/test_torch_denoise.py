"""The denoisers of the port (`denoise/bilateral.py`, `denoise/learned.py`)
against the JAX package, on the CPU.

* `denoise_bilateral` to rtol 1e-5 for `inner_range` 1–3 and `amount` 1–2;
* the learned net's `apply` (single image and batch), `loss_fn` and the
  loss's gradient from JAX's `init_params(0)` carried across, to 1e-5;
* 20 full-batch Adam steps from the same start, held in lockstep with
  optax's trajectory: every loss within 1e-4 relative of optax's, every
  step's parameters within 1e-5;
* checkpoints both ways: the port loads a JAX-written `.npz`, and the JAX
  package loads a port-written one, to the same outputs;
* the port's own analogue of tests/test_denoiser.py: training halves the
  loss and beats the noisy input on held-out noise, the checkpoint
  round-trips bit for bit, and HDR input stays finite and non-negative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.denoise import learned as jlearned
from optix_renderer_tpu.denoise.bilateral import denoise_bilateral as jdenoise_bilateral
from optix_renderer_tpu_torch.denoise import learned
from optix_renderer_tpu_torch.denoise.bilateral import denoise_bilateral


def _synthetic_pairs(n=3, hw=32, seed=0):
    """tests/test_denoiser.py's pairs: piecewise-constant albedo images and
    additive noise."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        albedo = np.repeat(np.repeat(rng.random((hw // 8, hw // 8, 3)), 8, 0), 8, 1).astype(
            np.float32)
        normal = np.tile(np.array([0, 0, 1], np.float32), (hw, hw, 1))
        clean = albedo * 0.8
        noisy = np.clip(clean + rng.normal(0, 0.25, clean.shape).astype(np.float32), 0, None)
        pairs.append(dict(rgb=noisy, albedo=albedo, normal=normal, clean=clean))
    return pairs


def _stack(pairs, key):
    return np.stack([p[key] for p in pairs])


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jlearned.init_params(0))


@pytest.mark.parametrize("inner_range,amount", [(1, 1), (2, 1), (3, 2), (1, 2)])
def test_bilateral_matches_jax(inner_range, amount):
    r = np.random.default_rng(inner_range * 10 + amount)
    rgb = r.uniform(0.0, 3.0, (20, 28, 3)).astype(np.float32)
    var = r.uniform(0.0, 1.3, (20, 28)).astype(np.float32)
    kw = dict(sigma_d=1.7, sigma_vr=0.45, inner_range=inner_range, amount=amount)
    ref = np.asarray(jdenoise_bilateral(jnp.asarray(rgb), jnp.asarray(var), **kw))
    got = denoise_bilateral(torch.from_numpy(rgb), torch.from_numpy(var), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the defaults of the reference plugin
    ref = np.asarray(jdenoise_bilateral(jnp.asarray(rgb), jnp.asarray(var)))
    np.testing.assert_allclose(denoise_bilateral(torch.from_numpy(rgb), torch.from_numpy(var)),
                               ref, rtol=1e-5, atol=1e-6)


def test_params_layout_round_trip(jparams):
    p = learned.params_from_numpy(jparams)
    assert p["w0"].shape == (32, 9, 3, 3) and p["b3"].shape == (3,)
    back = learned.params_to_numpy(p)
    assert sorted(back) == sorted(jparams)
    for k in jparams:
        np.testing.assert_array_equal(back[k], jparams[k])
    # the port's own initialization: He scale, zero biases, the JAX shapes
    own = learned.params_to_numpy(learned.init_params(0, "cpu"))
    for k in jparams:
        assert own[k].shape == jparams[k].shape
    assert np.std(own["w1"]) == pytest.approx(np.sqrt(2.0 / (32 * 9)), rel=0.05)
    assert not own["b0"].any()


def test_apply_loss_and_grad_match_jax(jparams):
    pairs = _synthetic_pairs(n=2, hw=24, seed=3)
    pairs[0]["rgb"][:4] *= 40.0  # HDR
    rgb, alb, nrm, cln = (_stack(pairs, k) for k in ("rgb", "albedo", "normal", "clean"))
    p = learned.params_from_numpy(jparams)
    t = [torch.from_numpy(a) for a in (rgb, alb, nrm, cln)]
    j = [jnp.asarray(a) for a in (rgb, alb, nrm, cln)]
    ref = np.asarray(jlearned.apply(jparams, *j[:3]))
    np.testing.assert_allclose(learned.apply(p, *t[:3]).numpy(), ref, rtol=1e-5, atol=1e-5)
    one = learned.apply(p, t[0][1], t[1][1], t[2][1])
    assert one.shape == (24, 24, 3)
    np.testing.assert_allclose(one.numpy(), ref[1], rtol=1e-5, atol=1e-5)

    jl, jg = jax.value_and_grad(jlearned.loss_fn)(jparams, *j)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = learned.loss_fn(pg, *t)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    grads = learned.params_to_numpy({k: v.grad for k, v in pg.items()})
    for k in jparams:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(grads[k], g, rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)


def test_adam_steps_match_optax(jparams):
    """20 Adam steps held in lockstep with optax's trajectory: at each step
    the port's loss and gradient are taken at optax's parameters, and the
    port's Adam (`learned.adam`, as `train` builds it) advances its own
    moments from them; every loss within 1e-4 relative of optax's, every
    step's parameters within 1e-5 of optax's. Free-running, the two
    trajectories part: once an L1 residual or a ReLU input crosses zero on a
    last-bit difference of the gradient, Adam's normalized step carries it
    on, and over 20 free steps the losses can part by more than 1e-4; so
    the optimizer is held step by step."""
    import optax

    pairs = _synthetic_pairs(n=2, hw=24, seed=7)
    lr, steps = 3e-3, 20
    data = [_stack(pairs, k) for k in ("rgb", "albedo", "normal", "clean")]
    j = [jnp.asarray(a) for a in data]
    t = [torch.from_numpy(a) for a in data]
    opt = optax.adam(lr)

    @jax.jit
    def jstep(params, state):
        loss, g = jax.value_and_grad(jlearned.loss_fn)(params, *j)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, loss

    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = opt.init(jp)
    tp = {k: v.requires_grad_(True) for k, v in learned.params_from_numpy(jparams).items()}
    topt = learned.adam(tp, lr)
    for i in range(steps):
        with torch.no_grad():
            for k, v in tp.items():
                v.copy_(learned.params_from_numpy({k: np.asarray(jp[k])})[k])
        jp, jstate, jloss = jstep(jp, jstate)
        topt.zero_grad(set_to_none=True)
        loss = learned.loss_fn(tp, *t)
        loss.backward()
        topt.step()
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4), i
        got = learned.params_to_numpy(tp)
        for k in jparams:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_checkpoints_cross_load(tmp_path, jparams):
    (test,) = _synthetic_pairs(n=1, hw=16, seed=99)
    t = [torch.from_numpy(test[k]) for k in ("rgb", "albedo", "normal")]
    j = [jnp.asarray(test[k]) for k in ("rgb", "albedo", "normal")]
    # JAX writes, the port reads (the suffix is added as np.savez adds it)
    jlearned.save_checkpoint(str(tmp_path / "jax_ckpt"), jparams)
    p = learned.load_checkpoint(tmp_path / "jax_ckpt", device="cpu")
    ref = np.asarray(jlearned.apply(jparams, *j))
    np.testing.assert_allclose(learned.apply(p, *t).numpy(), ref, rtol=1e-5, atol=1e-5)
    # the port writes, JAX reads
    own = learned.init_params(3, "cpu")
    learned.save_checkpoint(tmp_path / "port_ckpt.npz", own)
    jp = jlearned.load_checkpoint(str(tmp_path / "port_ckpt.npz"))
    np.testing.assert_allclose(np.asarray(jlearned.apply(jp, *j)),
                               learned.apply(own, *t).numpy(), rtol=1e-5, atol=1e-5)
    with np.load(tmp_path / "port_ckpt.npz") as z:
        assert sorted(z.files) == sorted(jparams)
        assert all(z[k].shape == jparams[k].shape and z[k].dtype == np.float32 for k in z.files)


def test_training_reduces_loss_and_beats_noisy(tmp_path):
    """tests/test_denoiser.py:32-59 on the port, from its own initialization."""
    params, losses = learned.train(_synthetic_pairs(), steps=150, lr=3e-3, seed=0, device="cpu")
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    (test,) = _synthetic_pairs(n=1, seed=99)
    t = [torch.from_numpy(test[k]) for k in ("rgb", "albedo", "normal")]
    out = learned.apply(params, *t).numpy()
    mse_out = float(np.mean((out - test["clean"]) ** 2))
    mse_in = float(np.mean((test["rgb"] - test["clean"]) ** 2))
    assert mse_out < mse_in, (mse_out, mse_in)
    ck = tmp_path / "denoiser.npz"
    learned.save_checkpoint(ck, params)
    out2 = learned.apply(learned.load_checkpoint(ck, device="cpu"), *t).numpy()
    np.testing.assert_array_equal(out, out2)


def test_apply_shapes_and_hdr_safety():
    """tests/test_denoiser.py:62-73 on the port."""
    params = learned.init_params(0, "cpu")
    rgb = torch.full((16, 16, 3), 50.0)
    alb = torch.full((16, 16, 3), 0.5)
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(16, 16, 3)
    out = learned.apply(params, rgb, alb, nrm)
    assert out.shape == (16, 16, 3)
    assert torch.isfinite(out).all() and (out >= 0).all()
    assert learned.apply(params, rgb[None], alb[None], nrm[None]).shape == (1, 16, 16, 3)
