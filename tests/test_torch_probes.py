"""The probe entry points of the port (`optix_renderer_tpu_torch/tools/`):
their plain torch versions, which are what runs on the CPU, against the
probes' own references.

* `probe_copy` against `tools/probe_mosaic.py:69-74`'s numpy reference,
  written out here: that script runs a Pallas kernel when it is imported;
* `iter_cost`'s `isect` mode against JAX `pathk._isect_vpu` on jnp arrays,
  outside Pallas, step by step;
* `empty`, `reduce` and `madd100` against the same loops in numpy float32.

The plain versions add in the kernels' order, so the tolerance is 1e-6
relative (the kernels are compared with them on the card by chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.pallas import pathk as jpathk
from optix_renderer_tpu_torch.tools import probe_copy, prof_parts
from optix_renderer_tpu_torch.utils import tracing


def test_probe_copy_plain_matches_probe_reference():
    x, sel = probe_copy.make_inputs()
    out = probe_copy.probe_copy(x, sel).numpy()
    assert out.shape == (8, 1024) and tracing.counter("launch.probe_copy") == 0
    xn, seln = x.numpy(), sel.numpy()
    np.testing.assert_array_equal(seln, np.arange(16)[::-1])
    ref = np.zeros(1024, np.float32)
    for c in range(16):  # tools/probe_mosaic.py:69-74
        if c % 2 == 1:
            ref += xn[16 - 1 - c].sum(axis=0)
    for row in out:
        np.testing.assert_allclose(row, ref, rtol=1e-6, atol=0)
    assert probe_copy.reference_np(xn, seln).tolist() == ref.tolist()


def _isect_table(kind):
    if kind == "probe":  # prof_parts2.py:51: degenerate triangles, no hit
        return np.full((16, 48), 0.3, np.float32)
    r = np.random.default_rng(4)
    tri = np.zeros((16, 48), np.float32)
    tri[:, 0:3] = np.array([0.3, 1.5, 1.2]) + r.normal(0, 0.2, (16, 3))  # near the ray at t=1
    tri[:, 3:9] = r.normal(0, 0.6, (16, 6))
    tri[:, 26] = r.random(16)
    return tri


@pytest.mark.parametrize("kind", ["probe", "hits"])
def test_iter_cost_isect_matches_jax_isect_vpu(kind):
    tri = _isect_table(kind)
    x, _ = prof_parts.make_inputs(nb=1)
    acc = np.zeros((8, 512), np.float32)  # x[0, 0] * 0
    hits = 0
    for n_it in range(1, 4):
        a = jnp.asarray(acc)
        zero = a * 0
        o = (a, a + 1, a + 2)
        d = (zero + 0.3, zero + 0.5, zero - 0.8)
        t, _, _, hit, A, occ = jpathk._isect_vpu(jnp.asarray(tri), 14, o, d, zero, zero + 1e9,
                                                 o, d, zero + 5.0)
        hits += int(np.asarray(hit).sum())
        acc = (acc + np.asarray(t) * np.float32(1e-12) + np.asarray(A["kdr"]) * np.float32(1e-12)
               + np.where(np.asarray(occ), np.float32(1e-12), np.float32(0.0)))
        got = prof_parts.iter_cost(x, torch.from_numpy(tri), n_it, "isect").numpy()
        assert got.shape == (8, 1, 8, 512)
        for row in got:
            np.testing.assert_allclose(row[0], acc, rtol=1e-6, atol=0)
    assert (hits > 0) == (kind == "hits")


def test_iter_cost_loops_match_numpy():
    x, tri = prof_parts.make_inputs(nb=2)
    f32 = np.float32
    for mode in ("empty", "reduce", "madd100"):
        acc = np.zeros((2, 4096), f32)
        for _ in range(5):
            if mode == "empty":
                acc = acc + f32(1.0)
            elif mode == "reduce":
                acc = acc + acc.max(axis=1, keepdims=True) * f32(1e-12) + f32(1.0)
            else:
                y = acc
                for _ in range(100):
                    y = y * f32(1.000001) + f32(0.5)
                acc = acc + y * f32(1e-12)
        got = prof_parts.iter_cost(x, tri, 5, mode).numpy()
        assert got.shape == (8, 2, 8, 512)
        np.testing.assert_allclose(got.reshape(8, 2, 4096),
                                   np.broadcast_to(acc, (8, 2, 4096)), rtol=1e-6, atol=0,
                                   err_msg=mode)
    assert tracing.counter("launch.iter_cost") == 0


def test_probe_wrappers_refuse_other_devices_and_entry_points_need_a_gpu(monkeypatch):
    x, sel = probe_copy.make_inputs("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe_copy.probe_copy(x, sel)
    x, tri = prof_parts.make_inputs("meta", nb=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        prof_parts.iter_cost(x, tri, 1, "empty")
    with pytest.raises(ValueError, match="unknown mode"):
        prof_parts.iter_cost_ref(*prof_parts.make_inputs(nb=1), 1, "nop")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (probe_copy, prof_parts):
        with pytest.raises(SystemExit, match="needs a CUDA GPU"):
            tool.main()
