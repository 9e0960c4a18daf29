"""The port's multi-process rendering (`parallel/multihost.py`,
`parallel/mh_worker.py`) on the CPU: two processes × 2 CPU entries on gloo
form one (4, 1) mesh, as tests/test_multihost.py rehearses the JAX
package with two processes × 4 virtual devices.

* the film equals a one-process `render()` of the scan path within 1e-5
  (rtol and atol, tests/test_multihost.py:113: the same sample streams,
  only the all-reduce's order differs);
* `render_sharded`'s kernel path over the two ranks' pixel ranges equals a
  one-process `render()` bit for bit (the ranges are disjoint, so the
  all-reduce adds zeros);
* the distributed train step's loss and gradients equal one-process
  `train_step` on the whole image (loss rel 1e-5, gradients atol 1e-6);
* the scaling JSON has the JAX harness's keys and a sane ratio;
* `render --distributed` through the CLI: two ranks, only rank 0 writes
  the image and the checkpoint;
* `render_multihost` in one process equals `render_sharded`'s scan path.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.parallel import multihost, shard
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml, make_cornell_box
from optix_renderer_tpu_torch.utils.imageio import read_exr

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX harness's keys (optix_renderer_tpu/parallel/multihost.py:244-255)
SCALING_KEYS = {"n_devices", "n_processes", "paths_per_s_1dev", "paths_per_s_full",
                "scaling_efficiency", "config"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(args_of, timeout=300) -> list[str]:
    """Start two processes (`args_of(rank, port)`), wait for both; their logs."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, *args_of(i, port)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i][-4000:]}"
    return logs


@pytest.fixture(scope="module")
def mh_result(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh") / "mh.npz")
    logs = _two_ranks(lambda i, port: [
        "-m", "optix_renderer_tpu_torch.parallel.mh_worker", "--coordinator",
        f"localhost:{port}", "--num-processes", "2", "--process-id", str(i),
        "--local-devices", "2", "--device", "cpu", "--backend", "gloo", "--out", out,
        "--scaling"])
    assert all("backend=gloo" in log for log in logs)
    return out


def _cornell():
    scene, cfg, _ = make_cornell_box(width=16, height=12, spp=4, integrator="path_mis",
                                     device="cpu")
    return scene, dataclasses.replace(cfg, max_depth=3)


def test_two_process_render_matches_single_process(mh_result):
    with np.load(mh_result) as z:
        assert int(z["n_processes"]) == 2 and int(z["n_devices"]) == 4
        assert bool(z["grad_finite"]) and np.isfinite(float(z["loss"]))
        comp = z["composite"]
    scene, cfg = _cornell()
    ref = render(scene, cfg, sample_count=4, device="cpu", mega=False)["composite"]
    assert comp.shape == ref.shape == (12, 16, 3)
    np.testing.assert_allclose(comp, ref, rtol=1e-5, atol=1e-5)


def test_two_process_kernel_path_matches_render(mh_result):
    scene, cfg = _cornell()
    ref = render(scene, cfg, sample_count=4, device="cpu")
    with np.load(mh_result) as z:
        for k in ("composite", "albedo", "normal", "weights"):
            np.testing.assert_array_equal(z[f"kernel_{k}"], ref[k], err_msg=k)
    assert ref["composite"].mean() > 0


def test_two_process_train_step_matches_train_step(mh_result):
    scene, cfg = _cornell()
    loss, grads = shard.train_step(scene, cfg, torch.zeros((12, 16, 3)), torch.arange(16 * 12),
                                   0, device="cpu")
    with np.load(mh_result) as z:
        assert float(z["loss"]) == pytest.approx(float(loss), rel=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(z[f"grad_{k}"], g.numpy(), rtol=0, atol=1e-6, err_msg=k)
        assert np.abs(z["grad_em_radiance"]).sum() > 0


def test_scaling_harness_output(mh_result):
    with open(mh_result + ".scaling.json") as f:
        s = json.load(f)
    assert set(s) == SCALING_KEYS
    assert s["n_devices"] == 4 and s["n_processes"] == 2
    assert s["paths_per_s_full"] > 0 and s["paths_per_s_1dev"] > 0
    # efficiency on CPU entries that share cores is no perf number: a sane ratio
    assert 0.0 < s["scaling_efficiency"] < 4.0
    assert s["config"] == {"width": 16, "height": 12, "spp": 4, "integrator": "path_mis"}


def test_cli_distributed_writes_on_rank_zero_only(tmp_path):
    xml = cornell_box_xml(tmp_path, 16, 12, 2, "path_mis")
    logs = _two_ranks(lambda i, port: [
        "-m", "optix_renderer_tpu_torch", "render", str(xml), "--device", "cpu",
        "--distributed", "--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", str(i), "--local-devices", "2", "--backend", "gloo", "--depth", "3",
        "-o", str(tmp_path / f"out{i}"), "--checkpoint", str(tmp_path / f"ck{i}")])
    assert (tmp_path / "out0.exr").exists() and not (tmp_path / "out1.exr").exists()
    assert list(tmp_path.glob("ck0*")) and not list(tmp_path.glob("ck1*"))
    assert "Done" in logs[0] and "Done" not in logs[1]
    img = read_exr(tmp_path / "out0.exr")
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()


def test_render_multihost_in_one_process_equals_render_sharded():
    scene, cfg = _cornell()
    cpu = torch.device("cpu")
    mesh = multihost.make_multihost_mesh(devices=[cpu] * 4)
    assert mesh.shape == (2, 2) and mesh.world == 1 and mesh.tile0 == 0
    a = multihost.render_multihost(scene, cfg, mesh, sample_count=3)
    b = shard.render_sharded(scene, cfg, mesh, sample_count=3, mega=False)
    assert a["spp_done"] == b["spp_done"] == 4
    for k in ("composite", "albedo", "normal", "weights"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
