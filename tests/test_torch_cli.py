"""The port's `render` CLI on the CPU, its refusal to fall back from CUDA, and
that the port runs without importing JAX."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml
from optix_renderer_tpu_torch.utils.imageio import read_exr

REPO = Path(__file__).resolve().parents[1]


def test_render_cpu_writes_exr_and_png(tmp_path):
    xml = cornell_box_xml(tmp_path, width=16, height=12, spp=2)
    rc = cli.main(["render", str(xml), "--device", "cpu", "--spp", "2", "--size", "12x8",
                   "--depth", "3", "--integrator", "path_mats", "-o", str(tmp_path / "out")])
    assert rc == 0
    img = read_exr(tmp_path / "out.exr")
    assert img.shape == (8, 12, 3) and np.isfinite(img).all() and img.mean() > 0
    png = (tmp_path / "out.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (12, 8)  # IHDR width, height


def test_render_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xml = cornell_box_xml(tmp_path, width=8, height=6, spp=1)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["render", str(xml), "--device", "cuda"])
    assert not (tmp_path / "cbox.exr").exists()


def test_cpu_render_does_not_import_jax(tmp_path):
    """The path kernel's plain version and the scan path over the LBVH
    (a 300-triangle scene) render without JAX."""
    code = (
        "import dataclasses, sys\n"
        "from optix_renderer_tpu_torch.scene.presets import make_cornell_box\n"
        "from optix_renderer_tpu_torch.scene.presets import make_tessellated_cornell\n"
        "from optix_renderer_tpu_torch.render.render import render\n"
        "s, c, _ = make_cornell_box(8, 6, 1)\n"
        "out = render(s, c, sample_count=1, device='cpu')\n"
        "assert out['composite'].shape == (6, 8, 3)\n"
        "s, c, _ = make_tessellated_cornell(8, 6, 1, nu=12, nv=7)\n"
        "assert c.n_tris == 300 and s.geometry.bvh is not None\n"
        "out = render(s, dataclasses.replace(c, max_depth=3), sample_count=1, device='cpu')\n"
        "assert out['composite'].shape == (6, 8, 3) and (out['weights'] > 0).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'optix_renderer_tpu.')))\n"
        "assert 'optix_renderer_tpu' not in sys.modules and not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
