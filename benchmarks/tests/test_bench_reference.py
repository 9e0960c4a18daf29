"""The plain reference against the renderer's own CPU paths, and the control.

On the CPU the renderer runs its kernels' plain versions, whose arithmetic
the reference copies: every sampled pixel agrees to the rounding of the
sums. The control, the reference computed in bfloat16, is off on far more
pixels than any cell's limit allows.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from harness import check, manifest
from reference import pathtrace

torch.set_num_threads(1)

SMALL = {
    "cbox-offline-512spp": ({"width": 24, "height": 18}, 16),
    "cbox-live-16spp": ({"width": 24, "height": 18}, 16),
    "tess100k-scan-4spp": ({"width": 12, "height": 9, "nu": 80, "nv": 60}, 1),
}


def _films(workload, tmp_path, seed):
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.build import load_scene

    cell = manifest.load_cell(workload)
    scene_over, spp = SMALL[workload]
    cfg = dict(cell.config, scene=dict(cell.config["scene"], **scene_over))
    xml = manifest.resolve(cfg["writer"])(tmp_path, **cfg["scene"])
    scene, rcfg, _ = load_scene(xml, device="cpu")
    rcfg = dataclasses.replace(rcfg, max_depth=cfg["max_depth"], seed=seed)
    film = render(scene, rcfg, sample_count=spp, device="cpu")
    pix = np.arange(cfg["scene"]["width"] * cfg["scene"]["height"])
    return cell, cfg, xml, film, pix, spp


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_matches_the_renderers_cpu_path(workload, tmp_path):
    cell, cfg, xml, film, pix, spp = _films(workload, tmp_path, seed=2**31 - 77)
    ref = check.reference_of(cfg)(xml, pix, spp, 2**31 - 77)
    err = check.pixel_errors(film, ref, pix, cell.check["floor"])
    assert (err > cell.check["rel"]).mean() == 0.0, err.max()


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_bfloat16_control_fails_the_cells_limit(workload, tmp_path):
    cell, cfg, xml, film, pix, spp = _films(workload, tmp_path, seed=4242)
    pix = pix[:64]
    ref = check.reference_of(cfg)(xml, pix, spp, 4242, dtype=torch.bfloat16)
    share = (check.pixel_errors(film, ref, pix, cell.check["floor"]) > cell.check["rel"]).mean()
    assert share > 3 * cell.check["limits"]["pixels_off"], share


def test_obj_reading_splits_quads_as_the_loader_does(tmp_path):
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    tris = pathtrace._read_obj(tmp_path / "q.obj")
    assert tris.shape == (2, 3, 3)
    assert tris[1].tolist() == [[0, 1, 0], [0, 0, 0], [1, 1, 0]]


def test_segments_per_path_is_derived_from_the_reference():
    cfg = json.loads((manifest.ROOT / "benchmarks/configs/cbox-path-mis.json").read_text())
    assert 2.5 < cfg["work"]["segments_per_path"] < 4.0
