"""The plain reference against the path kernel's medium branch, and the control.

    python -m pytest benchmarks/tests/test_bench_medium.py

Config M's published geometry (`tess-cornell-8k`: 8,012 triangles, so the
medium branch runs, walking the scene's own LBVH) rendered at 12 × 9 pixels,
4 spp, depth 16, gaussian, through the program's `render(…, device="cpu")`,
which runs the medium branch's plain version (`ops/cuda/pathk.py:
pathk_trace_ref`, held bit for bit against the kernel on the card by
chip_smoke.py phase 11).

The medium branch picks NEE's emissive triangle otherwise than the small
branch, whose pick the reference's `pathk` estimator copies: it scans the
whole padded `et` table, falls back to its last row, and has no `found`
term. This scene has one two-triangle light, whose area CDF ends at 1.0,
above every uniform, and its padded rows name no emitter (−1): the first
qualifying row is a real one on every lane, the fallback never runs, and
the two picks agree, so the configuration takes the reference as it is.
The first test decides that: every pixel of two seeds agrees. The control,
the reference computed in bfloat16, is off on far more pixels than the
cell's limit allows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from harness import check, manifest

torch.set_num_threads(1)

WORKLOAD = "tess8k-offline-64spp"
SIZE = {"width": 12, "height": 9}
SPP = 4


@pytest.fixture(scope="module")
def medium(tmp_path_factory):
    from optix_renderer_tpu_torch.ops.cuda import pathk
    from optix_renderer_tpu_torch.scene.build import load_scene

    cell = manifest.load_cell(WORKLOAD)
    cfg = dict(cell.config, scene=dict(cell.config["scene"], **SIZE))
    xml = manifest.resolve(cfg["writer"])(tmp_path_factory.mktemp("tess8k"), **cfg["scene"])
    scene, rcfg, _ = load_scene(xml, device="cpu")
    rcfg = dataclasses.replace(rcfg, max_depth=cfg["max_depth"])
    assert rcfg.n_tris == cfg["work"]["triangles"] > pathk.VPU_MAX_TRIS
    assert scene.geometry.bvh is not None  # the scene's own LBVH, not one the packing builds
    return cell, cfg, xml, scene, rcfg


def _film(medium, seed):
    from optix_renderer_tpu_torch.render.render import render

    cell, cfg, xml, scene, rcfg = medium
    return render(scene, dataclasses.replace(rcfg, seed=seed), sample_count=SPP, device="cpu")


@pytest.mark.parametrize("seed", [2**31 - 77, 1_234_567])
def test_reference_matches_the_medium_branch_on_every_pixel(medium, seed):
    cell, cfg, xml, _, _ = medium
    film = _film(medium, seed)
    pix = np.arange(SIZE["width"] * SIZE["height"])
    ref = check.reference_of(cfg)(xml, pix, SPP, seed)
    err = check.pixel_errors(film, ref, pix, cell.check["floor"])
    assert (err > cell.check["rel"]).mean() == 0.0, err.max()
    assert film["composite"].mean() > 0 and (film["weights"] == SPP).all()


def test_the_bfloat16_control_fails_the_cells_limit(medium):
    cell, cfg, xml, _, _ = medium
    film = _film(medium, 4242)
    pix = np.arange(SIZE["width"] * SIZE["height"])
    ref = check.reference_of(cfg)(xml, pix, SPP, 4242, dtype=torch.bfloat16)
    share = (check.pixel_errors(film, ref, pix, cell.check["floor"]) > cell.check["rel"]).mean()
    assert share > 3 * cell.check["limits"]["pixels_off"], share
