"""Properties of the path kernel's small branch (≤ 64 triangles) that its
CUDA design rests on, held on the plain version (`pathk_trace_ref`, what
`pathk_trace` runs on the CPU), on the 24×16 Cornell box.

`csrc/pathk.cu: pathk_kernel<MIS>` keeps every lane busy: a lane whose
pixel is done takes the next pixel from a counter, so any lane runs any
pixel, in any order. That is right only because a pixel's rows depend on
its own index alone, which the first test holds bit for bit. A sweep that
tests several triangle rows at a time has to pad the rows with zero rows,
which must never hit; the second test holds that bit for bit as well. The
third checks the lane-efficiency helpers of `tools/time_pathk.py` on small
arrays worked out by hand.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.tools.time_pathk import (
    lane_efficiency,
    refill_efficiency,
    tile_order,
)


def _cornell(integrator, seed, depth=8, rfilter="gaussian"):
    scene, cfg, _ = presets.make_cornell_box(24, 16, 1, integrator, device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=depth, rfilter=rfilter, seed=seed)
    tables, meta = pathk.build_pathk_tables(scene, cfg)
    return tables, meta, cfg


@pytest.mark.parametrize("integrator", ["path_mis", "path_mats"])
def test_pixels_are_independent(integrator):
    """The rows of pixels [0, M) do not depend on how many pixels the call
    traces: bit-equal to the first M columns of a call over all N."""
    rng = np.random.default_rng(11)
    tables, meta, cfg = _cornell(integrator, seed=int(rng.integers(0, 2**31 - 1)))
    n = cfg.width * cfg.height
    m = int(rng.integers(n // 4, n - 1))
    full = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n, spp0=3, n_spp=2)
    part = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=m, spp0=3, n_spp=2)
    assert part.shape == (16, m) and bool((full[3] == 2.0).all())
    assert torch.equal(part, full[:, :m])


def _zeroed(tables, meta, t_cnt, rows):
    """The tables with the triangle rows [t_cnt, rows) zero, at t_cnt = rows."""
    tri = torch.zeros((rows, pathk.TR_COLS), dtype=torch.float32)
    tri[:t_cnt] = tables["tri"][:t_cnt]
    return dict(tables, tri=tri), dict(meta, t_cnt=rows)


@pytest.mark.parametrize("t_cnt,rows", [(12, 16), (11, 12)], ids=["pad_12_to_16", "zero_row_11"])
def test_zero_rows_leave_the_rows_unchanged(t_cnt, rows):
    """Zero rows past t_cnt never hit (det = 0): the Cornell tables padded
    from 12 to 16 rows, and at t_cnt 11 against the same tables with row 11
    zeroed at t_cnt 12, give bit-equal rows."""
    rng = np.random.default_rng(12)
    tables, meta, cfg = _cornell("path_mis", seed=int(rng.integers(0, 2**31 - 1)))
    assert meta["t_cnt"] == 12
    n = cfg.width * cfg.height
    ref = pathk.pathk_trace_ref(tables, dict(meta, t_cnt=t_cnt), cfg, n_pix=n, spp0=0, n_spp=2)
    got = pathk.pathk_trace_ref(*_zeroed(tables, meta, t_cnt, rows), cfg, n_pix=n, spp0=0,
                                n_spp=2)
    assert torch.equal(got, ref)
    if t_cnt < 12:  # triangle 11 takes part in the film: leaving it out changes rows
        assert not torch.equal(ref, pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n, spp0=0,
                                                          n_spp=2))


def test_lane_efficiency_on_a_hand_made_array():
    it = np.array([4, 1, 1, 1, 3, 2])  # 12 iterations in all
    # fixed groups of 2: maxima 4, 1, 3 -> 2 * 8 lane-iterations
    assert lane_efficiency(it, 2) == pytest.approx(12 / 16)
    # groups of 4, the last filled with two idle lanes: maxima 4, 3
    assert lane_efficiency(it, 4) == pytest.approx(12 / 28)
    assert lane_efficiency(np.full(64, 5), 32) == 1.0
    # a 2x4 image in 2x2 tiles: rows (1 2 3 4), (5 6 7 8) -> 1 2 5 6 | 3 4 7 8;
    # tiles of maxima 6 and 8, against rows of 4 with maxima 4 and 8
    img = np.arange(1, 9)
    np.testing.assert_array_equal(tile_order(img, 4, 2, 2), [1, 2, 5, 6, 3, 4, 7, 8])
    assert lane_efficiency(tile_order(img, 4, 2, 2), 4) == pytest.approx(36 / 56)
    assert lane_efficiency(img, 4) == pytest.approx(36 / 48)
    # one warp of 2 lanes that refill: lane 0 runs pixels 0 (to pass 4) and
    # 5 (to 6); lane 1 runs 1, 2, 3 and 4 (to 6): 6 passes, no idle lane
    assert refill_efficiency(it, n_warps=1, warp=2) == pytest.approx(1.0)
    # the same lanes as two warps of one lane: 6 + 6 passes
    assert refill_efficiency(it, n_warps=2, warp=1) == pytest.approx(1.0)
    # one warp of 4 lanes: lanes 0-3 take pixels 0-3; lanes 1 and 2 then
    # take pixels 4 and 5 (to passes 4 and 3); lane 0 ends at 4: 4 passes
    assert refill_efficiency(it, n_warps=1, warp=4) == pytest.approx(12 / 16)
    # two warps of 2 lanes: warp 0 runs pixels 0 (to 4) and 1, 4 (to 4);
    # warp 1 runs 2, 5 (to 3) and 3 (to 1): 4 + 3 passes of 2 lanes
    assert refill_efficiency(it, n_warps=2, warp=2) == pytest.approx(12 / 14)
