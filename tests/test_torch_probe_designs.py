"""The Hopper designs of the two probe kernels (`csrc/probes.cu`), written
as plain torch, against the probes' plain versions on the CPU.

* `probe_copy_tiled`: per (64-column tile, flagged slab) partial sums, then
  each tile's partials in c order, as the kernel's clusters add them. It
  must equal `probe_copy_ref` bit for bit (`torch.equal`): the kernel is
  gated at max error 0 on the card. Against the probe's numpy reference
  (`tools/probe_mosaic.py:69-74`) and the torch yardstick, which add in
  other orders, the tolerance is 1e-6 of the largest sum.
* `iter_cost_design`: the group max of `reduce` per CTA, then across the
  cluster's CTAs, and the one-test `isect` body, bit for bit against
  `iter_cost_ref` at NB = 2 and 64 iterations, on the probe's degenerate
  table and on a table that hits; `lane_map`, the lane each thread of each
  CTA serves, covers every lane once.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.tools import probe_copy, prof_parts


def _probe_copy_inputs(kind):
    if kind == "probe":
        return probe_copy.make_inputs()
    r = np.random.default_rng(8)
    x = r.normal(0.0, 1.0, (probe_copy.C, probe_copy.CS, probe_copy.W)).astype(np.float32)
    sel = r.permutation(probe_copy.C).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(sel)


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_probe_copy_tiled_equals_plain_version_bit_for_bit(kind):
    x, sel = _probe_copy_inputs(kind)
    got = probe_copy.probe_copy_tiled(x, sel)
    assert got.shape == (probe_copy.OUT_ROWS, probe_copy.W)
    assert torch.equal(got, probe_copy.probe_copy_ref(x, sel))
    ref = probe_copy.reference_np(x.numpy(), sel.numpy())
    for row in got.numpy():
        np.testing.assert_allclose(row, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the torch yardstick computes the same sum in another order
    np.testing.assert_allclose(probe_copy.torch_yardstick(x, sel).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_probe_copy_grid_covers_every_tile_and_flagged_slab():
    flagged = sum(probe_copy.flags())
    assert flagged == probe_copy.OUT_ROWS  # rank k of a cluster writes output row k
    assert probe_copy.CTAS == probe_copy.W // probe_copy.TILE_COLS * flagged == 128


def test_lane_map_covers_every_lane_once_and_keeps_groups_in_clusters():
    nb = 2
    m = prof_parts.lane_map(nb)
    assert m.shape == (nb * prof_parts.CTAS, prof_parts.THREADS)
    written = torch.full((nb * prof_parts.LANES,), -1, dtype=torch.int64)
    written[m.reshape(-1)] = m.reshape(-1)
    assert torch.equal(written, torch.arange(nb * prof_parts.LANES))
    cta = torch.arange(nb * prof_parts.CTAS)
    assert torch.equal(m // prof_parts.LANES, (cta // prof_parts.CTAS)[:, None].expand_as(m))
    # rank q of a cluster serves lanes [q · 1024, (q + 1) · 1024) of its group
    assert torch.equal(m[:, 0] % prof_parts.LANES, (cta % prof_parts.CTAS) * prof_parts.THREADS)


def test_reduce_split_over_cluster_equals_plain_version_bit_for_bit():
    x, tri = prof_parts.make_inputs(nb=2)
    # lanes that differ, so that the max is not the same everywhere
    x = x + torch.from_numpy(np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32))
    got = prof_parts.iter_cost_design(x, tri, 64, "reduce")
    ref = prof_parts.iter_cost_ref(x, tri, 64, "reduce")
    assert torch.equal(got, ref)
    acc = x[:, 0].reshape(2, -1)
    assert torch.equal(prof_parts._group_max_clustered(acc), acc.amax(dim=1, keepdim=True))


def _isect_table(kind):
    # tests/test_torch_probes.py: _isect_table
    if kind == "probe":
        return np.full((16, 48), 0.3, np.float32)
    r = np.random.default_rng(4)
    tri = np.zeros((16, 48), np.float32)
    tri[:, 0:3] = np.array([0.3, 1.5, 1.2]) + r.normal(0, 0.2, (16, 3))
    tri[:, 3:9] = r.normal(0, 0.6, (16, 6))
    tri[:, 26] = r.random(16)
    return tri


@pytest.mark.parametrize("kind", ["probe", "hits"])
def test_isect_one_test_body_equals_plain_version_bit_for_bit(kind):
    tri = torch.from_numpy(_isect_table(kind))
    x, _ = prof_parts.make_inputs(nb=2)
    got = prof_parts.iter_cost_design(x, tri, 64, "isect")
    ref = prof_parts.iter_cost_ref(x, tri, 64, "isect")
    assert got.shape == (8, 2, 8, 512)
    assert torch.equal(got, ref)
    # the hits table hits on some lane-iteration, and its hits change acc
    acc = x[:, 0].reshape(-1) * 0.0
    step = prof_parts._isect_step_one_test(acc, tri)
    assert bool((step != acc + 1e9 * 1e-12).any()) == (kind == "hits")


def test_other_modes_keep_the_plain_version():
    x, tri = prof_parts.make_inputs(nb=2)
    for mode in ("empty", "madd100"):
        assert torch.equal(prof_parts.iter_cost_design(x, tri, 5, mode),
                           prof_parts.iter_cost_ref(x, tri, 5, mode))
    r = prof_parts.marginals({64: 1.0, 1024: 1.96})
    assert r["us_per_iter"] == pytest.approx(1.0)
    assert r["ns_per_lane_iter"] == pytest.approx(1e3 / (prof_parts.NB * prof_parts.LANES))


def test_isect_issue_limit_counts_every_lane_triangle():
    # 70 instructions per lane-triangle, 14 triangles, 131,072 lanes, 64
    # iterations: 2.57e8 warp instructions at 4 per clock on 132 SMs at
    # 1,980 MHz
    warp_instructions = 70 * 14 * 64 * 32 * 4096 / 32
    assert prof_parts.issue_limit_ms(70, 64) == pytest.approx(
        warp_instructions / (132 * 4 * 1.98e9) * 1e3, rel=1e-12)
    assert prof_parts.issue_limit_ms(70, 1024) == pytest.approx(
        16 * prof_parts.issue_limit_ms(70, 64), rel=1e-12)
    assert prof_parts.isect_per_pair("") is None  # no cuobjdump output, no figure
