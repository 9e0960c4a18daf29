"""The spans and counters of the path kernel's medium branch (65–8,192
triangles) in traced CPU renders: `pack.walk_tables`, the LBVH's fetch,
check and pack inside `dispatch.pack`, and the counters `pathk.iterations`
(Σ of each launch's row 10, the pixels' loop iterations) and
`pathk.samples` (pixels × samples of each launch), which count in traced
requests only."""

import dataclasses

import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell
from optix_renderer_tpu_torch.utils import tracing

COUNTERS = ("pathk.iterations", "pathk.samples")
SPP = 3


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts with tracing off and no records, and leaves it so."""
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


@pytest.fixture(scope="module")
def medium_box():
    """The tessellated Cornell box at nu=12, nv=7: 300 triangles, the medium
    branch with the scene's own LBVH."""
    scene, cfg, _ = make_tessellated_cornell(8, 6, SPP, "path_mis", nu=12, nv=7, device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=4, seed=11)
    assert cfg.n_tris == 300 > pathk.VPU_MAX_TRIS
    return scene, cfg


def _counts():
    return {k: tracing.counter(k) for k in COUNTERS}


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_a_traced_medium_render_records_walk_tables_under_the_packing(medium_box):
    scene, cfg = medium_box
    tracing.enable()
    for _ in range(2):
        render(scene, cfg, sample_count=SPP, device="cpu")
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    walks = _by_name(recs, "pack.walk_tables")
    assert len(walks) == 2 and len({r.request for r in walks}) == 2
    assert all(by_id[r.parent].name == "dispatch.pack" for r in walks)
    for w in walks:
        pack = by_id[w.parent]
        assert pack.start_ns <= w.start_ns <= w.end_ns <= pack.end_ns


def test_the_counters_hold_the_plain_versions_iterations_and_samples(medium_box):
    scene, cfg = medium_box
    before = _counts()
    tracing.enable()
    render(scene, cfg, sample_count=SPP, device="cpu")
    tables, meta = pathk.build_pathk_tables(scene, cfg)
    n_pix = cfg.width * cfg.height
    rows = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=SPP)
    iterations = int(rows[10].double().sum())
    assert iterations > n_pix * SPP  # at least one segment a sample, and then some
    got = {k: v - before[k] for k, v in _counts().items()}
    assert got == {"pathk.iterations": iterations, "pathk.samples": n_pix * SPP}


def test_an_untraced_render_moves_no_counter_and_casts_no_row(medium_box, monkeypatch):
    scene, cfg = medium_box
    seen = []
    real = tracing.count_device

    def spy(name, mask):
        seen.append(name)
        real(name, mask)

    monkeypatch.setattr(tracing, "count_device", spy)
    before = _counts()
    render(scene, cfg, sample_count=SPP, device="cpu")
    assert seen == [] and _counts() == before
    assert _by_name(tracing.records(), "pack.walk_tables") == []


def test_a_small_branch_render_records_no_walk_tables_but_counts():
    scene, cfg, _ = make_cornell_box(8, 6, 2, "path_mis", device="cpu")
    cfg = dataclasses.replace(cfg, max_depth=3)
    before = _counts()
    tracing.enable()
    render(scene, cfg, sample_count=2, device="cpu")
    recs = tracing.records()
    assert _by_name(recs, "dispatch.pack") and not _by_name(recs, "pack.walk_tables")
    assert tracing.counter("pathk.samples") - before["pathk.samples"] == 8 * 6 * 2
    assert tracing.counter("pathk.iterations") - before["pathk.iterations"] >= 8 * 6 * 2
