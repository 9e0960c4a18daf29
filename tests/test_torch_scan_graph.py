"""The scan path's captured round (`render/scan_graph.py`).

On the CPU: the sample scalar draws the int path's streams, a round fed the
scalar, seed 0 and the host-inverted camera matrix gives the eager round's
layers bit for bit, the cache key and the rule that picks the graph, and the
tracer's counting of a capture and its replays.

On a card (`-m card`; they skip without one), on config A (the 100,012-
triangle tessellated Cornell box) at 160×120 and on the 12-triangle Cornell
box with `mega=False`, for path_mis and path_mats: replayed layers equal
eager bit for bit, films, previews, checkpoint and resume, the counters, and
one capture per scene. This file imports no JAX, so the card tests run
without the tests' conftest:

    python -m pytest tests/test_torch_scan_graph.py -m card --noconftest -p no:cacheprovider
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.core.rng import M32
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.render import render as render_mod
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render import scan_graph
from optix_renderer_tpu_torch.render.render import _round_layers, render
from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell
from optix_renderer_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts with tracing off and no records, and leaves the
    tracer so, its counters as it found them (other files of the worker
    read them)."""
    tracing.enable(False)
    tracing.clear()
    saved = tracing.counters()
    yield
    tracing.enable(False)
    tracing.clear()
    tracing.reset_counters()
    for name, n in saved.items():
        tracing.count(name, n)


@pytest.fixture(scope="module")
def box():
    scene, cfg, _ = make_cornell_box(16, 12, 2, "path_mis", device="cpu")
    return scene, dataclasses.replace(cfg, max_depth=4)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("sample, seed", [
    (0, 0), (5, 3), (7, 2**31 - 1), (2**32 - 1, 2**31 - 2), (2**32, 12345),
    (2**32 + 9, 2**31 + 5), (3 * 2**32 + 77, 2**31 - 3 * 10**7), (123456789, 2147483000)])
def test_sample_scalar_draws_the_int_paths_streams(sample, seed):
    pix = torch.arange(-7, 3000, dtype=torch.int64)
    want = smp.make_sampler(pix, sample, seed=seed)
    scalar = torch.tensor(scan_graph.sample_scalar(sample, seed), dtype=torch.int64)
    assert 0 <= int(scalar) <= M32 and int(scalar) == (sample ^ seed) & M32
    got = smp.make_sampler(pix, scalar, seed=0)
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)
    for step in ("next_1d", "next_2d", "next_3d"):
        got, u = getattr(smp, step)(got)
        want, v = getattr(smp, step)(want)
        assert torch.equal(u, v)


@pytest.mark.parametrize("integrator", ["path_mis", "path_mats"])
def test_the_captured_rounds_inputs_give_the_eager_layers(box, integrator):
    """What the graph records, the round fed the scalar, seed 0 and the
    matrix inverted on the host, against the eager round, bit for bit."""
    scene, cfg = box
    cfg = dataclasses.replace(cfg, integrator=integrator)
    ids = torch.cat([torch.arange(192), torch.full((8,), -64)])
    s2c = camera_ops.sample_to_camera_matrix(scene.camera, cfg.width, cfg.height)
    for seed, sample in ((11, 0), (2**31 - 5, 3)):
        pos, layers = _round_layers(scene, dataclasses.replace(cfg, seed=seed), ids, sample)
        scalar = torch.tensor(scan_graph.sample_scalar(sample, seed))
        pos_g, layers_g = _round_layers(scene, dataclasses.replace(cfg, seed=0), ids, scalar, s2c)
        assert torch.equal(pos, pos_g) and torch.equal(layers, layers_g)


def _key(scene, cfg, device="cuda:0"):
    return scan_graph.cache_key(scene, cfg, device)


def test_the_cache_key_ignores_the_seed_and_the_sample_count(box):
    scene, cfg = box
    key = _key(scene, cfg)
    assert hash(key) == hash(_key(scene, cfg))
    for change in ({"seed": 2**31 - 1}, {"sample_count": 512}, {"seed": 7, "sample_count": 1}):
        assert _key(scene, dataclasses.replace(cfg, **change)) == key
    assert _key(dataclasses.replace(scene), cfg) == key  # new tables, the same tensors


@pytest.mark.parametrize("change", [
    {"width": 32}, {"height": 24}, {"integrator": "path_mats"}, {"max_depth": 5},
    {"rfilter": "mitchell"}, {"n_emitters": 2}, {"iprops": (("maxDepth", 3),)}])
def test_the_cache_key_follows_what_the_round_reads(box, change):
    scene, cfg = box
    assert _key(scene, dataclasses.replace(cfg, **change)) != _key(scene, cfg)


def test_the_cache_key_follows_the_scenes_tensors_and_the_device(box):
    scene, cfg = box
    key = _key(scene, cfg)
    fov = scene.camera.fov.clone()
    moved = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, fov=fov))
    assert _key(moved, cfg) != key  # a replaced tensor: another address
    edited = _key(moved, cfg)
    fov.add_(0.0)  # edited in place: its version moves
    assert _key(moved, cfg) != edited
    g = scene.geometry
    reshaped = dataclasses.replace(scene, geometry=dataclasses.replace(
        g, tri_shape=g.tri_shape.view(torch.int32)))  # the same storage, another tensor
    assert _key(reshaped, cfg) == key
    assert _key(scene, cfg, "cuda:1") != key
    assert _key(scene, cfg, "cpu") != key


def test_the_rule_sends_only_cuda_path_rounds_without_grad_to_the_graph(box):
    scene, cfg = box
    for integ in sorted(scan_graph.GRAPH_INTEGRATORS):
        assert scan_graph.graphable(scene, dataclasses.replace(cfg, integrator=integ), "cuda")
        assert scan_graph.graphable(scene, dataclasses.replace(cfg, integrator=integ),
                                    torch.device("cuda", 1))
    assert scan_graph.GRAPH_INTEGRATORS == {"path_mis", "path_mats"}
    assert not scan_graph.graphable(scene, cfg, "cpu")
    for integ in ("direct_mis", "normals", "path_vol_mis", "photonmapper"):
        assert not scan_graph.graphable(scene, dataclasses.replace(cfg, integrator=integ), "cuda")
    kd = scene.bsdfs.kd.clone().requires_grad_(True)
    grad = dataclasses.replace(scene, bsdfs=dataclasses.replace(scene.bsdfs, kd=kd))
    assert not scan_graph.graphable(grad, cfg, "cuda")


def test_a_cpu_scan_step_renders_eagerly(box, monkeypatch):
    scene, cfg = box

    def refuse(*args):
        raise AssertionError("a CPU round reached the graph")

    monkeypatch.setattr(scan_graph, "graph_step", refuse)
    tracing.enable()
    before = tracing.counters("scan.")
    out = render(scene, cfg, sample_count=2, device="cpu", mega=False)
    assert out["spp_done"] == 2
    after = tracing.counters("scan.")
    assert after.get("scan.rounds", 0) - before.get("scan.rounds", 0) == 2
    assert after.get("scan.rounds_graphed", 0) == before.get("scan.rounds_graphed", 0)


def test_a_capture_keeps_its_counts_and_each_replay_counts_them(box):
    """The tracer's side of a capture, on the CPU: counts made while
    capturing go to the `Capture`, live lanes into its own buffer whatever
    the switch; each `replayed` counts its launches, and in a traced request
    its lanes, as the eager round would."""
    scene, cfg = box
    ids = torch.arange(192)
    tracing.enable()
    base = {k: tracing.counter(k) for k in ("scan.lanes", "scan.lanes_live", "launch.x")}
    with tracing.span("render"):  # an eager traced round: the reference counts
        _round_layers(scene, cfg, ids, 1)
    tracing.fold_device()
    eager = {k: tracing.counter(k) - base[k] for k in base}
    assert eager["scan.lanes"] == 4 * 192 and 0 < eager["scan.lanes_live"] < 4 * 192

    tracing.enable(False)
    cap = tracing.Capture()
    base = {k: tracing.counter(k) for k in base}
    with tracing.capturing(cap):
        tracing.count("launch.x", 3)
        _round_layers(scene, cfg, ids, 1)  # untraced, yet the lanes are counted
    assert {k: tracing.counter(k) for k in base} == base
    assert cap.counts == {"launch.x": 3} and cap.n_lanes == 4 * 192
    assert len(cap.lanes) == 4 and all(b.dtype == torch.int32 for b in cap.lanes)
    assert sum(int(b.sum()) for b in cap.lanes) == eager["scan.lanes_live"]

    tracing.replayed(cap)  # untraced: the launches alone
    assert tracing.counter("launch.x") - base["launch.x"] == 3
    assert tracing.counter("scan.lanes") == base["scan.lanes"]
    tracing.enable()
    with tracing.span("render"):
        tracing.replayed(cap)
        tracing.replayed(cap)
    for b in cap.lanes:  # the graph's next replay writes its buffers anew: the counts are copies
        b.zero_()
    tracing.fold_device()
    assert tracing.counter("launch.x") - base["launch.x"] == 9
    assert tracing.counter("scan.lanes") - base["scan.lanes"] == 2 * eager["scan.lanes"]
    assert tracing.counter("scan.lanes_live") - base["scan.lanes_live"] == \
        2 * eager["scan.lanes_live"]


def test_count_device_takes_int32_counts_as_a_copy():
    counts = torch.tensor([3, 0, 2], dtype=torch.int32)
    before = tracing.counter("test.counts")
    tracing.enable()
    with tracing.span("render"):
        tracing.count_device("test.counts", counts)
        counts.zero_()  # its owner writes it again: the tracer holds a copy
        tracing.count_device("test.counts", torch.tensor([1, 1, 0], dtype=torch.int32))
        for bad in (torch.ones(3), torch.ones(3, dtype=torch.int64)):
            with pytest.raises(ValueError, match="bool or int32"):
                tracing.count_device("test.counts", bad)
    tracing.fold_device()
    assert tracing.counter("test.counts") - before == 7


# ---------------------------------------------------------------- the card

INTEGRATORS = ["path_mis", "path_mats"]
SCENES = ["tess100k", "box12"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from optix_renderer_tpu_torch.ops.cuda import _build

    _build.load()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_scenes():
    """{name: (scene, config)} on the card, built once: config A at 160×120
    and the 12-triangle box at 64×48, depth 8."""
    dev = _card()
    a, cfg_a, _ = make_tessellated_cornell(160, 120, 4, "path_mis", device=dev)
    b, cfg_b, _ = make_cornell_box(64, 48, 4, "path_mis", device=dev)
    return {"tess100k": (a, dataclasses.replace(cfg_a, max_depth=8)),
            "box12": (b, dataclasses.replace(cfg_b, max_depth=8))}


def _setup(card_scenes, name, integrator, seed=1234):
    scene, cfg = card_scenes[name]
    return scene, dataclasses.replace(cfg, integrator=integrator, seed=seed)


@pytest.fixture
def eager():
    """`with eager():` the rule sends no round to the graph; the rounds take
    the shading kernel as the captured ones do."""

    @contextlib.contextmanager
    def go():
        with pytest.MonkeyPatch.context() as m:
            m.setattr(scan_graph, "graph_step",
                      lambda scene, config, ids, rounds, fused:
                      scan_graph.eager_step(config, rounds, fused))
            yield

    return go


def _render(scene, cfg, **kw):
    return render(scene, cfg, device="cuda", mega=False, **kw)


def _film_close(a, b):
    """Films whose splats added the same samples in another order."""
    for k in ("composite", "albedo", "normal", "weights"):
        x, y = a[k], b[k]
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(y).max())),
                                   err_msg=k)


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_replayed_layers_equal_eager_bit_for_bit(card_scenes, name, integrator):
    """The round's body, `_round_layers`, captured once and replayed for two
    seeds and two sample indices, against eager calls with the same ids."""
    scene, cfg = _setup(card_scenes, name, integrator)
    dev = _card()
    ids = torch.arange(cfg.width * cfg.height, device=dev)
    s2c = camera_ops.sample_to_camera_matrix(scene.camera.to("cpu"), cfg.width,
                                             cfg.height).to(dev)
    scalar = torch.zeros((), dtype=torch.int64, device=dev)
    _round_layers(scene, cfg, ids, 0)  # warm: load every kernel before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        pos_g, layers_g = _round_layers(scene, dataclasses.replace(cfg, seed=0), ids, scalar, s2c)
    for seed in (7, 2**31 - 11):
        for sample in (0, 3):
            pos, layers = _round_layers(scene, dataclasses.replace(cfg, seed=seed), ids, sample)
            scalar.fill_(scan_graph.sample_scalar(sample, seed))
            g.replay()
            assert torch.equal(pos_g, pos) and torch.equal(layers_g, layers), (seed, sample)


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_graphed_films_match_eager(card_scenes, name, integrator, eager, monkeypatch):
    """Through render(), in chunks (MAX_LANES cut so that the round has
    several, the last padded): the graph's film against eager's. Depth 7
    is this test's alone, so that its first render captures the round
    with these chunks."""
    scene, cfg = _setup(card_scenes, name, integrator)
    cfg = dataclasses.replace(cfg, max_depth=7)
    monkeypatch.setattr(render_mod, "MAX_LANES", (cfg.width * cfg.height) // 3 + 5)
    got = _render(scene, cfg, sample_count=3)
    with eager():
        want = _render(scene, cfg, sample_count=3)
    _film_close(got, want)
    assert got["spp_done"] == want["spp_done"] == 3


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_previews_checkpoints_and_resume_match_eager(card_scenes, name, integrator, eager,
                                                     tmp_path):
    scene, cfg = _setup(card_scenes, name, integrator)

    def run(tag):
        previews = []
        out = _render(scene, cfg, sample_count=3, preview_every=1,
                      preview_callback=lambda layers, n: previews.append((n, layers)))
        ckpt = str(tmp_path / f"{tag}.npz")
        _render(scene, cfg, sample_count=2, checkpoint_path=ckpt, checkpoint_every=1)
        resumed = _render(scene, cfg, sample_count=4, checkpoint_path=ckpt, resume=True)
        return out, previews, resumed

    out, previews, resumed = run("graph")
    with eager():
        out_e, previews_e, resumed_e = run("eager")
    _film_close(out, out_e)
    assert [n for n, _ in previews] == [n for n, _ in previews_e] == [1, 2, 3]
    for (_, a), (_, b) in zip(previews, previews_e):
        _film_close(a, b)
    _film_close(resumed, resumed_e)
    assert resumed["spp_done"] == 4


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_replays_count_launches_and_lanes_as_eager_does(card_scenes, name, integrator, eager):
    """A traced render that only replays (its round captured by the render
    before) against an eager one: every launch.* counter, the lanes and the
    live lanes equal; every round replayed; no capture in the second render."""
    scene, cfg = _setup(card_scenes, name, integrator)
    _render(scene, cfg, sample_count=2)  # the capture, unless an earlier test made it

    def counted(**kw):
        tracing.enable()
        tracing.reset_counters("launch.")
        before = tracing.counters("scan.")
        _render(scene, cfg, sample_count=3, **kw)
        tracing.enable(False)
        after = tracing.counters("scan.")
        return tracing.counters("launch."), {k: v - before.get(k, 0) for k, v in after.items()}

    launches, scan = counted()
    with eager():
        launches_e, scan_e = counted()
    assert launches == launches_e and sum(launches.values()) > 0
    for k in ("scan.lanes", "scan.lanes_live"):
        assert scan[k] == scan_e[k] > 0, k
    assert scan.get("scan.graph_captures", 0) == 0
    assert scan["scan.rounds"] == scan["scan.rounds_graphed"] == 3
    assert scan_e["scan.rounds"] == 3 and scan_e.get("scan.rounds_graphed", 0) == 0


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_a_second_render_of_the_scene_captures_nothing(card_scenes, name, integrator):
    """Depths 6 and 5 are this test's alone: its first render captures."""
    scene, cfg = _setup(card_scenes, name, integrator)
    cfg = dataclasses.replace(cfg, max_depth=6)
    before = tracing.counter("scan.graph_captures")
    _render(scene, cfg, sample_count=2)
    assert tracing.counter("scan.graph_captures") == before + 1
    for seed in (1, 2**31 - 1):
        _render(scene, dataclasses.replace(cfg, seed=seed), sample_count=4)
    assert tracing.counter("scan.graph_captures") == before + 1
    # another depth is another graph, the same scene's first one stays cached
    _render(scene, dataclasses.replace(cfg, max_depth=5), sample_count=2)
    _render(scene, cfg, sample_count=2)
    assert tracing.counter("scan.graph_captures") == before + 2
