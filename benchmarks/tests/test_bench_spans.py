"""The readers of the program's spans and counters on hand-made records, and
the trace reading unmoved by the program's annotations.

    python -m pytest benchmarks/tests/test_bench_spans.py [-m card]

The card test holds the device counter (an int32 buffer per mask shape,
summed at the fold) against torch's sum and reads the span tree of a small
scan render on the card."""

import copy
from types import SimpleNamespace

import pytest

from harness import manifest, profile, spans
from harness.cell import Run
from test_bench_timeline import _ev, _trace

NEW = ("dispatch_ms.live", "dispatch_ms.offline", "readout_ms.live", "scan_bounce_ms.scan",
       "live_lane_pct.scan", "kernel_load_s")


class Rec(SimpleNamespace):
    pass


def rec(request, id, parent, name, start_ms, end_ms):
    return Rec(request=request, id=id, parent=parent, name=name,
               start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6), attrs={})


def _records():
    """A set-up load, a warm-up render traced by hand (left out of the
    slice) and a slice of two renders: dispatch 2 + 4 ms, readout 1.5 and
    2.5 ms of which 1 and 2 ms wait, bounces 3, 5 and 7 ms."""
    r = [rec(1, 2, 0, "kernels.load", 0, 1500),
         rec(3, 5, 4, "render.dispatch", 2000, 2100), rec(3, 4, 0, "render", 2000, 2200)]
    for req, t0, disp, bounces, readout, wait in ((10, 3000, 2, (3, 5), 1.5, 1),
                                                  (20, 4000, 4, (7,), 2.5, 2)):
        root = req + 1
        r.append(rec(req, req + 2, root, "render.dispatch", t0, t0 + disp))
        t = t0 + disp
        for k, b in enumerate(bounces):
            r.append(rec(req, req + 3 + k, root, "scan.bounce", t, t + b))
            t += b
        r.append(rec(req, req + 8, req + 7, "readout.wait", t + 0.5, t + 0.5 + wait))
        r.append(rec(req, req + 7, root, "render.readout", t, t + readout))
        r.append(rec(req, root, 0, "render", t0, t + readout))
    return r


def _tracer(records, counts=None, dropped=0):
    counts = counts or {}
    return SimpleNamespace(records=lambda: list(records), dropped=dropped,
                           counter=lambda name: counts.get(name, 0))


def _run(renders=2):
    return Run(cell=None, spp=4, setup_s=1.0, scene_load_s=0.1, window_start=0.0, renders=[],
               trace=SimpleNamespace(renders=renders))


@pytest.mark.parametrize("name,want", [
    ("dispatch_ms.live", 3.0), ("dispatch_ms.offline", 3.0), ("readout_ms.live", 0.5),
    ("scan_bounce_ms.scan", 5.0), ("live_lane_pct.scan", 25.0), ("kernel_load_s", 1.5),
])
def test_each_reader_reads_known_values(monkeypatch, name, want):
    counts = {"scan.lanes": 8, "scan.lanes_live": 2}
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(_records(), counts))
    assert manifest.metric_reader(name)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW[:-1])
def test_a_slice_that_dropped_records_reads_none(monkeypatch, name):
    counts = {"scan.lanes": 8, "scan.lanes_live": 2}
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(_records(), counts, dropped=1))
    assert manifest.metric_reader(name)(_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_none(monkeypatch, name):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert manifest.metric_reader(name)(_run()) is None


def test_a_slice_with_fewer_roots_than_renders_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(_records()))
    assert manifest.metric_reader("dispatch_ms.live")(_run(renders=4)) is None
    assert manifest.metric_reader("dispatch_ms.live")(_run(renders=1)) == pytest.approx(4.0)


def test_the_new_metrics_have_readers_and_entries():
    per_layer = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
        assert callable(manifest.metric_reader(name))


def _annotated(events):
    """The trace with the program's spans added: each render's subtree as
    `user_annotation` events on the host and `gpu_user_annotation` events on
    the device, as torch.profiler writes a `record_function` range."""
    out = copy.deepcopy(events)
    for t0 in (0, 100):
        for name, s, d in (("render", 1, 98), ("render.dispatch", 1, 4),
                           ("render.step", 6, 80), ("render.readout", 88, 10),
                           ("readout.wait", 90, 7)):
            out.append(_ev("user_annotation", name, t0 + s, d))
            out.append(_ev("gpu_user_annotation", name, t0 + s + 3, d))
    return out


def test_read_trace_is_unmoved_by_the_programs_annotations():
    plain = profile.read_trace(_trace(), renders=2, paths=8.0, pixels=4.0)
    annotated = profile.read_trace(_annotated(_trace()), renders=2, paths=8.0, pixels=4.0)
    assert annotated == plain
    assert (annotated.busy_s, annotated.launches, annotated.kernels, annotated.breakdown) == (
        plain.busy_s, plain.launches, plain.kernels, plain.breakdown)


@pytest.mark.card
def test_device_counts_and_the_span_tree_on_the_card(monkeypatch):
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_tessellated_cornell
    from optix_renderer_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(7)
    masks = [torch.rand(n, generator=g) < p for n, p in ((1, 1.0), (1000, 0.3), (480_000, 0.7),
                                                          (3_000_001, 0.01))]
    monkeypatch.setattr(tracing, "_enabled", True)
    with tracing.span("render"):
        for m in masks:
            tracing.count_device("test.live", m.to(dev))
        before = tracing.counter("test.live")
        tracing.fold_device()
    assert tracing.counter("test.live") - before == sum(int(m.sum()) for m in masks)

    seen = []
    real = tracing.count_device

    def spy(name, mask):
        seen.append(int(mask.sum()))
        real(name, mask)

    scene, cfg, _ = make_tessellated_cornell(64, 48, 2, "path_mis", nu=12, nv=7, device=dev)
    cfg = dataclasses.replace(cfg, max_depth=4)
    monkeypatch.setattr(tracing, "count_device", spy)
    tracing.clear()
    live0, lanes0 = tracing.counter("scan.lanes_live"), tracing.counter("scan.lanes")
    render(scene, cfg, sample_count=2, device=dev, mega=False)
    assert len(seen) == 8 and seen[0] == 64 * 48
    assert tracing.counter("scan.lanes_live") - live0 == sum(seen)
    assert tracing.counter("scan.lanes") - lanes0 == 8 * 64 * 48
    names = [r.name for r in tracing.records()]
    assert names.count("render") == 1 and names.count("scan.bounce") == 8
    assert {"render.dispatch", "scan.round", "scan.intersect", "scan.nee", "scan.splat",
            "render.readout", "readout.wait"} <= set(names)
