"""The port's tracer (`utils/tracing.py`): spans, the switch, self time, the
thread-local stack, the cap, counters, and the span tree of small CPU
renders on the path kernel's plain version, on the scan path and in
adaptive sampling.

The device counter runs the same torch code on the CPU as on a card;
`benchmarks/tests/test_bench_spans.py -m card` holds it against torch's sum
on the card too."""

import ctypes
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.ops.cuda import _build
from optix_renderer_tpu_torch.render.adaptive import render_adaptive
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml, make_cornell_box
from optix_renderer_tpu_torch.utils import tracing
from optix_renderer_tpu_torch.utils.tracing import Record


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts with tracing off and no records, and leaves it so."""
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


def _tree(recs):
    """{id: (name, parent's name)} of the records."""
    by_id = {r.id: r for r in recs}
    return {r.id: (r.name, by_id[r.parent].name if r.parent else None) for r in recs}


def test_off_leaves_no_record_and_opens_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("render", spp=1):
        assert not tracing.recording()
        inner = tracing.span("render.step")
        assert inner is tracing.span("render.readout")  # one shared no-op
        with inner as s:
            s.set(ignored=True)
    tracing.count_device("scan.lanes_live", torch.ones(4, dtype=torch.bool))
    assert tracing.records() == [] and tracing.counter("scan.lanes_live") == 0


def test_nesting_parents_and_one_request_per_root():
    tracing.enable()
    for _ in range(2):
        with tracing.span("render", spp=4) as root:
            with tracing.span("render.dispatch"):
                with tracing.span("dispatch.pack"):
                    pass
            with tracing.span("render.step", sample=0):
                pass
            root.set(path="scan")
    recs = tracing.records()
    assert [r.name for r in recs] == ["dispatch.pack", "render.dispatch", "render.step",
                                      "render"] * 2
    assert _tree(recs[:4]) == {recs[0].id: ("dispatch.pack", "render.dispatch"),
                               recs[1].id: ("render.dispatch", "render"),
                               recs[2].id: ("render.step", "render"),
                               recs[3].id: ("render", None)}
    assert len({r.request for r in recs[:4]}) == 1 and len({r.request for r in recs[4:]}) == 1
    assert recs[0].request != recs[4].request
    assert recs[3].attrs == {"spp": 4, "path": "scan"} and recs[2].attrs == {"sample": 0}
    for r in recs:
        assert r.end_ns >= r.start_ns
        if r.parent:
            p = next(q for q in recs if q.id == r.parent)
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_self_time_is_duration_minus_child_cover():
    recs = [Record(1, 1, 0, "render", 0, 100, {}),
            Record(1, 2, 1, "render.step", 10, 30, {}),
            Record(1, 3, 1, "render.step", 20, 50, {}),  # overlaps the first step
            Record(1, 4, 1, "render.readout", 90, 120, {}),  # runs past its parent
            Record(1, 5, 2, "scan.round", 12, 18, {})]
    got = tracing.self_ns(recs)
    assert got == {1: 100 - (50 - 10) - (100 - 90), 2: 20 - 6, 3: 30, 4: 30, 5: 6}


def test_records_follow_the_profiler_and_sit_in_its_trace(tmp_path):
    with tracing.span("render"):
        pass
    assert tracing.records() == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("render"):
            assert tracing.recording()
            with tracing.span("render.readout"):
                torch.ones(8).sum()
    assert [r.name for r in tracing.records()] == ["render.readout", "render"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"render", "render.readout"} <= names
    with tracing.span("render"):  # the profiler stopped: off again
        assert not tracing.recording()


def test_the_switch_is_read_once_when_the_root_opens():
    with tracing.span("render"):
        tracing.enable()
        with tracing.span("render.step"):
            assert not tracing.recording()
    with tracing.span("render"):
        tracing.enable(False)
        with tracing.span("render.step"):
            assert tracing.recording()
    assert [r.name for r in tracing.records()] == ["render.step", "render"]


def test_setup_spans_are_recorded_with_tracing_off():
    with tracing.span("render"):
        with tracing.setup_span("kernels.load", built="loaded"):
            with tracing.span("scene.lbvh"):
                pass
        with tracing.span("render.step"):
            pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["scene.lbvh", "kernels.load"]
    assert _tree(recs) == {recs[0].id: ("scene.lbvh", "kernels.load"),
                           recs[1].id: ("kernels.load", None)}


def test_each_thread_has_its_own_stack():
    tracing.enable()
    barrier = threading.Barrier(4)
    errors = []

    def one(k):
        try:
            with tracing.span("render", k=k):
                barrier.wait(timeout=30)
                for i in range(20):
                    with tracing.span("render.step", sample=i):
                        with tracing.span("scan.round"):
                            pass
                barrier.wait(timeout=30)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.name == "render"]
    assert len(roots) == 4 and len({r.request for r in roots}) == 4
    assert len(recs) == 4 * (1 + 20 * 2)
    for r in recs:
        if r.parent:
            assert by_id[r.parent].request == r.request
            assert {"render.step": "render", "scan.round": "render.step"}[r.name] == \
                by_id[r.parent].name


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 5)
    tracing.enable()
    with tracing.span("render"):
        for _ in range(6):
            with tracing.span("render.step"):
                pass
    assert len(tracing.records()) == 5 and tracing.dropped == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped == 0


def test_host_counters_add_and_reset():
    before = tracing.counters("launch.")
    tracing.count("launch.test_kernel")
    tracing.count("launch.test_kernel", 2)
    assert tracing.counter("launch.test_kernel") == 3
    assert tracing.counters("launch.") == {**before, "launch.test_kernel": 3}
    tracing.reset_counters("launch.test_")
    assert tracing.counter("launch.test_kernel") == 0
    with pytest.raises(ValueError, match="bool"):
        tracing.enable()
        with tracing.span("render"):
            tracing.count_device("scan.lanes_live", torch.ones(3))


def test_device_counts_wait_for_the_fold_and_keep_one_buffer_per_shape():
    g = torch.Generator().manual_seed(3)
    masks = [torch.rand(n, generator=g) < p for n, p in ((7, 0.5), (7, 0.9), (40, 0.3), (7, 1.0))]
    before = tracing.counter("test.live")
    tracing.enable()
    with tracing.span("render"):
        for m in masks:
            tracing.count_device("test.live", m)
    assert tracing.counter("test.live") == before  # the root's exit does not fold
    tracing.fold_device()
    assert tracing.counter("test.live") - before == sum(int(m.sum()) for m in masks)
    tracing.fold_device()  # nothing added since: nothing moves
    assert tracing.counter("test.live") - before == sum(int(m.sum()) for m in masks)
    bufs = {k[2]: dc.buf for k, dc in tracing._t.device.items() if k[0] == "test.live"}
    assert set(bufs) == {torch.Size([7]), torch.Size([40])}
    assert torch.equal(bufs[torch.Size([7])], sum(m.int() for m in masks if m.numel() == 7))


def test_kernels_load_is_a_setup_span_of_the_first_load(monkeypatch, tmp_path):
    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: (tmp_path / "lib.so", False))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    lib = _build.load()
    assert _build.load() is lib
    recs = tracing.records()
    assert [(r.name, r.attrs) for r in recs] == [("kernels.load", {"built": "loaded"})]


@pytest.fixture(scope="module")
def small_box():
    scene, cfg, _ = make_cornell_box(16, 12, 2, "path_mis", device="cpu")
    return scene, dataclasses.replace(cfg, max_depth=4)


@pytest.mark.parametrize("mega", [None, False], ids=["path_kernel", "scan"])
def test_a_render_yields_the_span_tree(small_box, mega):
    scene, cfg = small_box
    tracing.enable()
    render(scene, cfg, sample_count=2, device="cpu", mega=mega)
    recs = tracing.records()
    assert len({r.request for r in recs}) == 1
    edges = sorted(set(_tree(recs).values()), key=str)
    (root,) = [r for r in recs if r.parent == 0]
    assert root.name == "render" and root.attrs == {
        "spp": 2, "pixels": 192, "path": "pathk" if mega is None else "scan"}
    common = [("render", None), ("render.dispatch", "render"), ("render.readout", "render"),
              ("render.step", "render"), ("readout.wait", "render.readout")]
    if mega is None:
        # the scene lies on the host: the packing reads it without a snapshot;
        # the eligibility test snapshots its columns
        want = common + [("dispatch.pack", "render.dispatch"),
                         ("dispatch.snapshot", "render.dispatch")]
        assert [r.attrs for r in recs if r.name == "render.step"] == [{"sample": 0, "n": 2}]
    else:
        want = common + [("scan.bounce", "scan.round"), ("scan.intersect", "scan.bounce"),
                         ("scan.nee", "scan.bounce"), ("scan.round", "render.step"),
                         ("scan.splat", "scan.round")]
        assert [r.attrs for r in recs if r.name == "scan.bounce"] == [
            {"bounce": b} for b in range(4)] * 2
        assert sum(r.name == "scan.intersect" for r in recs) == 8
    assert edges == sorted(want, key=str)


def test_live_lanes_count_the_active_lanes_of_each_bounce(small_box, monkeypatch):
    scene, cfg = small_box
    seen = []
    real = tracing.count_device

    def spy(name, mask):
        seen.append((name, mask.clone()))
        real(name, mask)

    monkeypatch.setattr(tracing, "count_device", spy)
    before = {k: tracing.counter(k) for k in ("scan.lanes", "scan.lanes_live")}
    render(scene, cfg, sample_count=2, device="cpu", mega=False)  # off: nothing counted
    assert seen == [] and tracing.counter("scan.lanes") == before["scan.lanes"]
    tracing.enable()
    render(scene, cfg, sample_count=2, device="cpu", mega=False)
    live = [int(np.count_nonzero(m.numpy())) for _, m in seen]
    assert [n for n, _ in seen] == ["scan.lanes_live"] * 8
    assert live[0] == live[4] == 192 and live[:4] == sorted(live[:4], reverse=True)
    assert 0 < live[3] < 192
    assert tracing.counter("scan.lanes_live") - before["scan.lanes_live"] == sum(live)
    assert tracing.counter("scan.lanes") - before["scan.lanes"] == 8 * 192


def test_cli_trace_out_writes_the_spans_beside_the_ops(tmp_path):
    xml = cornell_box_xml(tmp_path, width=16, height=12, spp=1)
    trace = tmp_path / "render.json"
    rc = cli.main(["render", str(xml), "--device", "cpu", "--spp", "1", "--depth", "2",
                   "--trace-out", str(trace), "-o", str(tmp_path / "out")])
    assert rc == 0
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"scene.load", "render", "render.dispatch", "render.step",
            "render.readout", "readout.wait"} <= names
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_adaptive_sampling_is_one_request_under_a_render_root(small_box, monkeypatch):
    scene, cfg = small_box
    seen = []
    real = tracing.count_device

    def spy(name, mask):
        seen.append(int(mask.sum()))
        real(name, mask)

    monkeypatch.setattr(tracing, "count_device", spy)
    before = tracing.counter("scan.lanes_live")
    tracing.enable()
    render_adaptive(scene, dataclasses.replace(cfg, adaptive_uniform_rounds=1), sample_count=2,
                    device="cpu")
    recs = tracing.records()
    assert len({r.request for r in recs}) == 1
    (root,) = [r for r in recs if r.parent == 0]
    assert root.name == "render"
    edges = set(_tree(recs).values())
    assert {("render.dispatch", "render"), ("scan.round", "render"),
            ("render.readout", "render")} <= edges
    assert len(seen) == 8 and tracing.counter("scan.lanes_live") - before == sum(seen)
