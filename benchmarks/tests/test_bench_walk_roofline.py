"""The medium branch's yardstick (`harness/walk_roofline.py`) against
chip_smoke.py phase 12's bound, and the four readers of the medium cell.

    python -m pytest benchmarks/tests/test_bench_walk_roofline.py
"""

import json
from types import SimpleNamespace

import pytest

from harness import manifest, roofline, spans, walk_roofline
from harness.cell import Run
from harness.profile import TraceSlice

WORKLOAD = "tess8k-offline-64spp"
READERS = ("pathk_medium_roofline", "render_mfu.medium", "walk_pack_ms.medium",
           "pathk_iters_per_sample.medium")
# PERF.md row 2: one 800x600 x 16-spp launch of config M, 20.228 ms on the card
LAUNCH_S, PIXELS, SPP = 20.228e-3, 800 * 600, 16


def test_the_walk_yardstick_is_chip_smokes_phase_12_bound():
    # chip_smoke.py phase 12: iterations x (nodes x OPS_SLAB + leaves x 4 x (OPS_MT + 1)
    # + OPS_RAY + n_sph x OPS_SPHERE + 5), the closest-hit walks alone; 17,709,691
    # iterations at 54.7 nodes and 3.86 leaves per ray gave 0.5813 ms (PERF.md row 2)
    iters, paths = 17_709_691, PIXELS * SPP
    work = {"spheres": 0, "segments_per_path": iters / paths, "pathk_out_bytes": 64,
            "walk": {"nodes_per_ray": 54.7, "leaves_per_ray": 3.86}}
    assert walk_roofline.segment_ops(work) == pytest.approx(54.7 * 25 + 3.86 * 4 * 53 + 9 + 5)
    ops, nbytes = walk_roofline.pathk_walk_work(work, paths, PIXELS)
    seconds, by = roofline.bound_s(ops, nbytes)
    assert by == "operations" and seconds * 1e3 == pytest.approx(0.5813, rel=0.01)


def test_the_configs_work_holds_what_the_yardstick_reads():
    cfg = json.loads((manifest.ROOT / "benchmarks/configs/tess-cornell-8k.json").read_text())
    work = cfg["work"]
    assert work["triangles"] == 2 * 2 * 40 * 50 + 12 and work["spheres"] == 0
    assert 1.5 < work["segments_per_path"] < 4.0
    assert 20 < work["walk"]["nodes_per_ray"] < 200 and 1 < work["walk"]["leaves_per_ray"] < 20
    assert cfg["reduced"] == [] and cfg["assumed"] and cfg["work"]["derivation"]


def _trace(renders=1, window_s=0.0215, kernels=None):
    kernels = [("void pk::pathk_staged_kernel<true>(pk::Tables, float*, unsigned int*)",
                LAUNCH_S)] if kernels is None else kernels
    return TraceSlice(renders=renders, paths=float(PIXELS * SPP * renders),
                      pixels=float(PIXELS * renders), window_s=window_s, busy_s=window_s,
                      launches=renders, kernels=kernels)


def _run(trace):
    return Run(cell=manifest.load_cell(WORKLOAD), spp=SPP, setup_s=1.0, scene_load_s=0.1, window_start=0.0,
               renders=[], trace=trace)


@pytest.mark.parametrize("name", ["pathk_medium_roofline", "render_mfu.medium"])
def test_the_shares_read_under_100_on_the_measured_launch(name):
    got = manifest.metric_reader(name)(_run(_trace()))
    assert 0.0 < got < 100.0, got


def test_the_roofline_reads_the_staged_kernel_alone():
    small = [("void pk::pathk_kernel<true>(pk::Tables, float*, unsigned int*)", LAUNCH_S)]
    assert manifest.metric_reader("pathk_medium_roofline")(_run(_trace(kernels=small))) is None
    both = _trace(kernels=small + _trace().kernels)
    assert manifest.metric_reader("pathk_medium_roofline")(_run(both)) == pytest.approx(
        manifest.metric_reader("pathk_medium_roofline")(_run(_trace())))


class Rec(SimpleNamespace):
    pass


def _records():
    """Two renders of a slice, one `pack.walk_tables` each (1.5 and 2.5 ms),
    and a warm-up render before them that the slice leaves out."""
    out = []
    for req, t0, walk in ((1, 0, 9.0), (10, 100, 1.5), (20, 200, 2.5)):
        out += [Rec(request=req, id=req + 2, parent=req + 1, name="pack.walk_tables",
                    start_ns=int(t0 * 1e6), end_ns=int((t0 + walk) * 1e6), attrs={}),
                Rec(request=req, id=req + 1, parent=0, name="render",
                    start_ns=int(t0 * 1e6), end_ns=int((t0 + 50) * 1e6), attrs={})]
    return out


def _tracer(records=(), counts=None, dropped=0):
    counts = counts or {}
    return SimpleNamespace(records=lambda: list(records), dropped=dropped,
                           counter=lambda name: counts.get(name, 0))


def test_the_span_and_counter_readers_read_known_values(monkeypatch):
    counts = {"pathk.iterations": 23_000, "pathk.samples": 10_000}
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(_records(), counts))
    run = _run(_trace(renders=2))
    assert manifest.metric_reader("walk_pack_ms.medium")(run) == pytest.approx(2.0)
    assert manifest.metric_reader("pathk_iters_per_sample.medium")(run) == pytest.approx(2.3)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_without_a_trace(monkeypatch, name):
    counts = {"pathk.iterations": 23_000, "pathk.samples": 10_000}
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(_records(), counts))
    assert manifest.metric_reader(name)(_run(None)) is None


@pytest.mark.parametrize("name", READERS[2:])
def test_the_program_readers_read_none_without_a_tracer_or_its_records(monkeypatch, name):
    run = _run(_trace(renders=2))
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert manifest.metric_reader(name)(run) is None
    # a program without the span or the counters: the parent of these metrics
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(
        [r for r in _records() if r.name == "render"]))
    assert manifest.metric_reader(name)(run) is None
