"""The reader of `scan_splat_pct.scan` on hand-made counters.

    python -m pytest benchmarks/tests/test_bench_scan_splat.py
"""

from types import SimpleNamespace

import pytest

from harness import manifest, spans
from harness.cell import Run

NAME = "scan_splat_pct.scan"


def _run(traced=True):
    return Run(cell=None, spp=4, setup_s=1.0, scene_load_s=0.1, window_start=0.0, renders=[],
               trace=SimpleNamespace(renders=1) if traced else None)


def _tracer(counts, dropped=0):
    return SimpleNamespace(
        records=lambda: [], dropped=dropped, counter=lambda name: counts.get(name, 0),
        counters=lambda prefix="": {k: v for k, v in counts.items() if k.startswith(prefix)})


@pytest.mark.parametrize("counts,want", [
    ({"scan.rounds": 4, "scan.rounds_splatted": 4, "scan.rounds_fused": 4}, 100.0),
    ({"scan.rounds": 4, "scan.rounds_splatted": 1}, 25.0),
    ({"scan.rounds": 4, "scan.rounds_splatted": 0}, 0.0),  # every round splatted in torch
])
def test_the_reader_reads_the_splatted_share(monkeypatch, counts, want):
    monkeypatch.setattr(spans, "tracer", lambda: _tracer(counts))
    assert manifest.metric_reader(NAME)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("tracer,traced", [
    (lambda: None, True),  # a program without the tracer
    (lambda: _tracer({}), True),  # a program that counts no rounds
    # a program that counts rounds but has no splat kernel (its parent)
    (lambda: _tracer({"scan.rounds": 4, "scan.rounds_graphed": 4, "scan.rounds_fused": 4}),
     True),
    (lambda: _tracer({"scan.rounds": 4, "scan.rounds_splatted": 4}, dropped=2), True),
    (lambda: _tracer({"scan.rounds": 4, "scan.rounds_splatted": 4}), False),
])
def test_nothing_to_read_reads_none(monkeypatch, tracer, traced):
    monkeypatch.setattr(spans, "tracer", tracer)
    assert manifest.metric_reader(NAME)(_run(traced)) is None


def test_the_metric_has_its_entry():
    (m,) = [m for m in manifest.load_manifest()["per_layer"] if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"], m["unit"], m["better"]) == (
        "program_counter", "scan path", "scan_mpaths_per_s", ["tess100k-scan-4spp"], "%",
        "higher")
