"""The manifest against the rules its format keeps, and the harness's data-driven lookups."""

import json
import re

import pytest

from harness import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "benchmarks/run.py"]
    assert M["paths"] == ["benchmarks"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_exactly_their_keys(section, keys):
    for e in M[section]:
        assert set(e) == keys, e
        assert NAME.match(e["name"]) and LINE.match(e["why"])


def test_names_units_and_sources():
    metrics = M["end_to_end"] + M["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    for c in M["configs"]:
        assert LINE.match(c["source"]) and all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in M["workloads"]:
        got = {m.name for m in manifest.metrics_for(M, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2, w["name"]
        layers = manifest.metrics_for(M, w["name"], True)
        assert layers, w["name"]
        for m in [x for x in M["per_layer"] if x["name"] in {y.name for y in layers}]:
            assert m["moves"] in got, (w["name"], m["name"])


def test_metric_workload_lists_name_cells():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_its_files_by_name(workload):
    cell = manifest.load_cell(workload)
    assert cell.config["name"] == [w for w in M["workloads"] if w["name"] == workload][0]["config"]
    assert int(cell.traffic["spp"]) > 0 and cell.check["limits"]
    assert callable(manifest.resolve(cell.config["writer"]))
    for trace in (False, True):
        for m in manifest.metrics_for(M, workload, trace):
            assert callable(manifest.metric_reader(m.name))


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmarks/") and (manifest.ROOT / f).is_file()


DUMMY_REFERENCE = """
from reference.pathtrace import reference_film


def film(xml, pixels, spp, seed, *, max_depth, device="cpu", dtype=None, shift=0.0):
    out = reference_film(xml, pixels, spp, seed, max_depth=max_depth, estimator="splat",
                         device=device, dtype=dtype)
    out["composite"] = out["composite"] + shift
    return out
"""


def _add_dummy_cell(root, render=None, shift=0.0):
    """A configuration with a reference of its own, a traffic mix, a check
    and two metrics, added as new files and manifest entries alone."""
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "dummy-cfg", "source": "https://example.org/dummy",
                         "file": "benchmarks/configs/dummy-cfg.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg", "traffic": "dummy-mix",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "dummy_rate", "unit": "1/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": ["dummy-cell"]})
    m["per_layer"].append({"name": "dummy_layer.x", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "setup_s",
                           "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    b = root / "benchmarks"
    (b / "configs" / "dummy-cfg.json").write_text(json.dumps(
        {"name": "dummy-cfg", "writer": "reference.scenes:tessellated_cornell_xml",
         "scene": {"width": 8, "height": 6, "integrator": "path_mis", "rfilter": "gaussian",
                   "nu": 8, "nv": 5},
         "max_depth": 3, "reference": "reference.dummy_ref:film",
         "reference_args": {"shift": shift}}))
    (b / "reference" / "dummy_ref.py").write_text(DUMMY_REFERENCE)
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"spp": 1, "trace_renders": 1, "render": {} if render is None else render}))
    (b / "checks" / "dummy-cell.json").write_text(json.dumps(
        {"renders": 1, "pixels": 12, "rel": 1e-4, "floor": 1e-3, "limits": {"pixels_off": 0.0}}))
    (b / "metrics" / "dummy_layer.x.py").write_text("def read(run):\n    return 42.0\n")
    (b / "metrics" / "dummy_rate.py").write_text(
        "def read(run):\n    return len(run.renders) / 0.3\n")


def _files(root):
    return {p: p.read_bytes() for p in (root / "benchmarks").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_traffic_and_metric_are_added_as_files_alone(checkout):
    """The dummy cell resolves without an edit of any file that was there."""
    before = _files(checkout)
    _add_dummy_cell(checkout)
    cell = manifest.load_cell("dummy-cell", checkout)
    assert cell.traffic["spp"] == 1 and cell.traffic["loop"] == "closed"
    assert cell.config["max_depth"] == 3
    assert [x.name for x in manifest.metrics_for(cell.manifest, "dummy-cell", True)] == \
        ["scene_load_s", "dummy_layer.x"]
    assert manifest.metric_reader("dummy_layer.x", checkout)(None) == 42.0
    assert {p: b for p, b in _files(checkout).items() if p in before} == before


@pytest.mark.parametrize("render,shift,correct", [
    ({"mega": False}, 0.0, True),
    ({}, 0.0, False),
    ({"mega": False}, 0.05, False),
], ids=["sound", "render_kwargs_left_out", "reference_shifted"])
def test_the_command_runs_a_cell_added_as_files_alone(checkout, cpu_run, render, shift,
                                                      correct):
    """The command runs the dummy cell on the CPU: the traffic's `render`
    arguments reach `render()` (without `mega=False` the scene takes the
    path kernel, whose sample streams the scan-path reference does not
    follow) and the check runs the configuration's own reference."""
    _add_dummy_cell(checkout, render, shift)
    p = cpu_run(checkout, "dummy-cell", {})
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] is correct, r["check"]
    assert set(r["metrics"]) == {"setup_s", "dummy_rate"} and r["attempted"] > 0


def test_a_suffixed_metric_name_falls_back_to_its_stems_reader(checkout):
    (checkout / "benchmarks" / "metrics" / "dummy_stem.py").write_text(
        "def read(run):\n    return 7.0\n")
    assert manifest.metric_reader("dummy_stem.anything", checkout)(None) == 7.0
    assert manifest.metric_reader("device_idle_pct.scan") is not None
    with pytest.raises(FileNotFoundError):
        manifest.metric_reader("no_such_metric.scan", checkout)


@pytest.mark.parametrize("traffic", [
    {"spp": 4, "trace_renders": 1, "rate_per_s": 10},
    {"spp": 4, "trace_renders": 1, "loop": "open"},
    {"spp": 4, "trace_renders": 1, "clients": 4},
    {"spp": 4, "trace_renders": 1, "seeds": "frame index"},
    {"trace_renders": 1},
    {"spp": 0, "trace_renders": 1},
    {"spp": 4, "trace_renders": 1, "render": {"sample_count": 8}},
    {"spp": 4, "trace_renders": 1, "render": ["mega"]},
], ids=["unknown_key", "open_loop", "four_clients", "other_seeds", "no_spp", "no_samples",
        "render_sets_the_harness_argument", "render_not_a_dict"])
def test_traffic_the_generator_does_not_run_is_refused(traffic):
    with pytest.raises(ValueError):
        manifest.traffic_plan(traffic)


def test_the_generator_fills_its_defaults():
    assert manifest.traffic_plan({"spp": 2, "trace_renders": 1}) == {
        "loop": "closed", "clients": 1, "seeds": "base+i", "spp": 2, "trace_renders": 1,
        "render": {}}
