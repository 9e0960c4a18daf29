"""The manifest (`BENCHMARK.json`) and the data files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by its name:

* `configs/<config>.json` (the path is the manifest's `file`): the scene's
  parameters, its `writer` and its plain `reference`, each a
  `module:function` under the benchmark's folder (`resolve`), so a new
  kind of scene or a new reference is a new file;
* `traffic/<traffic>.json`: the parameters of the one generator
  (`traffic_plan`), which refuses a key or a value it does not run;
* `checks/<workload>.json`: the sizes and limits of the comparison that
  decides the cell's `correct` (`harness.check`);
* `metrics/<metric>.py`, a reader `read(run) -> float | None`; a name with
  a suffix after its first `.` (`device_idle_pct.scan`) falls back to the
  reader of its stem (`metrics/device_idle_pct.py`) where it has none of
  its own.

So a later cell, mix or metric is new files and manifest entries, and no
edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict
    check: dict
    manifest: dict


# the generator's parameters: the value a key takes where a file leaves it
# out, or None where the file must give it
TRAFFIC = {
    "loop": "closed",  # back-to-back requests, the next one sent when the last returns
    "clients": 1,  # one client: render() is called from one thread
    "seeds": "base+i",  # request i renders with seed base + i (base drawn from --seed)
    "spp": None,  # samples per pixel of every request
    "trace_renders": None,  # requests in the --trace 1 run's profiled slice
    "render": {},  # further keyword arguments of every render() call
}
TRAFFIC_RUNS = {"loop": ("closed",), "clients": (1,), "seeds": ("base+i",)}
HARNESS_KWARGS = ("scene", "config", "sample_count", "device")


def traffic_plan(traffic: dict) -> dict:
    """The traffic file's parameters with their defaults filled in. A key the
    generator does not know, or a value it does not run (an open loop,
    several clients), is refused rather than run as something else."""
    unknown = sorted(set(traffic) - set(TRAFFIC))
    if unknown:
        raise ValueError(f"traffic keys the generator does not know: {unknown}")
    plan = {k: traffic.get(k, v) for k, v in TRAFFIC.items()}
    missing = [k for k, v in plan.items() if v is None]
    if missing:
        raise ValueError(f"traffic keys missing: {missing}")
    for k, runs in TRAFFIC_RUNS.items():
        if plan[k] not in runs:
            raise ValueError(f"traffic {k}={plan[k]!r}: the generator runs only {runs}")
    if int(plan["spp"]) < 1 or int(plan["trace_renders"]) < 1:
        raise ValueError("traffic spp and trace_renders are at least 1")
    if not isinstance(plan["render"], dict) or set(plan["render"]) & set(HARNESS_KWARGS):
        raise ValueError(f"traffic render: a dict of keyword arguments other than "
                         f"{HARNESS_KWARGS}")
    return plan


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The end-to-end metrics (trace off) or the per-layer ones (trace on)
    that `workload` reports: those whose `workloads` list it, or that have
    no such list."""
    kind = "per_layer" if trace else "end_to_end"
    return [Metric(m["name"], m["unit"])
            for m in manifest[kind] if workload in m.get("workloads", [workload])]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """Resolve a workload's configuration, traffic and check by name, in the
    checkout at `root`."""
    manifest = load_manifest(root)
    if not NAME.match(workload):
        raise ValueError(f"bad workload name {workload!r}")
    cells = [w for w in manifest["workloads"] if w["name"] == workload]
    if len(cells) != 1:
        raise ValueError(f"no workload named {workload!r} in BENCHMARK.json")
    w = cells[0]
    cfg = [c for c in manifest["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_read_json(root / cfg["file"]),
        traffic=traffic_plan(_read_json(root / BENCH.name / "traffic" / f"{w['traffic']}.json")),
        check=_read_json(root / BENCH.name / "checks" / f"{workload}.json"),
        manifest=manifest)


def metric_reader(name: str, root: Path = ROOT):
    """The `read(run)` function of `metrics/<name>.py`, or of the file of the
    name's stem (before its first `.`) where the name has no file."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = root / BENCH.name / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(f"{name.split('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(dotted: str):
    """`package.module:function` under the benchmark's folder → the function."""
    mod, fn = dotted.split(":")
    return getattr(importlib.import_module(mod), fn)
