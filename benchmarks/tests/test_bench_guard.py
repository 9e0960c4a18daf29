"""What a run refuses: JAX by whole top-level name, and a machine without a card."""

import json
import os
import subprocess
import sys

import pytest

from harness import guard, manifest


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optix_renderer_tpu", True), ("optix_renderer_tpu.ops.pallas.pathk", True),
    ("optix_renderer_tpu_torch", False), ("optix_renderer_tpu_torch.render.render", False),
    ("jaxtyping", False), ("numpy", False),
])
def test_forbidden_modules_compare_whole_top_level_names(name, refused):
    assert guard.forbidden_modules([name]) == ([name] if refused else [])


def test_require_no_jax_raises_on_a_jax_module():
    with pytest.raises(guard.RunRefused):
        guard.require_no_jax(["numpy", "jaxlib.xla_extension"])
    guard.require_no_jax(["numpy", "optix_renderer_tpu_torch"])


def test_a_run_without_a_card_fails_and_prints_no_result():
    """The command itself, on a machine whose torch sees no CUDA device:
    a code other than 0 and no JSON line, instead of a fallback to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "cbox-offline-512spp",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=manifest.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "no CUDA device" in p.stderr


def test_a_cpu_run_of_the_harness_loads_no_jax():
    """A whole (tiny, CPU) run of a cell in a fresh interpreter: no module of
    JAX or of the JAX package is in sys.modules when the window has closed."""
    code = (
        "import sys, time; sys.path[:0] = ['benchmarks', '.']\n"
        "import torch; torch.set_num_threads(1)\n"
        "from harness.cell import run_cell\nfrom harness import guard\n"
        "r = run_cell('cbox-live-16spp', 5, 0.5, False, time.perf_counter(), device='cpu',\n"
        "             overrides={'scene': {'width': 8, 'height': 6}, 'traffic': {'spp': 2},\n"
        "                        'check': {'pixels': 8, 'renders': 1}}, log=lambda *a, **k: None)\n"
        "print(r['correct'], guard.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"


PROBE = """
import sys
import types

{imports}

def read(run):
    return 1.0
"""


@pytest.mark.parametrize("imports_jax", [False, True])
def test_jax_loaded_by_a_metric_reader_refuses_the_result(checkout, cpu_run, imports_jax):
    """The command checks the process's modules last, after the reference and
    every metric reader have run: a reader that brings in a module named
    `jax` (a stand-in here) leaves the run with another code than 0 and no
    result line; the same reader without it gives one."""
    m = json.loads((checkout / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "probe_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                            "source": "host_clock", "workloads": ["cbox-live-16spp"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(m))
    fake = 'sys.modules.setdefault("jax", types.ModuleType("jax"))' if imports_jax else ""
    (checkout / "benchmarks" / "metrics" / "probe_ms.py").write_text(
        PROBE.format(imports=fake))
    p = cpu_run(checkout, "cbox-live-16spp",
                {"scene": {"width": 8, "height": 6}, "traffic": {"spp": 2},
                 "check": {"pixels": 8, "renders": 1}})
    lines = [x for x in p.stdout.splitlines() if x.startswith("{")]
    if imports_jax:
        assert p.returncode != 0 and not lines, p.stdout[-2000:]
        assert "JAX" in p.stderr and "jax" in p.stderr.splitlines()[-1]
    else:
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.splitlines()[-1])
        assert r["correct"] and r["metrics"]["probe_ms"]["value"] == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31 + 12345, 2**63 + 7, -5])
def test_every_render_seed_of_a_run_fits_the_renderers_32_bit_seed(seed):
    from harness.cell import SEED_SPAN, base_seed

    base = base_seed(seed)
    assert 0 <= base and base + 3 * SEED_SPAN <= 2**31 - 1
