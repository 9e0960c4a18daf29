"""Tests of the benchmark's harness. Those that need a CUDA card carry the
`card` marker and decide inside the test whether to skip; run them on the
card with `python -m pytest benchmarks/tests -m card`."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


CPU_RUN = """\
import functools, sys
sys.path[:0] = ['benchmarks', '.', {port_root!r}]
import torch
torch.set_num_threads(1)
from harness import cell, guard
guard.require_cards = lambda chips: None
cell.run_cell = functools.partial(cell.run_cell, device='cpu', overrides={overrides!r})
import run
sys.exit(run.main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds', '0.3',
                   '--trace', '0']))
"""


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files alone (`BENCHMARK.json` and
    `benchmarks/`), as the driver's checkout holds them."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.fixture
def cpu_run():
    """`cpu_run(root, workload, overrides)`: the benchmark's command, run.py,
    in a fresh interpreter from the checkout at `root`, with the look for a
    card skipped and every render on the CPU at the sizes `overrides` give
    (the program is imported from this repository)."""

    def go(root, workload, overrides, seed=2**31 + 17):
        code = CPU_RUN.format(port_root=str(BENCH.parent), overrides=overrides,
                              workload=workload, seed=seed)
        return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=600)

    return go
