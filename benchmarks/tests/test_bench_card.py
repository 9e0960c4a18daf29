"""The benchmark's command on the card: every cell runs, and is correct.

    python -m pytest benchmarks/tests/test_bench_card.py -m card
"""

import json
import subprocess
import sys

import pytest

from harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_the_command_runs_each_cell_correctly(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", workload, "--seed",
                        str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
                       cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    names = {m.name for m in manifest.metrics_for(manifest.load_manifest(), workload,
                                                  bool(trace))}
    assert set(r["metrics"]) == names
    assert list(r)[-1] == "check"
