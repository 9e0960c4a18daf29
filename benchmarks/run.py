"""Benchmark of optix_renderer_tpu_torch: one run of one cell on the card.

    python benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic, check
and metrics are found by name from `BENCHMARK.json` (`harness/manifest.py`).
The last line of standard output is the result, one JSON object; the last
lines of standard error name each number of the check beside its limit. A
run without a CUDA card, with fewer cards than the cell asks for, or with
JAX loaded exits with another code than 0 and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up runs from here to the window's first render

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"  # fixed, inside the checkout: later runs find what the first built


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(BENCH), str(ROOT)]

    from harness import guard, manifest
    from harness.cell import run_cell

    try:
        cell = manifest.load_cell(args.workload)
        guard.require_cards(cell.chips)
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                          log=print)
        # last, once the reference and every metric reader have run
        guard.require_no_jax()
    except guard.RunRefused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
