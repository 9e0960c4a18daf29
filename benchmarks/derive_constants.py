"""Derive a configuration's frozen work constants with the plain reference.

    python benchmarks/derive_constants.py cbox-path-mis [--seeds 3] [--device cuda]

Prints, for a configuration whose estimator is the path kernel's, the
closest-hit segments per camera path over whole renders at 1 sample per
pixel, one per seed: the `segments_per_path` of its `work`. Run once, when
the constant is set; the benchmark's runs only read it.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import torch

    from harness import manifest
    from reference import pathtrace

    m = manifest.load_manifest()
    cfg = [c for c in m["configs"] if c["name"] == args.config][0]
    cfg = json.loads((manifest.ROOT / cfg["file"]).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        xml = manifest.resolve(cfg["writer"])(tmp, **cfg["scene"])
        S = pathtrace.load_scene(xml, args.device)
        S.max_depth = cfg["max_depth"]
        n = S.width * S.height
        pix = torch.arange(n, device=args.device)
        out = []
        for seed in range(1, args.seeds + 1):
            counts = {}
            with torch.no_grad():
                pathtrace.trace_pathk(S, pix, torch.zeros_like(pix), seed, counts)
            out.append(counts["segments"] / n)
    print(json.dumps({"config": args.config, "segments_per_path": out,
                      "mean": sum(out) / len(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
