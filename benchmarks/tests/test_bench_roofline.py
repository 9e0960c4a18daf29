"""The roofline constants against the repository's own counts (chip_smoke.py `bound()`)."""

import ast
import json

import pytest

from harness import manifest, roofline


def _constants(path, names):
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and node.targets[0].id in names:
            out[node.targets[0].id] = node.value
    return out


def test_peaks_and_operation_counts_are_the_repositorys():
    tools = _constants(manifest.ROOT / "optix_renderer_tpu_torch" / "tools" / "time_isect.py",
                       {"PEAK_FP32", "PEAK_BYTES", "OPS_MT", "OPS_RAY", "RAY_BYTES"})
    smoke = _constants(manifest.ROOT / "chip_smoke.py", {"OPS_SLAB", "OPS_SPHERE"})
    got = {k: ast.literal_eval(v) for k, v in tools.items()}
    got["OPS_SLAB"] = ast.literal_eval(smoke["OPS_SLAB"])
    got["OPS_SPHERE"] = ast.literal_eval(smoke["OPS_SPHERE"])
    for k, v in got.items():
        assert getattr(roofline, k) == v, k


def test_pathk_work_is_chip_smokes_bound_at_the_same_inputs():
    # chip_smoke.py phase 5: iterations x (t_cnt x OPS_MT + n_sph x OPS_SPHERE + 5);
    # 23,369,472 iterations of an 800x600 16-spp launch gave 0.2466 ms (PERF.md row 1)
    iters, paths = 23_369_472, 800 * 600 * 16
    work = {"triangles": 12, "spheres": 2, "segments_per_path": iters / paths,
            "pathk_out_bytes": 64}
    ops, nbytes = roofline.pathk_work(work, paths, 800 * 600)
    assert ops == pytest.approx(iters * (12 * 52 + 2 * 39 + 5))
    assert roofline.bound_s(ops, nbytes)[0] * 1e3 == pytest.approx(0.2466, abs=5e-5)


def test_isect_bvh_work_is_chip_smokes_walk_bound_at_the_same_inputs():
    # chip_smoke.py phase 8 walk_bound: nodes x OPS_SLAB + leaves x 4 x (OPS_MT + 1)
    # + rays x OPS_RAY; PERF.md row 4: 0.0186 ms on 480,000 camera rays, 0.0233 on bounce rays,
    # from counts that the table gives to three digits (so within 1e-4 ms)
    rays = 480_000
    for nodes, leaves, ms in ((72.4, 3.65, 0.0186), (90.3, 4.61, 0.0233)):
        ops = rays * roofline.bvh_ray_ops(nodes, leaves)
        assert ops == pytest.approx(rays * (nodes * 25 + leaves * 4 * 53 + 9))
        assert roofline.bound_s(ops, rays * 48)[0] * 1e3 == pytest.approx(ms, abs=1e-4)


def test_the_scan_configs_rays_per_render_follow_its_shape():
    cfg = json.loads((manifest.ROOT / "benchmarks/configs/tess-cornell-100k.json").read_text())
    spp = json.loads((manifest.ROOT / "benchmarks/traffic/scan-4spp.json").read_text())["spp"]
    lanes = cfg["scene"]["width"] * cfg["scene"]["height"]
    kinds = cfg["work"]["isect_bvh"]
    assert kinds["closest_camera"]["rays_per_render"] == lanes * spp
    assert kinds["closest_bounce"]["rays_per_render"] == lanes * spp * (cfg["max_depth"] - 1)
    assert kinds["any_shadow"]["rays_per_render"] == lanes * spp * cfg["max_depth"]
