"""Executable `<test type="ttest"|"chi2test">` XML scenes.

Counterpart of `optix_renderer_tpu/validation/xmltest.py`, with a `device`
on which the BSDFs, the cameras and the integrators run. Semantics match
the reference executables:
- ttest BSDF mode (ttest.cpp:147-189): per BSDF × incidence angle, draw
  sampleCount importance samples, t-test the mean sample luminance (the
  `sample()` return value fr·cos/pdf) against the analytic reference.
- ttest scene mode (ttest.cpp:191-239): per <scene> child, shoot sampleCount
  random camera rays, t-test the mean Li luminance against the reference.
- chi2test (chi2test.cpp:131-270): per BSDF, `testCount` runs with random wi;
  histogram wo over a cosθ×φ contingency table; expected counts from
  numerically integrating pdf(); pooled χ² with Šidák battery correction.

Every uniform is drawn on the host by numpy in the JAX module's order
(`default_rng(0)`, or `default_rng(si)` per scene), so both packages see
the same samples. Luminances and histograms are formed in float64 numpy
from the device's float32 results, as the JAX module forms them. A scene
goes to the device once, and its lanes run in chunks of
`render.MAX_LANES`; on a CUDA device its intersections launch the kernels
of `csrc/isect.cu`.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from optix_renderer_tpu_torch.utils import hypothesis as hyp

_LUM = np.array([0.212671, 0.715160, 0.072169])  # color.h getLuminance


@dataclass
class TestReport:
    passed: int
    total: int
    messages: list
    # per test, in order: {"mean", "var", "n", "reference", "lum"} for a
    # t-test ("lum" the float64 sample luminances), {"observed",
    # "expected"} (float64 tables) for a χ² test
    details: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.passed == self.total and self.total > 0


def _floats(s: str) -> list[float]:
    return [float(x) for x in re.split(r"[\s,;]+", s.strip()) if x]


def run_xml_test(path_or_node, verbose: bool = True, sample_scale: float = 1.0,
                 device="cuda") -> TestReport:
    """Load and execute a <test> XML (the reference runs these on scene load,
    ttest.cpp:81-95 cloneAndInit → execute) on `device`. `sample_scale`
    shrinks sample counts for fast runs."""
    from optix_renderer_tpu_torch.render.render import resolve_device
    from optix_renderer_tpu_torch.scene.parser import SceneNode, load_from_xml

    device = resolve_device(device)
    node = path_or_node if isinstance(path_or_node, SceneNode) else load_from_xml(path_or_node)
    if node.tag != "test":
        raise ValueError(f"not a <test> scene (root <{node.tag}>)")
    if node.type == "ttest":
        report = _run_ttest(node, sample_scale, device)
    elif node.type == "chi2test":
        report = _run_chi2test(node, sample_scale, device)
    else:
        raise ValueError(f"unknown test type '{node.type}'")
    if verbose:
        for m in report.messages:
            print(m)
        print(f"Passed {report.passed}/{report.total} tests.")
    return report


def _bsdf_tables(nodes, origin, device):
    from optix_renderer_tpu_torch.scene.build import build_bsdf_table

    bsdfs, textures = build_bsdf_table(nodes, origin)
    return bsdfs.to(device), textures.to(device)


def _sample_bsdf(bsdfs, textures, bi: int, wi: np.ndarray, u2: np.ndarray, device):
    """`sample_bsdf` of row `bi` for one float32 `wi` [3] and uniforms `u2`
    [n,2] (float64, rounded to float32 as the JAX module rounds them)."""
    from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops

    n = u2.shape[0]
    wib = torch.as_tensor(wi, dtype=torch.float32, device=device).expand(n, 3)
    ids = torch.full((n,), bi, dtype=torch.int32, device=device)
    uv = torch.zeros((n, 2), device=device)
    u2 = torch.as_tensor(u2, dtype=torch.float32).to(device)
    return bsdf_ops.sample_bsdf(bsdfs, textures, ids, wib, uv, u2)


def _f64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# ttest
# ---------------------------------------------------------------------------


def _t_test(lum: np.ndarray, reference: float, significance: float, num_tests: int,
            details: list):
    mean = float(lum.mean())
    var = float(lum.var(ddof=1))
    details.append({"mean": mean, "var": var, "n": lum.shape[0], "reference": reference,
                    "lum": lum})
    return hyp.students_t_test(mean, var, lum.shape[0], reference, significance,
                               num_tests=num_tests)


def _run_ttest(node, sample_scale: float, device) -> TestReport:
    p = node.props
    significance = p.get_float("significanceLevel", 0.01)
    angles = _floats(p.get_string("angles", ""))
    references = _floats(p.get_string("references", ""))
    sample_count = max(16, int(p.get_integer("sampleCount", 100_000) * sample_scale))

    bsdf_nodes = node.children_of("bsdf")
    scene_nodes = node.children_of("scene")
    msgs, details, passed, total = [], [], 0, 0

    if bsdf_nodes:
        if scene_nodes:
            raise ValueError("cannot test BSDFs and scenes at the same time")
        if len(references) != len(angles) * len(bsdf_nodes):
            raise ValueError("mismatched angles/references counts")
        bsdfs, textures = _bsdf_tables(bsdf_nodes, node.origin, device)
        rng = np.random.default_rng(0)
        ctr = 0
        for bi in range(len(bsdf_nodes)):
            for angle in angles:
                reference = references[ctr]
                ctr += 1
                total += 1
                th = np.radians(angle)
                wi = np.array([np.sin(th), 0.0, np.cos(th)], np.float32)
                bs = _sample_bsdf(bsdfs, textures, bi, wi, rng.random((sample_count, 2)), device)
                ok, msg = _t_test(_f64(bs.weight) @ _LUM, reference, significance,
                                  len(references), details)
                passed += ok
                msgs.append(f"[{'PASS' if ok else 'FAIL'}] ttest bsdf#{bi} angle={angle}: {msg}")
    else:
        if len(references) != len(scene_nodes):
            raise ValueError("mismatched scenes/references counts")
        for si, sn in enumerate(scene_nodes):
            total += 1
            if not sn.origin:
                sn.origin = node.origin
            lum = _scene_luminances(sn, si, sample_count, device)
            ok, msg = _t_test(lum, references[si], significance, len(references), details)
            passed += ok
            msgs.append(f"[{'PASS' if ok else 'FAIL'}] ttest scene#{si}: {msg}")

    return TestReport(passed, total, msgs, details)


def _scene_luminances(scene_node, si: int, n: int, device) -> np.ndarray:
    """Luminance of Li · camera weight [n] (float64) of `n` random camera rays
    through the <scene> `scene_node`, the `si`-th of its test."""
    from optix_renderer_tpu_torch.integrators import get_integrator
    from optix_renderer_tpu_torch.ops import camera as cam_ops
    from optix_renderer_tpu_torch.render import sampler as smp
    from optix_renderer_tpu_torch.render.render import MAX_LANES, preprocess
    from optix_renderer_tpu_torch.scene.build import build_scene

    scene, config, _ = build_scene(scene_node, device)
    # the reference's path loop is unbounded with RR (ttest compares against
    # analytic series like 1/(1−a)); 16 bounces truncate an a=0.8 furnace
    # by a^16/(1−a) ≈ 3 %, so the depth is at least 64
    config = dataclasses.replace(config, max_depth=max(config.max_depth, 64))
    li = get_integrator(config.integrator)
    scene = preprocess(scene, config, device).to(device)
    rng = np.random.default_rng(si)
    pix = rng.random((n, 2)) * np.array([config.width, config.height])
    ap = rng.random((n, 2))
    lum = []
    for c0 in range(0, n, MAX_LANES):
        c1 = min(c0 + MAX_LANES, n)
        ray, weight = cam_ops.sample_ray(
            scene.camera, config.width, config.height,
            torch.as_tensor(pix[c0:c1], dtype=torch.float32).to(device),
            torch.as_tensor(ap[c0:c1], dtype=torch.float32).to(device))
        s = smp.make_sampler(torch.arange(c0, c1, device=device),
                             torch.full((c1 - c0,), si, dtype=torch.int64, device=device))
        L, _, _, _ = li(scene, config, ray, s)
        lum.append(_f64(L * weight) @ _LUM)
    return np.concatenate(lum)


# ---------------------------------------------------------------------------
# chi2test
# ---------------------------------------------------------------------------


def _gl_cell_integrals(
    pdf_fn, res: int, phi_res: int, order: int = 32, splits: int = 2
) -> np.ndarray:
    """∫ pdf d(cosθ)dφ per (cosθ, φ) cell via tensor Gauss–Legendre.

    `pdf_fn(dirs [..,3]) -> [..]` solid-angle density. Each cell is split
    `splits×splits` ways with an `order`-point GL rule per axis.
    """
    x, w = np.polynomial.legendre.leggauss(order)
    # nodes/weights for one axis subdivided into res*splits equal intervals
    def axis_nodes(lo, hi, n_int):
        edges = np.linspace(lo, hi, n_int + 1)
        half = 0.5 * (edges[1:] - edges[:-1])  # [n_int]
        mid = 0.5 * (edges[1:] + edges[:-1])
        nodes = mid[:, None] + half[:, None] * x[None, :]  # [n_int, order]
        weights = half[:, None] * w[None, :]
        return nodes.ravel(), weights.ravel()

    ct_n, ct_w = axis_nodes(-1.0, 1.0, res * splits)
    ph_n, ph_w = axis_nodes(0.0, 2 * np.pi, phi_res * splits)
    cc, pp = np.meshgrid(ct_n, ph_n, indexing="ij")
    ww = np.outer(ct_w, ph_w)
    ss = np.sqrt(np.maximum(1.0 - cc * cc, 0.0))
    dirs = np.stack([ss * np.cos(pp), ss * np.sin(pp), cc], axis=-1)
    vals = pdf_fn(dirs) * ww
    k = splits * order
    return vals.reshape(res, k, phi_res, k).sum(axis=(1, 3))


def _run_chi2test(node, sample_scale: float, device) -> TestReport:
    from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops

    p = node.props
    significance = p.get_float("significanceLevel", 0.01)
    res = p.get_integer("resolution", 10)
    phi_res = 2 * res
    min_exp = p.get_integer("minExpFrequency", 5)
    test_count = p.get_integer("testCount", 5)
    sample_count = p.get_integer("sampleCount", -1)
    if sample_count < 0:
        sample_count = res * phi_res * 5000  # chi2test.cpp:73-74
    sample_count = max(1024, int(sample_count * sample_scale))

    bsdf_nodes = node.children_of("bsdf")
    bsdfs, textures = _bsdf_tables(bsdf_nodes, node.origin, device)
    num_tests = test_count * len(bsdf_nodes)

    rng = np.random.default_rng(0)
    msgs, details, passed, total = [], [], 0, 0
    for bi in range(len(bsdf_nodes)):
        for _ in range(test_count):
            total += 1
            # random incident direction (chi2test.cpp:151-155)
            ct = rng.random()
            st = np.sqrt(max(0.0, 1.0 - ct * ct))
            ph = 2.0 * np.pi * rng.random()
            wi = np.array([np.cos(ph) * st, np.sin(ph) * st, ct], np.float32)

            # observed: histogram of wo over (cosθ, φ) cells
            bs = _sample_bsdf(bsdfs, textures, bi, wi, rng.random((sample_count, 2)), device)
            wo = _f64(bs.wo)
            w = _f64(bs.weight)
            valid = (np.abs(w) > 0).any(axis=-1)
            wo = wo[valid]
            ci = np.clip(np.floor((wo[:, 2] * 0.5 + 0.5) * res).astype(int), 0, res - 1)
            sphi = np.arctan2(wo[:, 1], wo[:, 0]) / (2 * np.pi)
            sphi = np.where(sphi < 0, sphi + 1.0, sphi)
            pi_ = np.clip(np.floor(sphi * phi_res).astype(int), 0, phi_res - 1)
            observed = np.zeros((res, phi_res))
            np.add.at(observed, (ci, pi_), 1.0)

            # expected: per-cell tensor Gauss–Legendre integral of the pdf
            # (the adaptiveSimpson2D analog, chi2test.cpp:186-213), the pdf
            # in one float32 call on the device, the sums in float64 numpy
            def pdf_fn(dirs, bi=bi, wi=wi):
                m = torch.as_tensor(dirs.reshape(-1, 3).astype(np.float32)).to(device)
                k = m.shape[0]
                pdf = bsdf_ops.pdf_bsdf(
                    bsdfs, textures, torch.full((k,), bi, dtype=torch.int32, device=device),
                    torch.as_tensor(wi, device=device).expand(k, 3), m,
                    torch.zeros((k, 2), device=device))
                return _f64(pdf).reshape(dirs.shape[:-1])

            expected = _gl_cell_integrals(pdf_fn, res, phi_res) * sample_count
            details.append({"observed": observed, "expected": expected})

            ok, msg = hyp.chi2_merge_and_test(
                observed, expected, sample_count, min_exp_frequency=min_exp,
                significance=significance, num_tests=num_tests)
            passed += ok
            msgs.append(f"[{'PASS' if ok else 'FAIL'}] chi2 bsdf#{bi}: {msg}")

    return TestReport(passed, total, msgs, details)
