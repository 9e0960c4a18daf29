"""The port's executable `<test>` scenes (`validation/xmltest.py`) against
the JAX package's, on the CPU, on XMLs written into `tmp_path` (the JAX
xmltest tests read reference scenes that are not in the repo).

Both packages draw every uniform from the same numpy generators in the same
order, so they see the same samples:
* BSDF-mode t-test (diffuse, microfacet at α 0.1 and 0.4, glass; 0–80°):
  the per-test means to 1e-5 relative, the same verdicts;
* χ² test (microfacet α 0.1): the observed tables equal, the expected
  tables within 1e-6 relative, the same verdicts;
* scene-mode t-test (24×16 furnaces: a 168-triangle sphere, the
  brute-force sweep, and a 264-triangle sphere, the LBVH walk) at
  sample_scale 0.01: each lane's luminance within 1e-5 absolute (a lane's
  luminance depends on the face its ray hits), the means within 1e-3
  relative, the same verdicts;
* `build_bsdf_table` row for row, and the errors of a bad test.
The JAX means are read by wrapping its `hypothesis` calls."""

import numpy as np
import jax
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene.parser import load_from_string as jload_from_string
from optix_renderer_tpu.validation import xmltest as jxmltest
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import scene_from_numpy
from optix_renderer_tpu_torch.scene.parser import load_from_string
from optix_renderer_tpu_torch.validation import run_xml_test

ANGLES = "0, 30, 60, 80"
# ∫ f·cosθo dωo per BSDF and angle: diffuse 0.5; the microfacets by the
# Gauss–Legendre rule of `_gl_cell_integrals` over `eval_bsdf`; glass
# F + (1 − F)·(intIOR / extIOR)²
REFERENCES = (
    "0.5, 0.5, 0.5, 0.5, 0.520270, 0.521159, 0.545786, 0.660184, "
    "0.520360, 0.521504, 0.534155, 0.573182, 2.211388, 2.209454, 2.149088, 1.772182")


def _run_jax(path, scale, monkeypatch):
    """The JAX report and what it handed to its t / χ² tests, in order."""
    seen = []
    t_test, chi2 = jxmltest.hyp.students_t_test, jxmltest.hyp.chi2_merge_and_test

    def t_rec(mean, var, n, ref, *a, **k):
        seen.append({"mean": mean, "var": var, "n": n, "reference": ref})
        return t_test(mean, var, n, ref, *a, **k)

    def chi2_rec(observed, expected, *a, **k):
        seen.append({"observed": observed, "expected": expected})
        return chi2(observed, expected, *a, **k)

    monkeypatch.setattr(jxmltest.hyp, "students_t_test", t_rec)
    monkeypatch.setattr(jxmltest.hyp, "chi2_merge_and_test", chi2_rec)
    report = jxmltest.run_xml_test(path, verbose=False, sample_scale=scale)
    monkeypatch.undo()
    return report, seen


def _verdicts(report):
    return [m.split("]")[0] for m in report.messages]


def test_bsdf_ttest_matches_jax(tmp_path, monkeypatch):
    xml = presets.test_xml(tmp_path, "ttest_bsdf.xml", "ttest",
                           {"angles": ANGLES, "references": REFERENCES, "sampleCount": 100_000},
                           presets.TTEST_BSDFS)
    rep = run_xml_test(xml, verbose=False, sample_scale=0.05, device="cpu")
    jrep, jseen = _run_jax(xml, 0.05, monkeypatch)
    assert rep.ok and jrep.ok and (rep.passed, rep.total) == (jrep.passed, 16)
    assert _verdicts(rep) == _verdicts(jrep)
    for d, j in zip(rep.details, jseen, strict=True):
        assert d["n"] == j["n"] == 5000 and d["reference"] == j["reference"]
        np.testing.assert_allclose(d["mean"], j["mean"], rtol=1e-5)
        np.testing.assert_allclose(d["var"], j["var"], rtol=1e-4)


def test_chi2test_matches_jax(tmp_path, monkeypatch):
    xml = presets.test_xml(tmp_path, "chi2.xml", "chi2test", {"resolution": 10, "testCount": 2},
                           presets.TTEST_BSDFS[1:2])
    rep = run_xml_test(xml, verbose=False, sample_scale=0.05, device="cpu")
    jrep, jseen = _run_jax(xml, 0.05, monkeypatch)
    assert rep.ok and jrep.ok and rep.total == 2
    assert _verdicts(rep) == _verdicts(jrep)
    for d, j in zip(rep.details, jseen, strict=True):
        np.testing.assert_array_equal(d["observed"], j["observed"])
        np.testing.assert_allclose(d["expected"], j["expected"], rtol=1e-6)
        assert d["observed"].sum() == 50_000


def test_scene_ttest_matches_jax(tmp_path, monkeypatch):
    """Furnaces whose exact mean luminance is the albedo 0.75: a 168- and a
    264-triangle sphere. The JAX lanes' L and camera weights are read by
    wrapping its integrator and `sample_ray`."""
    import optix_renderer_tpu.integrators as jinteg
    import optix_renderer_tpu.ops.camera as jcam

    xml = presets.test_xml(tmp_path, "ttest_scene.xml", "ttest",
                           {"references": "0.75, 0.75", "sampleCount": 100_000},
                           [presets.furnace_scene(tmp_path, nu=12, nv=8),
                            presets.furnace_scene(tmp_path, nu=12, nv=12)])
    scenes = load_from_string(xml.read_text()).children_of("scene")
    for sn, n_tris in zip(scenes, (168, 264)):
        sn.origin = str(tmp_path)
        _, config, _ = build.build_scene(sn, device="cpu")
        assert config.n_tris == n_tris
    rep = run_xml_test(xml, verbose=False, sample_scale=0.01, device="cpu")

    lanes, weights = [], []
    get_integrator, sample_ray = jinteg.get_integrator, jcam.sample_ray

    def get_rec(name):
        li = get_integrator(name)

        def li_rec(*a, **k):
            out = li(*a, **k)
            lanes.append(np.asarray(out[0]))
            return out
        return li_rec

    def ray_rec(*a, **k):
        ray, weight = sample_ray(*a, **k)
        weights.append(np.asarray(weight))
        return ray, weight

    monkeypatch.setattr(jinteg, "get_integrator", get_rec)
    monkeypatch.setattr(jcam, "sample_ray", ray_rec)
    jrep, jseen = _run_jax(xml, 0.01, monkeypatch)
    assert rep.ok and jrep.ok and rep.total == 2
    assert _verdicts(rep) == _verdicts(jrep)
    for d, j, L, wgt in zip(rep.details, jseen, lanes, weights, strict=True):
        assert d["n"] == j["n"] == 1000 and d["var"] > 0
        np.testing.assert_allclose(d["lum"], (L * wgt).astype(np.float64) @ jxmltest._LUM,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(d["mean"], j["mean"], rtol=1e-3)


def test_build_bsdf_table_matches_jax(tmp_path):
    """Row i of the tables comes from node i, as in the JAX builder; with
    textures (a checkerboard albedo) and every BSDF type."""
    nodes = list(presets.TTEST_BSDFS) + [
        '<bsdf type="diffuse"><texture type="checkerboard_color" name="albedo">'
        '<color name="value1" value="0.1 0.2 0.3"/></texture></bsdf>',
        '<bsdf type="mirror"/>',
        '<bsdf type="disney"><float name="roughness" value="0.3"/></bsdf>']
    bsdfs, textures = build.build_bsdf_table([load_from_string(n) for n in nodes], tmp_path)
    jb, jt = jbuild.build_bsdf_table([jload_from_string(n) for n in nodes], tmp_path)
    for ours, theirs in ((bsdfs, jb), (textures, jt)):
        for name in theirs._fields:
            np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                          np.asarray(getattr(theirs, name)), err_msg=name)
    assert bsdfs.type.shape[0] == len(nodes)


def test_bad_tests_raise(tmp_path):
    bad = tmp_path / "bad.xml"
    bad.write_text('<test type="nosuch"/>')
    with pytest.raises(ValueError, match="unknown test type"):
        run_xml_test(bad, verbose=False, device="cpu")
    scene = tmp_path / "scene.xml"
    scene.write_text("<scene/>")
    with pytest.raises(ValueError, match="not a <test>"):
        run_xml_test(scene, verbose=False, device="cpu")
    mism = presets.test_xml(tmp_path, "m.xml", "ttest", {"angles": "0", "references": "1, 2"},
                            presets.TTEST_BSDFS[:1])
    with pytest.raises(ValueError, match="mismatched"):
        run_xml_test(mism, verbose=False, device="cpu")
    # a <test> root builds in both packages as a scene of defaults
    scene, config, _ = build.load_scene(mism, device="cpu")
    jscene, jconfig, _ = jbuild.load_scene(mism)
    assert (config.width, config.height) == (jconfig.width, jconfig.height)
    carried = scene_from_numpy(jax.tree.map(np.asarray, jscene))
    np.testing.assert_array_equal(carried.bsdfs.type.numpy(), scene.bsdfs.type.numpy())
