"""Scene intake of the port against the JAX package.

The port's numpy builder and `scene_from_numpy` (the JAX scene carried
across) must both pack the path-kernel tables of the JAX package's
`build_pathk_tables` (VPU branch) to atol 1e-6, and the medium branch's
tables must hold the fields of the JAX MXU branch's `attr` / `etc` tables;
`sample_to_camera_matrix` agrees to 1e-6; what the port cannot render yet
raises; `render()` dispatches every scene of a matrix of surface features
and media as the JAX package does (`pathk_eligible`).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.camera import sample_to_camera_matrix as j_s2c
from optix_renderer_tpu.ops.pallas import pathk as jpathk
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.ops.camera import sample_to_camera_matrix
from optix_renderer_tpu_torch.ops.cuda import mega, pathk
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import SceneBuildError, scene_from_numpy

# port table name → JAX table name
TABLES = {"tri": "tri", "et": "et_smem", "em_rows": "em_rows", "env": "env",
          "sph": "sph", "scal_f": "scal_f"}

LIGHTS = {
    "point": '<emitter type="point"><point name="position" value="0 1.8 1"/>'
             '<color name="power" value="80 70 60"/></emitter>',
    "spot": '<emitter type="spot"><point name="position" value="0 1.8 1"/>'
            '<vector name="direction" value="0 -1 -0.5"/><color name="power" value="60 50 40"/>'
            '<float name="falloffstart" value="15"/><float name="totalwidth" value="30"/></emitter>',
    "directional": '<emitter type="directional"><vector name="direction" value="-0.3 -1 -0.4"/>'
                   '<color name="radiance" value="40 36 30"/><float name="angle" value="5"/>'
                   '</emitter>',
}


def room_xml(tmp_path, light: str, width=20, height=14, extra="") -> str:
    """Diffuse floor + back wall room lit by `light` (the rooms of
    tests/test_mega.py:235-267), written as XML + OBJ files."""
    presets.write_quad_obj(tmp_path, "floor", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)])
    presets.write_quad_obj(tmp_path, "back", [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)])
    xml = f"""<scene><integrator type="path_mis"/>
<camera type="perspective"><integer name="width" value="{width}"/>
<integer name="height" value="{height}"/><float name="fov" value="40"/>
<transform name="toWorld"><lookat origin="0 1.0 4.3" target="0 1.0 0" up="0 1 0"/></transform>
</camera>
<shape type="obj"><string name="filename" value="floor.obj"/><bsdf type="diffuse"/></shape>
<shape type="obj"><string name="filename" value="back.obj"/><bsdf type="diffuse"/></shape>
{extra}{light}</scene>"""
    path = tmp_path / "room.xml"
    path.write_text(xml)
    return str(path)


def _compare_tables(jscene, jconfig, tscene, tconfig):
    jt, jm = jpathk.build_pathk_tables(jscene, jconfig)
    for scene in (tscene, scene_from_numpy(jax.tree.map(np.asarray, jscene))):
        tt, tm = pathk.build_pathk_tables(scene, tconfig)
        for name, jname in TABLES.items():
            ref = np.asarray(jt[jname])
            got = tt[name].numpy()[: ref.shape[0]] if name == "et" else tt[name].numpy()
            np.testing.assert_allclose(got, ref.reshape(got.shape), atol=1e-6, rtol=0,
                                       err_msg=name)
        shared = set(tm) & set(jm)
        assert {k: tm[k] for k in shared} == {k: jm[k] for k in shared}
        assert (tm["t_cnt"] > pathk.VPU_MAX_TRIS) == jm["use_mxu"]


def test_cornell_tables_match_jax():
    js, jc, _ = jpresets.make_cornell_box(width=40, height=30, spp=1)
    ts, tc, _ = presets.make_cornell_box(width=40, height=30, spp=1, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _compare_tables(js, jc, ts, tc)


@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_room_tables_match_jax(tmp_path, kind):
    xml = room_xml(tmp_path, LIGHTS[kind])
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    _compare_tables(js, jc, ts, tc)


# port column of the [T, 48] triangle rows → JAX column of the MXU `attr` table
_ATTR_OF_TRI = {**{c: 30 + c for c in range(9)}, **{9 + c: c for c in range(12)},
                **{21 + c: 18 + c for c in range(12)}, **{33 + c: 40 + c for c in range(10)}}


def test_medium_tables_match_jax_mxu_branch():
    js, jc, _ = jpresets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7)
    ts, tc, _ = presets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7, device="cpu")
    jt, jm = jpathk.build_pathk_tables(js, jc)
    tt, tm = pathk.build_pathk_tables(ts, tc)
    assert jm["use_mxu"] and tm["t_cnt"] == jm["t_cnt"] == 300 > pathk.VPU_MAX_TRIS
    attr = np.asarray(jt["attr"]).T  # [Tpad, 56]
    tri = tt["tri"].numpy()
    for c, jc_ in _ATTR_OF_TRI.items():
        np.testing.assert_allclose(tri[:, c], attr[:300, jc_], atol=1e-6, rtol=0, err_msg=str(c))
    np.testing.assert_allclose(tt["et"].numpy(), np.asarray(jt["etc"]), atol=1e-6, rtol=0)
    assert tm["te_pad"] == np.asarray(jt["etc"]).shape[0] and tm["te_cnt"] == jm["te_cnt"]
    for name in ("em_rows", "env", "sph"):
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(jt[name]).reshape(
            tuple(tt[name].shape)), atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(tt["scal_f"].numpy(), np.asarray(jt["scal_f"])[0], atol=1e-6)


def test_sample_to_camera_matrix_matches_jax():
    js, _, _ = jpresets.make_cornell_box(width=40, height=30, spp=1)
    ts, _, _ = presets.make_cornell_box(width=40, height=30, spp=1, device="cpu")
    for w, h in ((800, 600), (64, 48), (17, 31)):
        ref = np.asarray(j_s2c(js.camera, w, h))
        np.testing.assert_allclose(sample_to_camera_matrix(ts.camera, w, h).numpy(), ref,
                                   rtol=1e-6, atol=1e-6)


def test_unsupported_scenes_raise(tmp_path):
    """A root other than `<scene>` or `<test>` raises; a `<test>` root, once
    refused, builds as in the JAX builder (`validation/xmltest.py` runs
    its test); a scene `<denoiser>`, once refused, lands in
    the config with its properties, as in the JAX builder
    (tests/test_io_scene.py:162-183); a medium and a sphere-area emitter,
    once refused, now build and render on the CPU (through the scan path),
    and a JAX scene with a medium carries across."""
    from optix_renderer_tpu_torch.render.render import render

    test_root = tmp_path / "t.xml"
    test_root.write_text('<test type="ttest"><integer name="sampleCount" value="4"/></test>')
    _, config, _ = build.load_scene(test_root, device="cpu")
    _, jconfig, _ = jbuild.load_scene(test_root)
    assert (config.width, config.height, config.integrator, config.sample_count) == (
        jconfig.width, jconfig.height, jconfig.integrator, jconfig.sample_count)
    bsdf_root = tmp_path / "b.xml"
    bsdf_root.write_text('<bsdf type="diffuse"/>')
    with pytest.raises(SceneBuildError, match="root must be <scene> or <test>"):
        build.load_scene(bsdf_root, device="cpu")
    den = ('<denoiser type="simple"><float name="sigma_d" value="6.0"/>'
           '<float name="sigma_vr" value="1.5"/><integer name="range" value="7"/></denoiser>')
    _, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=den), device="cpu")
    _, jconfig, _ = jbuild.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=den))
    assert config.denoiser == "simple" and config.dprops == jconfig.dprops
    assert (config.dprop("sigma_d"), config.dprop("sigma_vr"), config.dprop("range")) == (
        6.0, 1.5, 7)
    _, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra="<denoiser/>"),
                                    device="cpu")
    assert config.denoiser == "simple" and config.dprops == ()
    medium = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
              '<float name="radius" value="0.3"/>'
              '<medium type="homog" name="interior"><color name="sigma_s" value="1 1 1"/>'
              '</medium></shape>')
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=medium),
                                        device="cpu")
    assert scene.shapes.interior_medium.tolist() == [-1, -1, 0] and scene.shapes.bsdf[2] == -1
    assert not pathk.pathk_eligible(scene, config)
    out = render(scene, dataclasses.replace(config, width=8, height=6, max_depth=3,
                                            integrator="path_vol_mis"),
                 sample_count=1, device="cpu")
    assert np.isfinite(out["composite"]).all() and out["composite"].mean() > 0
    sphere_light = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
                    '<float name="radius" value="0.3"/>'
                    '<emitter type="area"><color name="radiance" value="1 1 1"/></emitter></shape>')
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=sphere_light),
                                        device="cpu")
    assert scene.emitters.geom_kind.tolist() == [2, 0] and scene.emitters.sphere_id[0] == 0
    assert not pathk.pathk_eligible(scene, config)
    out = render(scene, dataclasses.replace(config, width=8, height=6, max_depth=3),
                 sample_count=1, device="cpu")
    assert np.isfinite(out["composite"]).all() and out["composite"].mean() > 0
    jscene, _, _ = jpresets.make_absorbing_sphere(width=8, height=8, spp=1)
    carried = scene_from_numpy(jax.tree.map(np.asarray, jscene))
    assert carried.media.type.tolist() == [1] and carried.shapes.interior_medium.tolist() == [0]


def test_render_refuses_what_the_kernel_does_not_cover(tmp_path):
    """A 70-triangle strip takes the path kernel's medium branch (the JAX
    kernel's MXU branch); what the path kernel does not cover, the mitchell
    filter or the `direct_mis` integrator, takes the scan path; all render
    on the CPU. An adaptive config takes the scan path and renders there
    uniformly, as the JAX `render()` does: bit for bit the `mega=False`
    render."""
    from optix_renderer_tpu_torch.render.render import render

    # a 66-triangle strip (70 in all): the medium branch
    verts = [(x, 0.0, -1.0 + 0.1 * k) for k in range(34) for x in (-1.0, 1.0)]
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"f {2 * k + 1} {2 * k + 2} {2 * k + 4} {2 * k + 3}" for k in range(33)]
    (tmp_path / "strip.obj").write_text("\n".join(lines) + "\n")
    extra = '<shape type="obj"><string name="filename" value="strip.obj"/></shape>'
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=extra),
                                        device="cpu")
    assert config.n_tris == 70
    assert mega.mega_eligible(scene, config) and pathk.pathk_eligible(scene, config)
    small = dataclasses.replace(config, width=8, height=6, max_depth=3)
    assert pathk.build_pathk_tables(scene, small)[1]["t_cnt"] > pathk.VPU_MAX_TRIS
    out = render(scene, small, sample_count=1, device="cpu")
    # the path kernel's film: `weights` counts samples (the splat film sums filter weights)
    assert out["weights"].shape == (6, 8) and (out["weights"] == 1.0).all()
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"]), device="cpu")
    assert pathk.pathk_eligible(scene, config)
    mitchell = dataclasses.replace(config, width=8, height=6, max_depth=3, rfilter="mitchell")
    assert not pathk.pathk_eligible(scene, mitchell)
    out = render(scene, mitchell, sample_count=1, device="cpu")
    assert (out["weights"] > 0).all() and np.isfinite(out["composite"]).all()
    direct = dataclasses.replace(config, width=8, height=6, integrator="direct_mis")
    assert not pathk.pathk_eligible(scene, direct)
    out = render(scene, direct, sample_count=1, device="cpu")
    assert (out["weights"] > 0).all() and np.isfinite(out["composite"]).all()
    small = dataclasses.replace(config, width=8, height=6, max_depth=3)
    adaptive = dataclasses.replace(small, adaptive=True)
    assert pathk.pathk_eligible(scene, small) and not pathk.pathk_eligible(scene, adaptive)
    out = render(scene, adaptive, sample_count=2, device="cpu")
    ref = render(scene, small, sample_count=2, device="cpu", mega=False)
    for k in ("composite", "albedo", "normal", "weights"):
        assert np.array_equal(out[k], ref[k]), k


def _dispatch_scene(tmp_path, kind):
    """A room (or the Cornell box) with one surface feature of the dispatch matrix."""
    from optix_renderer_tpu_torch.utils.imageio import encode_png, write_exr

    rng = np.random.default_rng(7)
    tex = tmp_path / "tex.png"
    tex.write_bytes(encode_png(rng.uniform(size=(8, 8, 3)).astype(np.float32)))
    write_exr(tmp_path / "env.exr", rng.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32))
    light, extra, cfg = LIGHTS["point"], "", {}
    if kind == "no_emitters":
        light = ""
    elif kind == "sphere_light":
        extra = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
                 '<float name="radius" value="0.3"/><emitter type="area">'
                 '<color name="radiance" value="1 1 1"/></emitter></shape>')
    elif kind == "checker":
        extra = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
                 '<float name="radius" value="0.3"/><bsdf type="diffuse">'
                 '<texture type="checkerboard_color" name="albedo"/></bsdf></shape>')
    elif kind == "normal_map":
        extra = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
                 '<float name="radius" value="0.3"/><texture type="png_texture" name="normal">'
                 '<string name="filename" value="tex.png"/></texture></shape>')
    elif kind == "image_envmap":
        light += ('<emitter type="envmap"><texture type="png_texture">'
                  '<string name="filename" value="env.exr"/></texture></emitter>')
    elif kind == "mitchell":
        cfg = {"rfilter": "mitchell"}
    elif kind == "direct_mis":
        cfg = {"integrator": "direct_mis"}
    elif kind == "medium_sphere":
        extra = ('<shape type="sphere"><point name="center" value="0 1 0"/>'
                 '<float name="radius" value="0.3"/><medium type="homog" name="interior">'
                 '<color name="sigma_s" value="1 1 1"/></medium></shape>')
    elif kind == "path_vol_mis":
        cfg = {"integrator": "path_vol_mis"}
    elif kind == "ambient_medium":
        extra = '<medium type="homog"><color name="sigma_s" value="0.1 0.1 0.1"/></medium>'
    if kind == "cornell":
        from optix_renderer_tpu_torch.scene.presets import cornell_box_xml

        return str(cornell_box_xml(tmp_path, 20, 14, 1)), cfg
    return room_xml(tmp_path, light, extra=extra), cfg


@pytest.mark.parametrize("kind", ["no_emitters", "sphere_light", "checker", "normal_map",
                                  "image_envmap", "mitchell", "direct_mis", "cornell",
                                  "medium_sphere", "path_vol_mis", "ambient_medium"])
def test_dispatch_matches_jax(tmp_path, kind):
    """The port's `pathk_eligible` (and the reason behind it) against the JAX
    package's on the same XML, built by each builder and carried across.
    Both builders pad an empty emitter table with one dark point light, so a
    scene lit by nothing still takes the path kernel in both."""
    xml, cfg = _dispatch_scene(tmp_path, kind)
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    jc, tc = dataclasses.replace(jc, **cfg), dataclasses.replace(tc, **cfg)
    want = jpathk.pathk_eligible(js, jc)
    assert want == (kind in ("no_emitters", "cornell"))
    assert pathk.pathk_eligible(ts, tc) == want
    assert pathk.pathk_eligible(scene_from_numpy(jax.tree.map(np.asarray, js)), tc) == want
    reason = pathk.pathk_unsupported(ts, tc)
    assert (reason is None) == want
    if not want:
        word = {"sphere_light": "sphere-area", "checker": "texture", "normal_map": "normal map",
                "image_envmap": "environment map", "mitchell": "mitchell",
                "direct_mis": "direct_mis", "medium_sphere": "media",
                "path_vol_mis": "path_vol_mis", "ambient_medium": "media"}[kind]
        assert word in reason, reason
