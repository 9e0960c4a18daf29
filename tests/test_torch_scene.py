"""Scene intake of the port against the JAX package.

The port's numpy builder and `scene_from_numpy` (the JAX scene carried
across) must both pack the path-kernel tables of the JAX package's
`build_pathk_tables` (VPU branch) to atol 1e-6; `sample_to_camera_matrix`
agrees to 1e-6; what the port cannot render yet raises.
"""

import dataclasses

import numpy as np
import jax
import pytest

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
            ref = np.asarray(jt[jname]).reshape(tuple(tt[name].shape))
            np.testing.assert_allclose(tt[name].numpy(), ref, atol=1e-6, rtol=0, err_msg=name)
        assert {k: tm[k] for k in tm} == {k: jm[k] for k in tm}


def test_cornell_tables_match_jax():
    js, jc, _ = jpresets.make_cornell_box(width=40, height=30, spp=1)
    ts, tc, _ = presets.make_cornell_box(width=40, height=30, spp=1)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _compare_tables(js, jc, ts, tc)


@pytest.mark.parametrize("kind", sorted(LIGHTS))
def test_room_tables_match_jax(tmp_path, kind):
    xml = room_xml(tmp_path, LIGHTS[kind])
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml)
    _compare_tables(js, jc, ts, tc)


def test_sample_to_camera_matrix_matches_jax():
    js, _, _ = jpresets.make_cornell_box(width=40, height=30, spp=1)
    ts, _, _ = presets.make_cornell_box(width=40, height=30, spp=1)
    for w, h in ((800, 600), (64, 48), (17, 31)):
        ref = np.asarray(j_s2c(js.camera, w, h))
        np.testing.assert_allclose(sample_to_camera_matrix(ts.camera, w, h).numpy(), ref,
                                   rtol=1e-6, atol=1e-6)


def test_unsupported_scenes_raise(tmp_path):
    medium = ('<shape type="sphere"><float name="radius" value="0.3"/>'
              '<medium type="homog" name="interior"/></shape>')
    with pytest.raises(SceneBuildError, match="item 9"):
        build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=medium))
    sphere_light = ('<shape type="sphere"><float name="radius" value="0.3"/>'
                    '<emitter type="area"><color name="radiance" value="1 1 1"/></emitter></shape>')
    with pytest.raises(SceneBuildError, match="sphere-area"):
        build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=sphere_light))
    # the same refusal for a JAX scene carried across
    jscene, _, _ = jpresets.make_absorbing_sphere(width=8, height=8, spp=1)
    with pytest.raises(SceneBuildError, match="media"):
        scene_from_numpy(jax.tree.map(np.asarray, jscene))


def test_render_refuses_what_the_kernel_does_not_cover(tmp_path):
    from optix_renderer_tpu_torch.render.render import render

    # a 66-triangle strip (70 in all): the MXU branch of the JAX kernel, ROADMAP slice 2
    verts = [(x, 0.0, -1.0 + 0.1 * k) for k in range(34) for x in (-1.0, 1.0)]
    lines = [f"v {x} {y} {z}" for x, y, z in verts]
    lines += [f"f {2 * k + 1} {2 * k + 2} {2 * k + 4} {2 * k + 3}" for k in range(33)]
    (tmp_path / "strip.obj").write_text("\n".join(lines) + "\n")
    extra = '<shape type="obj"><string name="filename" value="strip.obj"/></shape>'
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=extra))
    assert config.n_tris == 70
    assert mega.mega_eligible(scene, config) and not pathk.pathk_eligible(scene, config)
    with pytest.raises(NotImplementedError, match="slice 2"):
        render(scene, config, sample_count=1, device="cpu")
    scene, config, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"]))
    assert pathk.pathk_eligible(scene, config)
    with pytest.raises(NotImplementedError, match="mitchell"):
        render(scene, dataclasses.replace(config, rfilter="mitchell"), device="cpu")
    with pytest.raises(NotImplementedError, match="integrator"):
        render(scene, dataclasses.replace(config, integrator="direct_mis"), device="cpu")
