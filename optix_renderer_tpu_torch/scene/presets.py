"""Cornell-box presets, as XML + OBJ files.

Counterpart of `optix_renderer_tpu/scene/presets.py: make_cornell_box`
(presets.py:27-104) and `make_tessellated_cornell` (presets.py:188-289):
the same walls, albedos, light, spheres and camera. Here each scene is
written as an XML file with OBJ meshes and loaded through `scene.build`, so
the presets, the CLI and the tests share one path; the `make_*` functions
write into a temporary directory that they remove again.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

# box walls: floor, ceiling, back, left, right (inward-facing windings)
_QUADS = {
    "floor": [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)],
    "ceiling": [(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)],
    "back": [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)],
    "left": [(-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1)],
    "right": [(1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)],
    "light": [(-0.4, 1.99, -0.4), (0.4, 1.99, -0.4), (0.4, 1.99, 0.4), (-0.4, 1.99, 0.4)],
}
_ALBEDO = {
    "floor": (0.725, 0.71, 0.68),
    "ceiling": (0.725, 0.71, 0.68),
    "back": (0.725, 0.71, 0.68),
    "left": (0.63, 0.065, 0.05),
    "right": (0.14, 0.45, 0.091),
    "light": (0.8, 0.8, 0.8),
}


def _vec(v) -> str:
    return " ".join(str(x) for x in v)


def write_quad_obj(dirpath: Path, name: str, verts) -> str:
    """Write a one-quad OBJ (two triangles) into dirpath; returns its file name."""
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts] + ["f 1 2 3 4"]
    (Path(dirpath) / f"{name}.obj").write_text("\n".join(lines) + "\n")
    return f"{name}.obj"


def _header(width, height, spp, integrator, rfilter) -> list[str]:
    rf = f'<rfilter type="{rfilter}"/>' if rfilter else ""
    return [
        "<scene>",
        f'<integrator type="{integrator}"/>',
        '<camera type="perspective">',
        f'<integer name="width" value="{width}"/>',
        f'<integer name="height" value="{height}"/>',
        '<float name="fov" value="40.0"/>',
        '<transform name="toWorld"><lookat origin="0 1.0 4.3" target="0 1.0 0" up="0 1 0"/>'
        "</transform>",
        rf,
        "</camera>",
        f'<sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>',
    ]


def _box_shapes(dirpath: Path) -> list[str]:
    """The five walls and the ceiling light, diffuse, as one-quad OBJ shapes."""
    parts = []
    for name, verts in _QUADS.items():
        fname = write_quad_obj(dirpath, name, verts)
        em = ('<emitter type="area"><color name="radiance" value="17.0 12.0 8.0"/></emitter>'
              if name == "light" else "")
        parts.append(
            f'<shape type="obj"><string name="filename" value="{fname}"/>'
            f'<bsdf type="diffuse"><color name="albedo" value="{_vec(_ALBEDO[name])}"/></bsdf>'
            f"{em}</shape>"
        )
    return parts


def cornell_box_xml(dirpath, width: int = 800, height: int = 600, spp: int = 32,
                    integrator: str = "path_mis", rfilter: str | None = None) -> Path:
    """Write the Cornell box (XML + OBJ quads) into `dirpath`; returns the XML path."""
    dirpath = Path(dirpath)
    parts = _header(width, height, spp, integrator, rfilter) + _box_shapes(dirpath)
    # mirror + glass spheres
    parts.append('<shape type="sphere"><point name="center" value="-0.45 0.35 -0.35"/>'
                 '<float name="radius" value="0.35"/><bsdf type="mirror"/></shape>')
    parts.append('<shape type="sphere"><point name="center" value="0.45 0.35 0.4"/>'
                 '<float name="radius" value="0.35"/><bsdf type="dielectric"/></shape>')
    parts.append("</scene>")
    path = dirpath / "cbox.xml"
    path.write_text("\n".join(parts) + "\n")
    return path


def make_cornell_box(width: int = 800, height: int = 600, spp: int = 32,
                     integrator: str = "path_mis"):
    """Cornell box with red/green side walls, a mirror and a glass sphere and
    a rectangular area light in the ceiling (12 triangles, 2 spheres).
    Returns (SceneData, RenderConfig, extras) like `scene.build.load_scene`."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    with tempfile.TemporaryDirectory(prefix="optix_torch_scene_") as tmp:
        return load_scene(cornell_box_xml(tmp, width, height, spp, integrator))


def _uv_sphere_obj(dirpath, name: str, center, radius: float, nu: int = 200, nv: int = 125) -> str:
    """Write a UV-sphere OBJ with 2·nu·(nv−1) triangles; returns its file name.
    The vertex text is the JAX preset's (`_uv_sphere_obj`), so both packages
    load the same mesh."""
    th = np.linspace(0.0, np.pi, nv + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")  # [nv+1, nu]
    x = center[0] + radius * np.sin(tt) * np.cos(pp)
    y = center[1] + radius * np.cos(tt)
    z = center[2] + radius * np.sin(tt) * np.sin(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)

    def vid(i, j):
        return i * nu + (j % nu) + 1  # 1-based OBJ ids

    faces = []
    for i in range(nv):
        for j in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            if i > 0:
                faces.append((a, b, d))
            if i < nv - 1:
                faces.append((b, c, d))
    lines = ["v %f %f %f" % tuple(v) for v in verts]
    lines += ["f %d %d %d" % f for f in faces]
    fname = f"{name}.obj"
    (Path(dirpath) / fname).write_text("\n".join(lines) + "\n")
    return fname


def tessellated_cornell_xml(dirpath, width: int = 800, height: int = 600, spp: int = 8,
                            integrator: str = "path_mis", nu: int = 200, nv: int = 126,
                            rfilter: str | None = None) -> Path:
    """Write the tessellated Cornell box into `dirpath`; returns the XML path.

    The two analytic spheres become UV-sphere meshes (2·2·nu·(nv−1)
    triangles; 100,012 in all at the defaults): a mirror ball on the left
    and a diffuse (0.3, 0.4, 0.7) ball on the right."""
    dirpath = Path(dirpath)
    parts = _header(width, height, spp, integrator, rfilter) + _box_shapes(dirpath)
    for center, bsdf, name in (
        ((-0.45, 0.35, -0.35), '<bsdf type="mirror"/>', "ball_l"),
        ((0.45, 0.35, 0.4), '<bsdf type="diffuse"><color name="albedo" value="0.3 0.4 0.7"/>'
                            "</bsdf>", "ball_r"),
    ):
        fname = _uv_sphere_obj(dirpath, name, center, 0.35, nu=nu, nv=nv)
        parts.append(f'<shape type="obj"><string name="filename" value="{fname}"/>{bsdf}</shape>')
    parts.append("</scene>")
    path = dirpath / "tess_cbox.xml"
    path.write_text("\n".join(parts) + "\n")
    return path


def make_tessellated_cornell(width: int = 800, height: int = 600, spp: int = 8,
                             integrator: str = "path_mis", nu: int = 200, nv: int = 126):
    """The Cornell box with its spheres as dense meshes (the LBVH path).
    Returns (SceneData, RenderConfig, extras) like `scene.build.load_scene`."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    with tempfile.TemporaryDirectory(prefix="optix_torch_scene_") as tmp:
        return load_scene(tessellated_cornell_xml(tmp, width, height, spp, integrator, nu, nv))
