"""The Cornell-box preset: the flagship scene, as XML + OBJ files.

Counterpart of `optix_renderer_tpu/scene/presets.py: make_cornell_box`
(presets.py:27-104): the same walls, albedos, light, spheres and camera.
Here the scene is written as an XML file with one-quad OBJ meshes and
loaded through `scene.build`, so the preset, the CLI and the tests share
one path; `make_cornell_box` writes it into a temporary directory that it
removes again.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

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


def cornell_box_xml(dirpath, width: int = 800, height: int = 600, spp: int = 32,
                    integrator: str = "path_mis", rfilter: str | None = None) -> Path:
    """Write the Cornell box (XML + OBJ quads) into `dirpath`; returns the XML path."""
    dirpath = Path(dirpath)
    rf = f'<rfilter type="{rfilter}"/>' if rfilter else ""
    parts = [
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
    for name, verts in _QUADS.items():
        fname = write_quad_obj(dirpath, name, verts)
        em = ('<emitter type="area"><color name="radiance" value="17.0 12.0 8.0"/></emitter>'
              if name == "light" else "")
        parts.append(
            f'<shape type="obj"><string name="filename" value="{fname}"/>'
            f'<bsdf type="diffuse"><color name="albedo" value="{_vec(_ALBEDO[name])}"/></bsdf>'
            f"{em}</shape>"
        )
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
