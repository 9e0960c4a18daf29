"""Cornell-box presets, as XML + OBJ files.

Counterpart of `optix_renderer_tpu/scene/presets.py: make_cornell_box`
(presets.py:27-104), `make_absorbing_sphere` (presets.py:107-147) and
`make_tessellated_cornell` (presets.py:188-289): the same walls, albedos,
light, spheres, media and cameras. Here each scene is written as an XML
file with OBJ meshes (and volume grids) and loaded through `scene.build`,
so the presets, the CLI and the tests share one path; the `make_*`
functions write into a temporary directory that they remove again.
`test_xml` and `furnace_scene` write statistical `<test>` scenes
(`validation/xmltest.py`); `sphere_cornell_xml` the box with a grid of
spheres, enough for the spheres' LBVH (`ops/bvh.py: MIN_SPHS_FOR_BVH`).
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


def write_quad_obj(dirpath: Path, name: str, verts, uvs=None) -> str:
    """Write a one-quad OBJ (two triangles), with a UV per corner when `uvs`
    is given, into dirpath; returns its file name."""
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    if uvs is None:
        lines.append("f 1 2 3 4")
    else:
        lines += [f"vt {u} {v}" for u, v in uvs] + ["f 1/1 2/2 3/3 4/4"]
    (Path(dirpath) / f"{name}.obj").write_text("\n".join(lines) + "\n")
    return f"{name}.obj"


def _header(width, height, spp, integrator, rfilter, sampler="independent") -> list[str]:
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
        f'<sampler type="{sampler}"><integer name="sampleCount" value="{spp}"/></sampler>',
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
                    integrator: str = "path_mis", rfilter: str | None = None,
                    sampler: str = "independent") -> Path:
    """Write the Cornell box (XML + OBJ quads) into `dirpath`; returns the XML
    path. `sampler="adaptive"` makes the CLI render it adaptively."""
    dirpath = Path(dirpath)
    parts = _header(width, height, spp, integrator, rfilter, sampler) + _box_shapes(dirpath)
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
                     integrator: str = "path_mis", device="cuda"):
    """Cornell box with red/green side walls, a mirror and a glass sphere and
    a rectangular area light in the ceiling (12 triangles, 2 spheres).
    Returns (SceneData, RenderConfig, extras) on `device` like
    `scene.build.load_scene`."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    with tempfile.TemporaryDirectory(prefix="optix_torch_scene_") as tmp:
        return load_scene(cornell_box_xml(tmp, width, height, spp, integrator), device)


def sphere_cornell_xml(dirpath, width: int = 800, height: int = 600, spp: int = 4,
                       integrator: str = "path_mis", nx: int = 10, nz: int = 8) -> Path:
    """The Cornell box with an nx × nz grid of small spheres, radius 0.07,
    on its floor, every third one a mirror, the rest diffuse with albedos
    that vary across the grid (80 spheres by default: the spheres' LBVH,
    and the scan path, which the path kernel leaves above 64 spheres).
    Returns the XML path."""
    dirpath = Path(dirpath)
    parts = _header(width, height, spp, integrator, None) + _box_shapes(dirpath)
    for i, x in enumerate(np.linspace(-0.8, 0.8, nx)):
        for j, z in enumerate(np.linspace(-0.8, 0.8, nz)):
            bsdf = ('<bsdf type="mirror"/>' if (i * nz + j) % 3 == 0 else
                    f'<bsdf type="diffuse"><color name="albedo" value="'
                    f'{0.2 + 0.6 * i / nx:.3f} {0.7 - 0.5 * j / nz:.3f} 0.5"/></bsdf>')
            parts.append(f'<shape type="sphere"><point name="center" value="{x:.4f} 0.07 '
                         f'{z:.4f}"/><float name="radius" value="0.07"/>{bsdf}</shape>')
    parts.append("</scene>")
    path = dirpath / "sphere_cbox.xml"
    path.write_text("\n".join(parts) + "\n")
    return path


def absorbing_sphere_xml(dirpath, sigma_a: float = 0.5, radius: float = 1.0, width: int = 64,
                         height: int = 64, spp: int = 8,
                         integrator: str = "path_vol_mis") -> Path:
    """A pass-through sphere of purely absorbing homogeneous medium in a
    constant L = 1 environment, seen head-on: the centre pixel is
    exp(−σa·2r) (Beer–Lambert, homogmedium.cpp:61-73). Returns the XML path."""
    path = Path(dirpath) / "absorbing_sphere.xml"
    path.write_text(
        f'<scene><integrator type="{integrator}"/><camera type="perspective">'
        f'<integer name="width" value="{width}"/><integer name="height" value="{height}"/>'
        '<float name="fov" value="30"/><transform name="toWorld">'
        '<lookat origin="0 0 6" target="0 0 0" up="0 1 0"/></transform></camera>'
        f'<sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>'
        f'<shape type="sphere"><point name="center" value="0 0 0"/>'
        f'<float name="radius" value="{radius}"/><medium type="homog">'
        f'<color name="sigma_a" value="{sigma_a} {sigma_a} {sigma_a}"/>'
        '<color name="sigma_s" value="0 0 0"/></medium></shape>'
        '<emitter type="envmap"><color name="radiance" value="1 1 1"/></emitter></scene>\n')
    return path


def make_absorbing_sphere(sigma_a: float = 0.5, radius: float = 1.0, width: int = 64,
                          height: int = 64, spp: int = 8, integrator: str = "path_vol_mis",
                          device="cuda"):
    """`absorbing_sphere_xml` loaded on `device`; returns (SceneData,
    RenderConfig, extras)."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    with tempfile.TemporaryDirectory(prefix="optix_torch_scene_") as tmp:
        return load_scene(absorbing_sphere_xml(tmp, sigma_a, radius, width, height, spp,
                                               integrator), device)


# config H's pass-through box: the middle of the room (outward winding, as
# tests/test_heterog.py:_write_cube_obj)
MEDIUM_BOX = ((-0.55, 0.15, -0.55), (0.55, 1.25, 0.55))
_CUBE_FACES = ((1, 3, 2), (1, 4, 3), (5, 6, 7), (5, 7, 8), (1, 6, 5), (1, 2, 6),
               (2, 7, 6), (2, 3, 7), (3, 8, 7), (3, 4, 8), (4, 5, 8), (4, 1, 5))


def medium_cornell_xml(dirpath, width: int = 800, height: int = 600, spp: int = 1,
                       integrator: str = "path_vol_mis", kind: str = "H", res: int = 128,
                       rfilter: str | None = None) -> Path:
    """The Cornell room (walls and area light of `cornell_box_xml`) with
    participating media, written into `dirpath`; returns the XML path.

    kind "H": the spheres give way to a pass-through box of 12 triangles
    filling the middle of the room (`MEDIUM_BOX`) that holds a
    heterogeneous medium, σa 0.5, σs 4.5, isotropic, whose density is
    `make_procedural_fog(res, "sphere")` over the box, written as an `.npz`
    beside the XML; the same array is its temperature grid, with
    temperatureScale 2, so the medium also glows. kind "V": the glass
    sphere holds a homogeneous medium (σa 0.05, σs 1.0, Henyey–Greenstein
    g 0.5) and has no BSDF, and the mirror sphere becomes a small sphere of
    absorbing medium (σa 0.5) carrying a volume light of radiance 4.
    """
    from optix_renderer_tpu_torch.scene.volume_io import make_procedural_fog

    dirpath = Path(dirpath)
    parts = _header(width, height, spp, integrator, rfilter) + _box_shapes(dirpath)
    if kind == "H":
        lo, hi = MEDIUM_BOX
        corners = [(x, y, z) for z in (lo[2], hi[2]) for y in (lo[1], hi[1])
                   for x in (lo[0], hi[0])]
        corners = [corners[i] for i in (0, 1, 3, 2, 4, 5, 7, 6)]  # the cube's vertex order
        (dirpath / "medium_box.obj").write_text(
            "".join(f"v {_vec(v)}\n" for v in corners)
            + "".join(f"f {a} {b} {c}\n" for a, b, c in _CUBE_FACES))
        fog = make_procedural_fog(res, "sphere").density
        np.savez(dirpath / "fog.npz", density=fog, temperature=fog,
                 bbox_min=np.asarray(lo, np.float32), bbox_max=np.asarray(hi, np.float32))
        parts.append(
            '<shape type="obj"><string name="filename" value="medium_box.obj"/>'
            '<medium type="heterog" name="interior"><color name="sigma_a" value="0.5 0.5 0.5"/>'
            '<color name="sigma_s" value="4.5 4.5 4.5"/>'
            '<float name="temperatureScale" value="2"/><phase type="isophase"/>'
            '<volume type="volume"><string name="filename" value="fog.npz"/></volume>'
            "</medium></shape>")
    elif kind == "V":
        parts.append(
            '<shape type="sphere"><point name="center" value="0.45 0.35 0.4"/>'
            '<float name="radius" value="0.35"/><medium type="homog" name="interior">'
            '<color name="sigma_a" value="0.05 0.05 0.05"/><color name="sigma_s" value="1 1 1"/>'
            '<phase type="anisophase"><float name="g" value="0.5"/></phase></medium></shape>')
        parts.append(
            '<shape type="sphere"><point name="center" value="-0.45 0.35 -0.35"/>'
            '<float name="radius" value="0.2"/><medium type="homog" name="interior">'
            '<color name="sigma_a" value="0.5 0.5 0.5"/><color name="sigma_s" value="0 0 0"/>'
            '<emitter type="volumelight"><color name="radiance" value="4 4 4"/></emitter>'
            "</medium></shape>")
    else:
        raise ValueError(f"kind must be 'H' or 'V', got {kind!r}")
    parts.append("</scene>")
    path = dirpath / f"medium_cbox_{kind}.xml"
    path.write_text("\n".join(parts) + "\n")
    return path


def _uv_sphere_obj(dirpath, name: str, center, radius: float, nu: int = 200, nv: int = 125,
                   outward: bool = False) -> str:
    """Write a UV-sphere OBJ with 2·nu·(nv−1) triangles; returns its file name.
    The text is the JAX preset's (`_uv_sphere_obj`), so both packages load
    the same mesh; its windings face inward, and `outward` reverses them."""
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
    if outward:
        faces = [(f[0], f[2], f[1]) for f in faces]
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
                             integrator: str = "path_mis", nu: int = 200, nv: int = 126,
                             device="cuda"):
    """The Cornell box with its spheres as dense meshes (the LBVH path).
    Returns (SceneData, RenderConfig, extras) on `device` like
    `scene.build.load_scene`."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    with tempfile.TemporaryDirectory(prefix="optix_torch_scene_") as tmp:
        return load_scene(tessellated_cornell_xml(tmp, width, height, spp, integrator, nu, nv),
                          device)


def textured_cornell_xml(dirpath, width: int = 800, height: int = 600, spp: int = 4,
                         integrator: str = "direct_mis", rfilter: str | None = None) -> Path:
    """Config T: the Cornell box with every surface feature of the scan path,
    written with its images into `dirpath`; returns the XML path.

    A checkerboard floor; a 256×256 PNG texture on the back wall; a 128×128
    tangent-space normal map (PNG, `name="normal"`) on the left wall, whose
    UV chart is mirrored; a third, small sphere with an area emitter; and a
    128×64 EXR envmap rotated by Euler angles, seen through the open front.
    The images are made from fixed formulas, so every call writes the same
    bytes.
    """
    from optix_renderer_tpu_torch.utils.imageio import encode_png, write_exr

    dirpath = Path(dirpath)
    u, v = np.meshgrid((np.arange(256) + 0.5) / 256, (np.arange(256) + 0.5) / 256)
    wall = np.stack([0.5 + 0.4 * np.sin(6.0 * u), 0.4 + 0.3 * np.cos(9.0 * v * u),
                     0.3 + 0.25 * ((u * 8).astype(int) % 2)], axis=-1)
    (dirpath / "wall.png").write_bytes(encode_png(wall.astype(np.float32)))
    u, v = np.meshgrid((np.arange(128) + 0.5) / 128, (np.arange(128) + 0.5) / 128)
    n = np.stack([0.45 * np.sin(2 * np.pi * 4 * u), 0.45 * np.sin(2 * np.pi * 3 * v),
                  np.ones_like(u)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    (dirpath / "bumps.png").write_bytes(encode_png((0.5 * n + 0.5).astype(np.float32),
                                                   tonemap=False))
    theta, phi = np.meshgrid((np.arange(64) + 0.5) / 64 * np.pi,
                             (np.arange(128) + 0.5) / 128 * 2 * np.pi, indexing="ij")
    sky = np.stack([0.2 + 0.3 * np.cos(theta) ** 2, 0.3 + 0.2 * np.sin(phi) ** 2,
                    0.5 + 0.4 * np.cos(theta)], axis=-1)
    sun = 40.0 * np.exp(-((theta - 1.1) ** 2 + (phi - 2.0) ** 2) / 0.02)
    write_exr(dirpath / "sky.exr", np.maximum(sky + sun[..., None], 0.0).astype(np.float32))

    uv_quad = [(0, 0), (1, 0), (1, 1), (0, 1)]
    textures = {
        "floor": '<texture type="checkerboard_color" name="albedo">'
                 '<color name="value1" value="0.8 0.78 0.75"/>'
                 '<color name="value2" value="0.15 0.2 0.3"/>'
                 '<vector name="scale" value="0.125 0.125"/>'
                 '<vector name="delta" value="0.03 0.05"/>'
                 "</texture>",
        "back": '<texture type="png_texture" name="albedo">'
                '<string name="filename" value="wall.png"/></texture>',
    }
    parts = _header(width, height, spp, integrator, rfilter)
    for name, verts in _QUADS.items():
        uvs = {"left": [(0, 0), (0, 1), (1, 1), (1, 0)]}.get(name, uv_quad)
        fname = write_quad_obj(dirpath, name, verts, uvs)
        albedo = textures.get(name, f'<color name="albedo" value="{_vec(_ALBEDO[name])}"/>')
        extra = ""
        if name == "light":
            extra = '<emitter type="area"><color name="radiance" value="17.0 12.0 8.0"/></emitter>'
        elif name == "left":
            extra = ('<texture type="png_texture" name="normal">'
                     '<string name="filename" value="bumps.png"/>'
                     '<boolean name="sRGB" value="false"/></texture>')
        parts.append(f'<shape type="obj"><string name="filename" value="{fname}"/>'
                     f'<bsdf type="diffuse">{albedo}</bsdf>{extra}</shape>')
    parts.append('<shape type="sphere"><point name="center" value="-0.45 0.35 -0.35"/>'
                 '<float name="radius" value="0.35"/><bsdf type="mirror"/></shape>')
    parts.append('<shape type="sphere"><point name="center" value="0.45 0.35 0.4"/>'
                 '<float name="radius" value="0.35"/><bsdf type="dielectric"/></shape>')
    parts.append('<shape type="sphere"><point name="center" value="0.1 1.3 0.2"/>'
                 '<float name="radius" value="0.12"/>'
                 '<emitter type="area"><color name="radiance" value="6.0 5.0 4.0"/></emitter>'
                 "</shape>")
    parts.append('<emitter type="envmap"><texture type="png_texture">'
                 '<string name="filename" value="sky.exr"/>'
                 '<vector name="eulerAngles" value="30 60 15"/></texture></emitter>')
    parts.append("</scene>")
    path = dirpath / "textured_cbox.xml"
    path.write_text("\n".join(parts) + "\n")
    return path


# the BSDFs of a BSDF-mode t-test: diffuse, microfacet at α 0.1 and 0.4
# (kd 0.5, so ks 0.5), and the default glass
TTEST_BSDFS = (
    '<bsdf type="diffuse"><color name="albedo" value="0.5 0.5 0.5"/></bsdf>',
    '<bsdf type="microfacet"><float name="alpha" value="0.1"/></bsdf>',
    '<bsdf type="microfacet"><float name="alpha" value="0.4"/></bsdf>',
    '<bsdf type="dielectric"/>',
)


def test_xml(dirpath, name: str, test_type: str, props: dict, children) -> Path:
    """Write a statistical `<test type="ttest"|"chi2test">` XML named `name`
    into `dirpath` (the grammar of the reference's scenes/pa*/tests) and
    return its path. `props` maps property names to str, int or float
    values; `children` are `<bsdf>` or `<scene>` elements as text."""
    tags = {str: "string", int: "integer", float: "float"}
    parts = [f'<test type="{test_type}">']
    parts += [f'<{tags[type(v)]} name="{k}" value="{v}"/>' for k, v in props.items()]
    parts += list(children) + ["</test>"]
    path = Path(dirpath) / name
    path.write_text("\n".join(parts) + "\n")
    return path


def furnace_scene(dirpath, nu: int, nv: int, albedo: float = 0.75, width: int = 24,
                  height: int = 16, integrator: str = "path_mis") -> str:
    """A `<scene>` element, as text, for a scene-mode t-test: a diffuse,
    flat-shaded, outward-wound UV sphere of radius 1, 2·nu·(nv−1)
    triangles (below 257 the brute-force sweep, from 257 on the LBVH walk)
    written into `dirpath`, and gray `albedo`, that fills the whole view of
    a camera 2.5 from its centre (fov 30), in a constant envmap of radiance
    1. The mesh is convex, so every path leaves it after one bounce and the
    mean luminance is exactly `albedo`; each lane's luminance depends on the
    face it hits."""
    bsdf = f'<bsdf type="diffuse"><color name="albedo" value="{albedo} {albedo} {albedo}"/></bsdf>'
    fname = _uv_sphere_obj(dirpath, f"furnace_{nu}x{nv}", (0.0, 0.0, 0.0), 1.0, nu=nu, nv=nv,
                           outward=True)
    shapes = f'<shape type="obj"><string name="filename" value="{fname}"/>{bsdf}</shape>'
    return (f'<scene><integrator type="{integrator}"/><camera type="perspective">'
            f'<integer name="width" value="{width}"/><integer name="height" value="{height}"/>'
            '<float name="fov" value="30"/><transform name="toWorld">'
            '<lookat origin="0 0 2.5" target="0 0 0" up="0 1 0"/></transform></camera>'
            f'{shapes}<emitter type="envmap"><color name="radiance" value="1 1 1"/></emitter>'
            '</scene>')
