"""The scan path's shading kernel (`csrc/scan.cu`, `ops/cuda/scan.py`) and the
bounce loop around it (`integrators/path.py: li_path_fused`).

On the CPU: the loop over `shade_ref`, the kernel's contract in plain torch,
against the torch chain (`li_path_mis` / `li_path_mats`) on four small
scenes that between them hold every feature the kernel takes: L, albedo
and normal within 1e-5 relative, and after every bounce the pcg32 state of
every lane still alive, bit for bit; the same loop over the kernel's own
body built by g++ (`scan_shade_host`), within 1e-4; and who takes the
kernel, each refusal with its reason.

On a card (`-m card`; they skip without one): the kernel against the chain
on config A (the 100,012-triangle box) at 64×48 and config B, the
counters, and one capture per scene and config. This file imports no JAX:

    python -m pytest tests/test_torch_scan_shade.py -m card --noconftest -p no:cacheprovider
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch.integrators import path as path_int
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.ops.cuda import mega
from optix_renderer_tpu_torch.ops.cuda import scan as scan_shade
from optix_renderer_tpu_torch.render import render as render_mod
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render import scan_graph
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.utils import tracing

CSRC = Path(path_int.__file__).resolve().parents[1] / "csrc"
INTEGRATORS = ["path_mis", "path_mats"]
SCENES = ["tess300", "box", "zoo", "spheres80"]
DEPTH = 6
W, H = 24, 16

# microfacet and Disney spheres among the other BSDFs, under a mesh light and
# point, spot and directional lights, in a constant envmap
_MATERIALS = [
    '<bsdf type="diffuse"><color name="albedo" value="0.6 0.5 0.4"/></bsdf>',
    '<bsdf type="mirror"/>',
    '<bsdf type="dielectric"><float name="intIOR" value="1.45"/></bsdf>',
    '<bsdf type="microfacet"><float name="alpha" value="0.2"/>'
    '<color name="kd" value="0.3 0.2 0.1"/></bsdf>',
    '<bsdf type="disney"><color name="albedo" value="0.7 0.3 0.2"/>'
    '<float name="metallic" value="0.3"/><float name="roughness" value="0.4"/>'
    '<float name="anisotropic" value="0.5"/><float name="sheen" value="0.6"/>'
    '<float name="clearcoat" value="0.7"/><float name="subsurface" value="0.2"/></bsdf>',
]
_LIGHTS = (
    '<emitter type="point"><point name="position" value="0 1.8 1"/>'
    '<color name="power" value="80 70 60"/></emitter>'
    '<emitter type="spot"><point name="position" value="0.5 1.8 1"/>'
    '<vector name="direction" value="0 -1 -0.5"/><color name="power" value="60 50 40"/>'
    '<float name="falloffstart" value="15"/><float name="totalwidth" value="30"/></emitter>'
    '<emitter type="directional"><vector name="direction" value="-0.3 -1 -0.4"/>'
    '<color name="radiance" value="4 3.6 3"/><float name="angle" value="5"/></emitter>'
    '<emitter type="envmap"><color name="radiance" value="0.2 0.25 0.3"/></emitter>'
)


def _zoo_xml(d: Path) -> str:
    presets.write_quad_obj(d, "floor", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)])
    presets.write_quad_obj(d, "light", [(-0.3, 1.9, -0.3), (0.3, 1.9, -0.3), (0.3, 1.9, 0.3),
                                        (-0.3, 1.9, 0.3)])
    spheres = "".join(
        f'<shape type="sphere"><point name="center" value="{-0.8 + 0.4 * k} 0.3 0"/>'
        f'<float name="radius" value="0.15"/>{m}</shape>' for k, m in enumerate(_MATERIALS))
    xml = f"""<scene><integrator type="path_mis"/>
<camera type="perspective"><integer name="width" value="{W}"/>
<integer name="height" value="{H}"/><float name="fov" value="40"/>
<transform name="toWorld"><lookat origin="0 1.0 4.3" target="0 0.5 0" up="0 1 0"/></transform>
</camera>
<shape type="obj"><string name="filename" value="floor.obj"/>
<bsdf type="microfacet"><float name="alpha" value="0.3"/></bsdf></shape>
<shape type="obj"><string name="filename" value="light.obj"/><bsdf type="diffuse"/>
<emitter type="area"><color name="radiance" value="5 4 3"/></emitter></shape>
{spheres}{_LIGHTS}</scene>"""
    path = d / "zoo.xml"
    path.write_text(xml)
    return str(path)


def _load(name, d: Path, device="cpu"):
    if name == "tess300":  # 300 triangles: the LBVH and isect_bvh
        xml = presets.tessellated_cornell_xml(d, W, H, 1, "path_mis", nu=12, nv=7)
    elif name == "box":  # 12 triangles (isect_brute) and two analytic spheres
        xml = presets.cornell_box_xml(d, W, H, 1, "path_mis")
    elif name == "zoo":
        xml = _zoo_xml(d)
    else:  # 80 spheres: the spheres' LBVH (isect_spheres)
        xml = presets.sphere_cornell_xml(d, W, H, 1, "path_mis")
    scene, cfg, _ = build.load_scene(str(xml), device=device)
    return scene, dataclasses.replace(cfg, max_depth=DEPTH, seed=977)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name in SCENES:
        out[name] = _load(name, tmp_path_factory.mktemp(name))
    return out


def _rays(scene, cfg, sample=3):
    """The camera rays and samplers of `render._round_layers`, every pixel."""
    ids = torch.arange(cfg.width * cfg.height, device=scene.camera.to_world.device)
    s = smp.make_sampler(ids, sample, seed=cfg.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    pos = torch.stack([(ids % cfg.width).float(), (ids // cfg.width).float()], -1) + jitter
    ray, _ = camera_ops.sample_ray(scene.camera, cfg.width, cfg.height, pos, aperture)
    return ray, s


def _chain(scene, cfg, ray, s, depth):
    li = path_int.li_path_mis if cfg.integrator == "path_mis" else path_int.li_path_mats
    return li(scene, dataclasses.replace(cfg, max_depth=depth), ray, s)


def _fused(scene, cfg, ray, s, shade):
    """The fused loop; each bounce's (active, state words) recorded."""
    sc = scan_shade.ShadeScene(scene, cfg)
    states = []

    def rec(sc_, lanes, bounce, hits, occ, fold_only=False):
        shade(sc_, lanes, bounce, hits, occ, fold_only)
        if not fold_only:
            states.append((lanes.active.clone(), lanes.st_hi.clone(), lanes.st_lo.clone()))

    out = path_int.li_path_fused(scene, cfg, ray, s, sc, shade=rec)
    return out, states


def _off(got, want, rel):
    """Lanes with any value off by more than rel × (|want| + 1e-3)."""
    bad = (got - want).abs() > rel * (want.abs() + 1e-3)
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def _hold(scene, cfg, shade, rel, share=0.001):
    """`li_path_fused` over `shade` against the chain: L, albedo and normal
    within rel × (|chain| + 1e-3) outside at most `share` of the lanes (a
    branch flipped by an ulp), and after each bounce the pcg32 state of every
    lane still alive equal (the chain draws for every lane, alive or not)."""
    ray, s = _rays(scene, cfg)
    (L, albedo, normal, _), states = _fused(scene, cfg, ray, s, shade)
    cL, calb, cnrm, _ = _chain(scene, cfg, ray, s, cfg.max_depth)
    n = L.shape[0]
    for name, got, want in (("L", L, cL), ("albedo", albedo, calb), ("normal", normal, cnrm)):
        assert torch.isfinite(got).all(), name
        off = _off(got, want, rel)
        assert int(off.sum()) <= int(share * n), (name, int(off.sum()), got[off][:4], want[off][:4])
    assert float(cL.abs().sum()) > 0 and float(calb.abs().sum()) > 0
    alive_any = False
    for b, (active, hi, lo) in enumerate(states):
        *_, cs = _chain(scene, cfg, ray, s, b + 1)
        st = cs.state
        same = (hi == st.state_hi) & (lo == st.state_lo)
        assert bool(same[active].all()), (b, int((~same & active).sum()))
        alive_any |= bool(active.any())
    assert alive_any


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_the_plain_shade_loop_gives_the_chains_layers_and_streams(scenes, name, integrator):
    scene, cfg = scenes[name]
    _hold(scene, dataclasses.replace(cfg, integrator=integrator), scan_shade.shade_ref, 1e-5)


@pytest.fixture(scope="module")
def host_shade(tmp_path_factory):
    """`csrc/scan.cu`'s lane body built by g++ (`scan_shade_host`), as a
    `shade` for `li_path_fused`, or a skip."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("scan_host") / "libscan.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-x", "c++", "-o", str(so), str(CSRC / "scan.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.scan_shade_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.scan_shade_host.restype = None

    def shade(sc, lanes, bounce, hits, occ, fold_only=False):
        c = scan_shade._c_lanes(lanes, hits, occ)
        lib.scan_shade_host(ctypes.addressof(sc.c), ctypes.addressof(c), bounce, int(sc.mis),
                            int(fold_only))

    return shade


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", SCENES)
def test_the_kernels_body_on_the_host_gives_the_chains_layers_and_streams(
        scenes, host_shade, name, integrator):
    """The host's libm rounds cosf / sinf / powf apart from torch's by an
    ulp, and a ray that grazes one of the 80 small mirror and diffuse balls
    carries that into another path: up to 1 % of lanes may differ."""
    scene, cfg = scenes[name]
    _hold(scene, dataclasses.replace(cfg, integrator=integrator), host_shade, 1e-4, 0.01)


# ---------------------------------------------------------------- who takes it


def _with(scene, part, **fields):
    return dataclasses.replace(scene, **{part: dataclasses.replace(getattr(scene, part),
                                                                   **fields)})


def _refusals(scenes):
    box, cfg = scenes["box"]
    zoo, _ = scenes["zoo"]
    sh, tex, b = box.shapes, box.textures, box.bsdfs
    diffuse_tex = int(b.albedo_tex[0])
    checker = tex.type.clone()
    checker[diffuse_tex] = 1
    ntex = sh.normal_tex.clone()
    ntex[0] = diffuse_tex
    medium = sh.interior_medium.clone()
    medium[0] = 0
    sph_light = sh.emitter.clone()
    sph_light[int(box.geometry.sph_shape[0])] = 0
    img_env = _with(zoo, "envmap", img=torch.ones((2, 4, 3)))
    kd = b.kd.clone().requires_grad_(True)
    return {
        "textures": (_with(box, "textures", type=checker, kinds=(0, 1)), cfg, "cuda",
                     "textures"),
        "normal maps": (_with(box, "shapes", normal_tex=ntex, mapped=True), cfg, "cuda",
                        "normal maps"),
        "media": (_with(box, "shapes", interior_medium=medium), cfg, "cuda", "medium"),
        "sphere lights": (_with(box, "shapes", emitter=sph_light), cfg, "cuda",
                          "sphere-area emitters"),
        "image envmaps": (img_env, cfg, "cuda", "image-based environment maps"),
        # refused by scan_graph.graphable, as the round is not captured
        "requires grad": (_with(box, "bsdfs", kd=kd), cfg, "cuda", None),
        "cpu": (box, cfg, "cpu", None),
        "integrator": (box, dataclasses.replace(cfg, integrator="direct_mis"), "cuda", None),
    }


CASES = (["take: " + n for n in SCENES]
         + ["refuse: " + n for n in ("textures", "normal maps", "media", "sphere lights",
                                     "image envmaps", "requires grad", "cpu", "integrator")])


@pytest.mark.parametrize("case", CASES)
def test_who_takes_the_kernel(scenes, case, monkeypatch):
    """Each eligible scene takes the kernel under both integrators; each
    refusal differs from the eligible box in one thing, and its reason is
    either `scan_graph.graphable`'s or `mega.surface_unsupported`'s."""
    monkeypatch.setattr(scan_shade, "_cache", type(scan_shade._cache)())
    verdict, name = case.split(": ")
    if verdict == "take":
        scene, cfg = scenes[name]
        for integ in INTEGRATORS:
            c = dataclasses.replace(cfg, integrator=integ)
            assert mega.surface_unsupported(scene, c) is None
            for dev in ("cuda", torch.device("cuda", 1)):
                sc = scan_shade.prepare(scene, c, dev)
                assert isinstance(sc, scan_shade.ShadeScene) and sc.mis == (integ == "path_mis")
        return
    scene, cfg, device, why = _refusals(scenes)[name]
    assert scan_shade.prepare(scene, cfg, device) is None
    if why is None:
        assert not scan_graph.graphable(scene, cfg, device)
        return
    assert scan_graph.graphable(scene, cfg, device)
    reason = mega.surface_unsupported(scene, cfg)
    assert reason is not None and why in reason, reason


def test_the_decision_is_cached_per_scene_and_config(scenes, monkeypatch):
    scene, cfg = scenes["box"]
    calls = []
    real = mega.surface_unsupported

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(mega, "surface_unsupported", counted)
    monkeypatch.setattr(scan_shade, "_cache", type(scan_shade._cache)())
    assert scan_shade.prepare(scene, cfg, "cpu") is None and not calls  # no table read
    sc = scan_shade.prepare(scene, cfg, "cuda")
    assert isinstance(sc, scan_shade.ShadeScene) and sc.mis
    for seed in (1, 2**31 - 1):
        assert scan_shade.prepare(scene, dataclasses.replace(cfg, seed=seed), "cuda") is sc
    assert len(calls) == 1
    scan_shade.prepare(scene, dataclasses.replace(cfg, max_depth=3), "cuda")
    assert len(calls) == 2


def test_a_table_that_comes_to_require_grad_takes_the_chain(scenes, monkeypatch):
    """`train_step`'s parameters are the scene's tables detached with
    requires_grad set: the same storage, so the same cache key as the
    scene's, whose rounds took the kernel; they must take the chain."""
    scene, cfg = scenes["box"]
    monkeypatch.setattr(scan_shade, "_cache", type(scan_shade._cache)())
    assert scan_shade.prepare(scene, cfg, "cuda") is not None
    grad = _with(scene, "bsdfs", kd=scene.bsdfs.kd.detach().requires_grad_(True))
    assert scan_graph.cache_key(grad, cfg, "cuda") == scan_graph.cache_key(scene, cfg, "cuda")
    assert scan_shade.prepare(grad, cfg, "cuda") is None
    assert scan_shade.prepare(scene, cfg, "cuda") is not None


def test_a_cpu_round_runs_the_chain(scenes, monkeypatch):
    scene, cfg = scenes["box"]

    def refuse(*args, **kw):
        raise AssertionError("a CPU round reached the shading kernel")

    monkeypatch.setattr(path_int, "li_path_fused", refuse)
    pos, layers = render_mod._round_layers(scene, cfg, torch.arange(64), 0)
    assert layers.shape == (3, 64, 3)


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from optix_renderer_tpu_torch.ops.cuda import _build

    _build.load()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_scenes():
    """{name: (scene, config)} on the card: config A and config B (the
    mitchell Cornell box with its analytic spheres), 64×48, depth 8."""
    dev = _card()
    a, cfg_a, _ = presets.make_tessellated_cornell(64, 48, 4, "path_mis", device=dev)
    b, cfg_b, _ = presets.make_cornell_box(64, 48, 4, "path_mis", device=dev)
    cfg_b = dataclasses.replace(cfg_b, rfilter="mitchell")
    return {"tess100k": (a, dataclasses.replace(cfg_a, max_depth=8)),
            "configB": (b, dataclasses.replace(cfg_b, max_depth=8))}


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", ["tess100k", "configB"])
def test_the_kernel_gives_the_chains_layers_and_streams(card_scenes, name, integrator):
    """`li_path_fused` on the card (the kernel) against the chain on the
    same camera rays: every composite, albedo and normal value within
    1e-4 × (|chain| + 1e-3) outside at most 0.1 % of lanes, and the
    sampler state of every lane alive after each bounce equal."""
    scene, cfg = card_scenes[name]
    cfg = dataclasses.replace(cfg, integrator=integrator, seed=4321)
    assert scan_shade.prepare(scene, cfg, _card()) is not None
    _hold(scene, cfg, scan_shade.shade, 1e-4)


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", ["tess100k", "configB"])
def test_a_replayed_round_of_the_kernel_equals_its_eager_round(card_scenes, name, integrator):
    """The round's body through the kernel, captured once and replayed for two
    seeds and samples, against eager calls, bit for bit."""
    scene, cfg = card_scenes[name]
    cfg = dataclasses.replace(cfg, integrator=integrator)
    dev = _card()
    assert scan_shade.prepare(scene, cfg, dev) is not None
    ids = torch.arange(cfg.width * cfg.height, device=dev)
    s2c = camera_ops.sample_to_camera_matrix(scene.camera.to("cpu"), cfg.width,
                                             cfg.height).to(dev)
    scalar = torch.zeros((), dtype=torch.int64, device=dev)
    render_mod._round_layers(scene, cfg, ids, 0)  # warm: load every kernel before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        pos_g, layers_g = render_mod._round_layers(scene, dataclasses.replace(cfg, seed=0), ids,
                                                   scalar, s2c)
    for seed in (5, 2**31 - 7):
        for sample in (0, 2):
            pos, layers = render_mod._round_layers(scene, dataclasses.replace(cfg, seed=seed),
                                                   ids, sample)
            scalar.fill_(scan_graph.sample_scalar(sample, seed))
            g.replay()
            assert torch.equal(pos_g, pos) and torch.equal(layers_g, layers), (seed, sample)


@pytest.mark.card
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", ["tess100k", "configB"])
def test_traced_rounds_count_the_fused_rounds(card_scenes, name, integrator):
    """A traced render counts each round in `scan.rounds_fused` (1 where it
    took the kernel), an untraced one nothing; and a scene and config are
    captured once."""
    scene, cfg = card_scenes[name]
    cfg = dataclasses.replace(cfg, integrator=integrator, max_depth=7)
    before = tracing.counter("scan.graph_captures")
    render_mod.render(scene, cfg, sample_count=2, device="cuda", mega=False)
    assert tracing.counter("scan.graph_captures") == before + 1
    tracing.enable()
    try:
        old = tracing.counters("scan.rounds")
        render_mod.render(scene, dataclasses.replace(cfg, seed=9), sample_count=3, device="cuda",
                          mega=False)
    finally:
        tracing.enable(False)
    new = tracing.counters("scan.rounds")
    got = {k: v - old.get(k, 0) for k, v in new.items()}
    assert got["scan.rounds"] == got["scan.rounds_fused"] == got["scan.rounds_graphed"] == 3
    assert tracing.counter("scan.graph_captures") == before + 1
    untraced = tracing.counters("scan.rounds")
    render_mod.render(scene, dataclasses.replace(cfg, seed=10), sample_count=2, device="cuda",
                      mega=False)
    assert tracing.counters("scan.rounds") == untraced
