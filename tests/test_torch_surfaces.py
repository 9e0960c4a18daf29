"""The port's surface features against the JAX package's, on the CPU:
checkerboard and image textures, the PNG and RGBE readers, image envmaps,
sphere-area emitters, normal maps, and config T, the Cornell box that
carries all of them (`scene/presets.py: textured_cornell_xml`).

* `eval_texture` equals the JAX one on every lane, uv negative and > 1
  included (both wrap by floor-mod);
* the PNG reader equals PIL on 8-bit gray, gray + alpha, RGB and RGBA files
  whose scanlines use every filter type 0–4, and refuses interlaced and
  16-bit files; `read_hdr` decodes an RLE file as the JAX reader does;
* envmap tables: the oriented image and the rotation bit for bit; the pixel
  distribution to 3e-7 of its CDF (two ulps of 1) and its pmf to 2.5e-7
  relative, because the port accumulates in float64 and XLA in blocked
  float32 sums; eval / pdf / sample on the same tables to 1e-5;
* emitters (a sphere-area light, a mesh light, an image envmap), the
  normal-mapped `trace` frame and the BSDFs on textured albedo to 1e-5
  relative and 5e-6 absolute, except on at most 0.1 % of the lanes: a
  nearest-texel lookup or a pixel of the envmap flips where XLA's FMAs move
  a coordinate by an ulp;
* config T built by both builders, field by field, and its films against the
  JAX `render(mega=False)` ones by tests/test_mega.py:182-211's statistic.

Every texture and envmap is written into `tmp_path`.
"""

import dataclasses
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core import dpdf as jdpdf
from optix_renderer_tpu.core import warp as jwarp
from optix_renderer_tpu.core.math import Ray as JRay
from optix_renderer_tpu.integrators import common as jcommon
from optix_renderer_tpu.ops import bsdf as jbsdf
from optix_renderer_tpu.ops import emitter as jemitter
from optix_renderer_tpu.ops import envmap as jenvmap
from optix_renderer_tpu.ops import texture as jtexture
from optix_renderer_tpu.render.render import render as jrender
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene import data as jdata
from optix_renderer_tpu.utils import imageio as jimageio
from optix_renderer_tpu_torch.core import dpdf, warp
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf, emitter, envmap, texture
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import (
    DiscretePDF,
    EnvmapTables,
    Textures,
    scene_from_numpy,
)
from optix_renderer_tpu_torch.utils import imageio

T, J = torch.from_numpy, jnp.asarray


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lanes_close(got, ref, what, share=1e-3):
    """1e-5 relative and 5e-6 absolute on all but `share` of the lanes."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    with np.errstate(invalid="ignore"):  # inf − inf where both are inf: no difference
        diff = np.where(got == ref, 0.0, np.abs(got - ref))
    off = diff > 5e-6 + 1e-5 * np.abs(ref)
    off = off.reshape(off.shape[0], -1).any(axis=-1)
    assert off.mean() <= share, (what, int(off.sum()), float(diff.max()))


@pytest.fixture(scope="module")
def config_t(tmp_path_factory):
    """Config T at 24×16 built by the JAX builder, and by the port's."""
    xml = presets.textured_cornell_xml(tmp_path_factory.mktemp("config_t"), 24, 16, 4)
    js, jc, _ = jbuild.load_scene(str(xml))
    ts, tc, _ = build.load_scene(xml, device="cpu")
    return js, jc, ts, tc


# ---- textures --------------------------------------------------------------


def test_eval_texture_matches_jax():
    rng = np.random.default_rng(5)
    img0, img1 = rng.uniform(size=(5, 7, 3)), rng.uniform(size=(3, 4, 3))
    data = np.zeros((2, 5, 7, 3), np.float32)
    data[0], data[1, :3, :4] = img0, img1
    fields = dict(
        type=np.array([0, 1, 2, 2, 1], np.int32),
        value=rng.uniform(size=(5, 3)).astype(np.float32),
        value2=rng.uniform(size=(5, 3)).astype(np.float32),
        scale_uv=np.array([[1, 1], [0.25, 0.5], [1, 1], [2, 3], [1.5, 0.7]], np.float32),
        shift_uv=np.array([[0, 0], [0.1, -0.2], [0, 0], [0, 0], [-0.3, 0.05]], np.float32),
        image_id=np.array([-1, -1, 0, 1, -1], np.int32),
        image_data=data, image_hw=np.array([[5, 7], [3, 4]], np.int32))
    jtex = jdata.Textures(**{k: J(v) for k, v in fields.items()})
    ttex = Textures(**{k: T(v) for k, v in fields.items()})
    assert ttex.kinds == (0, 1, 2)
    n = 20000
    uv = rng.uniform(-3.0, 4.0, (n, 2)).astype(np.float32)
    uv[:64] = rng.choice([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.0, -1e-9], (64, 2))
    ids = rng.integers(-1, 5, n).astype(np.int32)
    got = texture.eval_texture(ttex, T(ids), T(uv))
    ref = jtexture.eval_texture(jtex, J(ids), J(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a table of constants evaluates only them, to the same values
    const = dataclasses.replace(ttex, kinds=(0,))
    only = ids % 5 == 0
    np.testing.assert_array_equal(
        texture.eval_texture(const, T(np.where(only, ids, -1)), T(uv)).numpy(),
        np.where(only[:, None], np.asarray(ref), 1.0))


# ---- image files -----------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(px: np.ndarray, ctype: int, filters, interlace=0, depth=8) -> bytes:
    """A PNG of uint8 pixels [h,w,c] whose scanline y uses filter filters[y % len]."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x, b = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), b[:-c]])
        f = filters[y % len(filters)]
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][f]
        out.append(np.concatenate([[f], (x - pred) % 256]).astype(np.uint8))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_reader_matches_pil(tmp_path, ctype, channels):
    from PIL import Image

    rng = np.random.default_rng(ctype)
    px = rng.integers(0, 256, (11, 13, channels)).astype(np.uint8)
    px[3:6] = px[3:4]  # repeated rows and runs
    path = tmp_path / "t.png"
    path.write_bytes(_png(px, ctype, [0, 1, 2, 3, 4, 4, 3, 2, 1]))
    ref = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(imageio.read_png(path), ref)
    np.testing.assert_array_equal(imageio.read_image(path), ref)
    # the port's writer round-trips through the reader
    img = rng.uniform(size=(5, 6, 3)).astype(np.float32)
    path.write_bytes(imageio.encode_png(img, tonemap=False))
    want = np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8) / np.float32(255)
    np.testing.assert_array_equal(imageio.read_png(path), want)


def test_png_reader_refuses_interlaced_and_16_bit(tmp_path):
    """Interlaced and 16-bit files, and a palette file without its PLTE
    chunk, raise a clear error (palette files with one are read:
    tests/test_torch_imageio.py)."""
    px = np.zeros((4, 4, 3), np.uint8)
    path = tmp_path / "t.png"
    path.write_bytes(_png(px, 2, [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        imageio.read_png(path)
    path.write_bytes(_png(px, 2, [0], depth=16))
    with pytest.raises(ValueError, match="16-bit"):
        imageio.read_png(path)
    path.write_bytes(_png(px[..., :1], 3, [0]))  # palette indices, no PLTE chunk
    with pytest.raises(ValueError, match="PLTE"):
        imageio.read_png(path)


def _rle_channel(vals: np.ndarray) -> bytes:
    """Radiance new-style RLE of one channel of a scanline: runs of ≥ 3
    equal bytes as (128 + n, byte), the rest as literals (n, bytes...)."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and vals[k] == vals[k + 1] == vals[k + 2]):
            k += 1
        out += bytes([k - i]) + bytes(vals[i:k])
        i = k
    return bytes(out)


def test_read_hdr_decodes_rle(tmp_path):
    rng = np.random.default_rng(9)
    h, w = 6, 40
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (h, w))
    rgbe[:, 10:30] = rgbe[:, 10:11]  # runs
    rgbe[2, 5, 3] = 0  # a zero exponent reads as black
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            body += _rle_channel(rgbe[y, :, c])
    path = tmp_path / "t.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
                     + bytes(body))
    want = rgbe[..., :3] / 256.0 * np.exp2(rgbe[..., 3:4].astype(np.float64) - 128)
    want[rgbe[..., 3] == 0] = 0.0
    got = imageio.read_hdr(path)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, jimageio.read_hdr(path))
    np.testing.assert_array_equal(imageio.read_image(path), got)


# ---- warps, distributions, envmaps ----------------------------------------


def test_hemisphere_warp_and_sample_reuse_match_jax():
    rng = np.random.default_rng(4)
    u2 = rng.uniform(size=(4096, 2)).astype(np.float32)
    v = warp.square_to_uniform_hemisphere(T(u2))
    np.testing.assert_allclose(v.numpy(), np.asarray(jwarp.square_to_uniform_hemisphere(J(u2))),
                               rtol=1e-6, atol=1e-6)
    assert bool((v[:, 2] >= 0).all())
    w = rng.uniform(size=37).astype(np.float32) * (rng.uniform(size=37) > 0.3)
    jd = jdpdf.build(J(w))
    td = DiscretePDF(pmf=torch.tensor(np.asarray(jd.pmf)), cdf=torch.tensor(np.asarray(jd.cdf)))
    u = rng.uniform(size=5000).astype(np.float32)
    gi, gu = dpdf.sample_reuse(td, T(u))
    ri, ru = jdpdf.sample_reuse(jd, J(u))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))


def _env_image(h=16, w=32):
    rng = np.random.default_rng(3)
    img = rng.uniform(0.1, 1.0, (h, w, 3)).astype(np.float32)
    img[h // 3, w // 4] = 40.0  # a sun: a peaked distribution
    return img


def test_envmap_tables_match_jax():
    img, rad, euler = _env_image(), (1.2, 0.9, 0.7), (30.0, 60.0, 15.0)
    jt, jpick = jenvmap.build_tables(img, rad, euler)
    tt, tpick = envmap.build_tables(img, rad, euler)
    np.testing.assert_array_equal(tt.img.numpy(), np.asarray(jt.img))
    np.testing.assert_array_equal(tt.rot.numpy(), np.asarray(jt.rot))
    np.testing.assert_allclose(tpick.pmf.numpy(), np.asarray(jpick.pmf), rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(tpick.cdf.numpy(), np.asarray(jpick.cdf), rtol=0, atol=3e-7)
    assert tpick.cdf[-1] == pytest.approx(1.0, abs=1e-6)
    # a constant map: 1×1, uniform over the sphere
    const = envmap.constant_tables([0.3, 0.4, 0.5])
    np.testing.assert_array_equal(const.img.numpy(),
                                  np.asarray(jenvmap.constant_tables([0.3, 0.4, 0.5]).img))


@pytest.mark.parametrize("kind", ["image", "constant"])
def test_envmap_functions_match_jax(kind):
    if kind == "image":
        jt, jpick = jenvmap.build_tables(_env_image(), (1.2, 0.9, 0.7), (30.0, 60.0, 15.0))
    else:
        jt, jpick = jenvmap.constant_tables([0.3, 0.4, 0.5]), jdpdf.build(jnp.ones(1))
    tt = EnvmapTables(img=torch.tensor(np.asarray(jt.img)), rot=torch.tensor(np.asarray(jt.rot)))
    tpick = DiscretePDF(pmf=torch.tensor(np.asarray(jpick.pmf)),
                        cdf=torch.tensor(np.asarray(jpick.cdf)))
    rng = np.random.default_rng(6)
    n = 8192
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _lanes_close(envmap.eval_dir(tt, T(d)), jenvmap.eval_dir(jt, J(d)), "eval_dir")
    _lanes_close(envmap.pdf_dir(tt, tpick, T(d)), jenvmap.pdf_dir(jt, jpick, J(d)), "pdf_dir")
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    got = envmap.sample_dir(tt, tpick, T(u2))
    ref = jenvmap.sample_dir(jt, jpick, J(u2))
    for g, r, what in zip(got, ref, ("d", "pdf", "radiance")):
        _lanes_close(g, r, f"sample_dir {what}")
    # the sampled direction's pdf is the pdf of that direction
    _lanes_close(envmap.pdf_dir(tt, tpick, got[0]), got[1], "pdf of the sample")


# ---- config T: emitters, the normal-mapped frame, BSDFs, builders, films ---


def test_config_t_emitters_match_jax(config_t):
    js, _, _, _ = config_t
    ts = scene_from_numpy(jax.tree.map(np.asarray, js))
    em = ts.emitters
    assert sorted(em.type.tolist()) == [2, 2, 3] and 2 in em.geom_kind.tolist()
    assert ts.envmap.img.shape == (64, 128, 3)
    n = 8192
    rng = np.random.default_rng(8)
    em_id = rng.integers(-1, em.type.shape[0], n).astype(np.int32)
    ref_p = rng.uniform((-0.9, 0.05, -0.9), (0.9, 1.9, 0.9), (n, 3)).astype(np.float32)
    u3 = rng.uniform(size=(n, 3)).astype(np.float32)
    got = emitter.sample_emitter(ts, T(np.maximum(em_id, 0)), T(ref_p), T(u3))
    ref = jemitter.sample_emitter(js, J(np.maximum(em_id, 0)), J(ref_p), J(u3))
    for name in ("wi", "n", "pdf", "value", "shadow_maxt"):
        _lanes_close(getattr(got, name), getattr(ref, name), name)
    # an envmap sample's point is ref + 1e8·wi: compare it on the other lanes
    surf = np.asarray(js.emitters.type)[np.maximum(em_id, 0)] != 3
    _lanes_close(got.p[surf], np.asarray(ref.p)[surf], "p")
    # the sphere light's samples lie on its sphere, with its 1/area in the pdf
    sph = np.asarray(js.emitters.sphere_id)
    on = (np.maximum(em_id, 0) == int(np.argmax(sph))) & (em_id >= 0)
    c, r = js.geometry.sph_center[sph.max()], float(js.geometry.sph_radius[sph.max()])
    np.testing.assert_allclose(np.linalg.norm(got.p.numpy()[on] - np.asarray(c), axis=-1), r,
                               rtol=1e-5)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    p = got.p.numpy()
    _lanes_close(emitter.pdf_hit_emitter(ts, T(em_id), T(ref_p), T(p), T(nrm), T(d)),
                 jemitter.pdf_hit_emitter(js, J(em_id), J(ref_p), J(p), J(nrm), J(d)),
                 "pdf_hit_emitter")
    _lanes_close(emitter.pdf_envmap_direction(ts, T(d)), jemitter.pdf_envmap_direction(js, J(d)),
                 "pdf_envmap_direction")
    _lanes_close(emitter.eval_envmap(ts, T(d)), jemitter.eval_envmap(js, J(d)), "eval_envmap")


def test_normal_mapped_trace_matches_jax(config_t):
    js, _, _, _ = config_t
    ts = scene_from_numpy(jax.tree.map(np.asarray, js))
    assert ts.shapes.mapped and int((ts.shapes.normal_tex >= 0).sum()) == 1
    rng = np.random.default_rng(12)
    n = 8192
    o = rng.uniform((-0.5, 0.2, -0.5), (0.5, 1.8, 0.8), (n, 3)).astype(np.float32)
    target = np.stack([np.full(n, -1.0), rng.uniform(0, 2, n), rng.uniform(-1, 1, n)], -1)
    d = np.where(rng.uniform(size=(n, 1)) < 0.7, target - o, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = (o, d, np.full(n, 1e-4, np.float32), np.full(n, np.inf, np.float32))
    got = common.trace(ts, Ray(*map(T, rays)))
    ref = jcommon.trace(js, JRay(*map(J, rays)))
    mapped = np.asarray(js.shapes.normal_tex)[np.maximum(np.asarray(ref.its.shape), 0)] >= 0
    assert mapped.mean() > 0.5
    # the map moves the normal off the wall's own
    moved = np.abs(np.asarray(ref.frame.n)[mapped] - np.asarray(ref.its.n_s)[mapped]).max(-1)
    assert (moved > 0.05).mean() > 0.5
    for name in ("s", "t", "n"):
        _lanes_close(getattr(got.frame, name), getattr(ref.frame, name), f"frame {name}")
    for name in ("bsdf_id", "emitter_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    ga, gn = common.first_hit_aovs(ts, got)
    ra, rn = jcommon.first_hit_aovs(js, ref)
    _lanes_close(ga, ra, "albedo")
    _lanes_close(gn, rn, "normal")


def test_textured_bsdfs_match_jax(tmp_path):
    """Textured albedo through eval / pdf / sample for every BSDF type."""
    from optix_renderer_tpu_torch.utils.imageio import encode_png

    rng = np.random.default_rng(13)
    (tmp_path / "a.png").write_bytes(encode_png(rng.uniform(size=(9, 7, 3)).astype(np.float32)))
    checker = ('<texture type="checkerboard_color" name="albedo"><vector name="scale" '
               'value="0.3 0.2"/></texture>')
    png = ('<texture type="png_texture" name="albedo">'
           '<string name="filename" value="a.png"/></texture>')
    mats = [f'<bsdf type="diffuse">{checker}</bsdf>', f'<bsdf type="diffuse">{png}</bsdf>',
            '<bsdf type="mirror"/>', '<bsdf type="dielectric"/>',
            '<bsdf type="microfacet"><float name="alpha" value="0.2"/></bsdf>',
            f'<bsdf type="disney"><float name="roughness" value="0.4"/>{png}</bsdf>',
            f'<bsdf type="disney"><float name="metallic" value="0.3"/>{checker}</bsdf>']
    shapes = "".join(f'<shape type="sphere"><point name="center" value="{k} 0 0"/>{m}</shape>'
                     for k, m in enumerate(mats))
    (tmp_path / "b.xml").write_text(f"<scene>{shapes}</scene>")
    js, _, _ = jbuild.load_scene(str(tmp_path / "b.xml"))
    ts, _, _ = build.load_scene(tmp_path / "b.xml", device="cpu")
    assert set(ts.bsdfs.type.tolist()) == {0, 1, 2, 3, 4} and ts.textures.kinds == (1, 2)
    n = 8192

    def dirs():
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v[:, 2] = np.where(rng.uniform(size=n) < 0.8, np.abs(v[:, 2]), v[:, 2])
        return v.astype(np.float32)

    ids = rng.integers(0, len(mats), n).astype(np.int32)
    wi, wo = dirs(), dirs()
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    _lanes_close(bsdf.eval_bsdf(ts.bsdfs, ts.textures, T(ids), T(wi), T(wo), T(uv)),
                 jbsdf.eval_bsdf(js.bsdfs, js.textures, J(ids), J(wi), J(wo), J(uv)), "eval")
    _lanes_close(bsdf.pdf_bsdf(ts.bsdfs, ts.textures, T(ids), T(wi), T(wo), T(uv)),
                 jbsdf.pdf_bsdf(js.bsdfs, js.textures, J(ids), J(wi), J(wo), J(uv)), "pdf")
    got = bsdf.sample_bsdf(ts.bsdfs, ts.textures, T(ids), T(wi), T(uv), T(u2))
    ref = jbsdf.sample_bsdf(js.bsdfs, js.textures, J(ids), J(wi), J(uv), J(u2))
    for name in ("wo", "weight", "pdf", "eta"):
        _lanes_close(getattr(got, name), getattr(ref, name), f"sample {name}")


# fields of the port's tables that the JAX package does not have, or keeps in
# another form: the brute-force kernel's packed table, the LBVHs (None below
# their thresholds, where the JAX package keeps an empty table), the host
# flags and the voxel grids' padded shape (the JAX package keeps the dense grids)
_PORT_ONLY = {"tri_table", "bvh", "sph_bvh", "kinds", "mapped", "sphere_lights",
              "volume_lights", "depth", "grid"}


def _compare_fields(port, jax_tree, path=""):
    names = port._fields if isinstance(port, tuple) else [f.name for f in dataclasses.fields(port)]
    for name in names:
        if name in _PORT_ONLY:
            continue
        got, ref = getattr(port, name), getattr(jax_tree, name)
        where = f"{path}.{name}"
        if dataclasses.is_dataclass(got) or hasattr(got, "_fields"):  # tables, the photon map
            _compare_fields(got, ref, where)
        elif isinstance(got, torch.Tensor):
            ref = np.asarray(ref)
            assert tuple(got.shape) == ref.shape, where
            if where.endswith("_pick.cdf"):  # float64 against XLA's blocked float32 sums
                np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-7, err_msg=where)
            elif where.endswith("_pick.pmf"):
                np.testing.assert_allclose(got.numpy(), ref, rtol=2.5e-7, atol=0, err_msg=where)
            else:
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=where)
        else:
            assert got == int(np.asarray(ref)), where


def test_config_t_builders_agree(config_t):
    js, jc, ts, tc = config_t
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    _compare_fields(ts, js)
    assert ts.textures.kinds == (0, 1, 2) and ts.shapes.mapped and ts.emitters.sphere_lights
    assert ts.envmap_pick.pmf.shape == (64 * 128,)


@pytest.mark.parametrize("integrator", ["direct_mis", "path_mis"])
def test_config_t_film_matches_jax(config_t, integrator):
    js, jc, ts, tc = config_t
    jc = dataclasses.replace(jc, integrator=integrator, rfilter="box", max_depth=4)
    tc = dataclasses.replace(tc, integrator=integrator, rfilter="box", max_depth=4)
    ref = jrender(js, jc, sample_count=4, mega=False, wavefront=False)
    got = render(ts, tc, sample_count=4, device="cpu", mega=False)
    for layer in ("composite", "albedo", "normal"):
        a, b = np.asarray(ref[layer]), got[layer]
        rel = np.abs(a - b) / (np.abs(a) + 1e-3)
        assert np.median(rel) < 1e-3, (layer, np.median(rel))
        assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1), layer
