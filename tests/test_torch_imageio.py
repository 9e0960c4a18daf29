"""The port's image reader (`utils/imageio.py: read_image`) against the JAX
package's, on files written by PIL into `tmp_path`.

* palette PNGs of 1-, 2-, 4- and 8-bit indices (decoded from the PLTE
  chunk, no PIL) and a JPG (through PIL) read bit for bit as the JAX
  `read_image` reads them;
* a 16-bit PNG still raises (the JAX package reads it through PIL's
  `convert("RGB")`, which clips it to nearly white);
* without PIL a JPG raises ImportError naming the file, and a PNG still
  reads;
* a scene whose texture is a palette PNG builds in both packages with the
  same image table.
"""

import sys

import numpy as np
import jax
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each
from PIL import Image

from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.utils.imageio import read_image as jread_image
from optix_renderer_tpu_torch.scene import build
from optix_renderer_tpu_torch.scene.data import scene_from_numpy
from optix_renderer_tpu_torch.utils.imageio import read_image


def _palette_png(path, bits, seed=0, h=7, w=13):
    """A palette PNG of `bits`-bit indices with a random 2^bits-entry PLTE;
    13 columns leave a partial last byte below 8 bits."""
    rng = np.random.default_rng(seed + bits)
    img = Image.fromarray(rng.integers(0, 1 << bits, (h, w)).astype(np.uint8), "P")
    img.putpalette(rng.integers(0, 256, 3 << bits).astype(np.uint8).tolist())
    img.save(path, bits=bits)
    with open(path, "rb") as f:
        head = f.read(29)
    assert head[24] == bits and head[25] == 3  # IHDR bit depth, colour type 3
    return path


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_matches_jax(tmp_path, bits):
    path = _palette_png(tmp_path / f"p{bits}.png", bits)
    got = read_image(path)
    assert got.shape == (7, 13, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jread_image(path))


def test_jpg_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "t.jpg"
    Image.fromarray(rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)).save(path, quality=90)
    np.testing.assert_array_equal(read_image(path), jread_image(path))


def test_16_bit_png_raises(tmp_path):
    path = tmp_path / "deep.png"
    Image.fromarray(np.full((4, 4), 41634, np.uint16)).save(path)
    with pytest.raises(ValueError, match="16-bit"):
        read_image(path)


def test_without_pil_other_formats_raise(tmp_path, monkeypatch):
    """PIL is imported only for the formats the port does not decode itself."""
    jpg = tmp_path / "t.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(jpg)
    png = _palette_png(tmp_path / "p.png", 4)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="t.jpg"):
        read_image(jpg)
    assert read_image(png).shape == (7, 13, 3)


def test_scene_with_palette_texture_builds_in_both(tmp_path):
    _palette_png(tmp_path / "tex.png", 4, h=8, w=6)
    png = ('<texture type="png_texture" name="albedo">'
           '<string name="filename" value="tex.png"/></texture>')
    (tmp_path / "s.xml").write_text(
        f'<scene><shape type="sphere"><bsdf type="diffuse">{png}</bsdf></shape></scene>')
    js, _, _ = jbuild.load_scene(str(tmp_path / "s.xml"))
    ts, _, _ = build.load_scene(tmp_path / "s.xml", device="cpu")
    carried = scene_from_numpy(jax.tree.map(np.asarray, js))
    assert ts.textures.image_data.shape[0] == 1
    for field in ("image_data", "image_hw", "image_id", "type"):
        assert torch.equal(getattr(ts.textures, field), getattr(carried.textures, field)), field
