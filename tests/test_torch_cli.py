"""The port's `render` and `train-denoiser` CLI on the CPU, its refusal to
fall back from CUDA, and that the port runs without importing JAX.

The denoiser runs: `render --denoise` (bilateral) and a scene's
`<denoiser>` write `<out>_denoised.exr` / `.png`, the bilateral pass with
the scene's sigma_d / sigma_vr / min(range, 3); `--denoise learned` without
a checkpoint warns and writes the bilateral filter's output; with one it
writes the net's; `train-denoiser` writes a checkpoint that the JAX
package loads.

The front end: `test` and `render` on a `<test>` root run the test on the
CPU and return 0, or 1 when a reference is wrong, with the JAX package's
messages; `tonemap` writes the PNG the JAX encoder writes for the EXR times
`--exposure`."""

import dataclasses
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml
from optix_renderer_tpu_torch.utils.imageio import read_exr, read_png, write_exr

REPO = Path(__file__).resolve().parents[1]


def test_render_cpu_writes_exr_and_png(tmp_path):
    xml = cornell_box_xml(tmp_path, width=16, height=12, spp=2)
    rc = cli.main(["render", str(xml), "--device", "cpu", "--spp", "2", "--size", "12x8",
                   "--depth", "3", "--integrator", "path_mats", "-o", str(tmp_path / "out")])
    assert rc == 0
    img = read_exr(tmp_path / "out.exr")
    assert img.shape == (8, 12, 3) and np.isfinite(img).all() and img.mean() > 0
    png = (tmp_path / "out.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (12, 8)  # IHDR width, height


def test_render_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xml = cornell_box_xml(tmp_path, width=8, height=6, spp=1)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["render", str(xml), "--device", "cuda"])
    assert not (tmp_path / "cbox.exr").exists()


def test_cpu_render_does_not_import_jax(tmp_path):
    """The path kernel's plain version, small and medium branch (a
    300-triangle scene), the scan path over the LBVH (the same scene with
    `mega=False`) and the photon mapper render, a BSDF `<test>` runs, and
    the denoisers, the live view and the CLI import, without JAX."""
    code = (
        "import dataclasses, sys\n"
        "from optix_renderer_tpu_torch.scene.presets import make_cornell_box\n"
        "from optix_renderer_tpu_torch.scene.presets import make_tessellated_cornell\n"
        "from optix_renderer_tpu_torch.render.render import render\n"
        "s, c, _ = make_cornell_box(8, 6, 1, device='cpu')\n"
        "out = render(s, c, sample_count=1, device='cpu')\n"
        "assert out['composite'].shape == (6, 8, 3)\n"
        "s, c, _ = make_tessellated_cornell(8, 6, 1, nu=12, nv=7, device='cpu')\n"
        "assert c.n_tris == 300 and s.geometry.bvh is not None\n"
        "c = dataclasses.replace(c, max_depth=3)\n"
        "out = render(s, c, sample_count=1, device='cpu')\n"
        "assert out['composite'].shape == (6, 8, 3) and (out['weights'] == 1.0).all()\n"
        "out = render(s, c, sample_count=1, device='cpu', mega=False)\n"
        "assert out['composite'].shape == (6, 8, 3) and (out['weights'] > 0).all()\n"
        "s, c, _ = make_cornell_box(8, 6, 1, 'photonmapper', device='cpu')\n"
        "c = dataclasses.replace(c, max_depth=3,\n"
        "                        iprops=(('photonCount', 2000), ('photonRadius', 0.2)))\n"
        "out = render(s, c, sample_count=1, device='cpu')\n"
        "import optix_renderer_tpu_torch.denoise.learned, optix_renderer_tpu_torch.cli\n"
        "import optix_renderer_tpu_torch.serve\n"
        "from optix_renderer_tpu_torch.scene.presets import TTEST_BSDFS, test_xml\n"
        "from optix_renderer_tpu_torch.validation import run_xml_test\n"
        "t = test_xml('.', 't.xml', 'ttest', {'angles': '0', 'references': '0.5'}, TTEST_BSDFS[:1])\n"
        "assert run_xml_test(t, verbose=False, sample_scale=0.01, device='cpu').ok\n"
        "assert out['composite'].mean() > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'optix_renderer_tpu.')))\n"
        "assert 'optix_renderer_tpu' not in sys.modules and not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _den_scene(tmp_path, den=""):
    """A 12×8 Cornell box, photon mapper, depth 3, 2,000 photons of radius
    0.15, with an optional scene `<denoiser>`."""
    xml = cornell_box_xml(tmp_path, width=12, height=8, spp=2, integrator="photonmapper")
    text = xml.read_text().replace('<integrator type="photonmapper"/>',
                                   '<integrator type="photonmapper">'
                                   '<integer name="photonCount" value="2000"/>'
                                   '<float name="photonRadius" value="0.15"/></integrator>')
    xml.write_text(text.replace("</scene>", den + "</scene>"))
    return xml


def _bilateral_ref(out_base, sigma_d=1.0, sigma_vr=0.6, inner_range=1):
    """The bilateral pass on the film the CLI wrote, as the CLI forms it."""
    from optix_renderer_tpu_torch.denoise.bilateral import denoise_bilateral
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.render.variance import variance_from_image
    from optix_renderer_tpu_torch.scene.build import load_scene

    scene, config, _ = load_scene(out_base.parent / "cbox.xml", device="cpu")
    out = render(scene, dataclasses.replace(config, max_depth=3), device="cpu")
    rgb = torch.from_numpy(out["composite"])
    film = torch.cat([rgb, torch.from_numpy(out["weights"])[..., None]], dim=-1)
    return denoise_bilateral(rgb, variance_from_image(film), sigma_d=sigma_d, sigma_vr=sigma_vr,
                             inner_range=inner_range).numpy()


def test_render_denoise_writes_denoised(tmp_path):
    xml = _den_scene(tmp_path)
    base = tmp_path / "out"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3", "--denoise",
                     "-o", str(base)]) == 0
    den = read_exr(str(base) + "_denoised.exr")
    assert den.shape == (8, 12, 3) and np.isfinite(den).all() and den.mean() > 0
    assert (tmp_path / "out_denoised.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_allclose(den, _bilateral_ref(base), rtol=1e-6, atol=1e-6)
    # no flag, no scene denoiser: no denoised output
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3",
                     "-o", str(tmp_path / "plain")]) == 0
    assert not (tmp_path / "plain_denoised.exr").exists()


def test_scene_denoiser_runs_without_flag(tmp_path):
    """`<denoiser type="simple">` is the bilateral filter with the scene's
    sigma_d, sigma_vr and range, capped at 3."""
    den = ('<denoiser type="simple"><float name="sigma_d" value="2.0"/>'
           '<float name="sigma_vr" value="0.9"/><integer name="range" value="7"/></denoiser>')
    xml = _den_scene(tmp_path, den)
    base = tmp_path / "out"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3",
                     "-o", str(base)]) == 0
    np.testing.assert_allclose(read_exr(str(base) + "_denoised.exr"),
                               _bilateral_ref(base, 2.0, 0.9, 3), rtol=1e-6, atol=1e-6)


def test_denoise_learned_without_checkpoint_uses_bilateral(tmp_path, capsys):
    xml = _den_scene(tmp_path)
    base = tmp_path / "out"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3", "--denoise",
                     "learned", "--denoiser-ckpt", str(tmp_path / "missing.npz"),
                     "-o", str(base)]) == 0
    assert "not found — falling back to bilateral" in capsys.readouterr().out
    np.testing.assert_allclose(read_exr(str(base) + "_denoised.exr"), _bilateral_ref(base),
                               rtol=1e-6, atol=1e-6)


def test_train_denoiser_checkpoint_loads_in_jax(tmp_path):
    """`train-denoiser` on the CPU writes a checkpoint that the JAX package
    loads, and `render --denoise learned` applies it."""
    import jax.numpy as jnp

    from optix_renderer_tpu.denoise import learned as jlearned
    from optix_renderer_tpu_torch.denoise import learned

    ck = tmp_path / "den.npz"
    assert cli.main(["train-denoiser", "--device", "cpu", "--steps", "2", "--size", "16",
                     "--clean-spp", "4", "-o", str(ck)]) == 0
    jp = jlearned.load_checkpoint(str(ck))
    tp = learned.load_checkpoint(ck, device="cpu")
    r = np.random.default_rng(0)
    img = [r.random((8, 12, 3), np.float32) for _ in range(3)]
    np.testing.assert_allclose(learned.apply(tp, *map(torch.from_numpy, img)).numpy(),
                               np.asarray(jlearned.apply(jp, *map(jnp.asarray, img))),
                               rtol=1e-5, atol=1e-5)
    xml = _den_scene(tmp_path)
    base = tmp_path / "out"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3", "--denoise",
                     "learned", "--denoiser-ckpt", str(ck), "-o", str(base)]) == 0
    den = read_exr(str(base) + "_denoised.exr")
    assert den.shape == (8, 12, 3) and np.isfinite(den).all() and (den >= 0).all()
    assert not np.allclose(den, _bilateral_ref(base), rtol=1e-3)


def _bsdf_test(tmp_path, references):
    return presets.test_xml(tmp_path, "t.xml", "ttest",
                            {"angles": "0, 60", "references": references, "sampleCount": 4000},
                            presets.TTEST_BSDFS[::3])


def test_test_and_render_run_test_roots(tmp_path, capsys, monkeypatch):
    """`test` and `render` on a `<test>` root (diffuse 0.5; glass
    F + (1 − F)·1.5046² / 1.000277²) print the JAX module's lines."""
    from optix_renderer_tpu.validation import run_xml_test as jrun_xml_test

    good = _bsdf_test(tmp_path, "0.5, 0.5, 2.211388, 2.149088")
    assert cli.main(["test", str(good), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    jrun_xml_test(good)
    assert out == capsys.readouterr().out and "Passed 4/4 tests." in out
    assert cli.main(["render", str(good), "--device", "cpu"]) == 0
    assert "Passed 4/4 tests." in capsys.readouterr().out
    assert not (tmp_path / "t.exr").exists()
    bad = _bsdf_test(tmp_path, "0.5, 0.6, 2.211388, 2.149088")
    assert cli.main(["render", str(bad), "--device", "cpu"]) == 1
    assert cli.main(["test", str(bad), "--device", "cpu", "--sample-scale", "0.5"]) == 1
    assert "Passed 3/4 tests." in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["test", str(good)])


def test_tonemap_matches_jax_encoder(tmp_path):
    from optix_renderer_tpu.utils.imageio import encode_png as jencode_png

    img = np.random.default_rng(1).random((6, 10, 4), np.float32) * 3
    write_exr(tmp_path / "a.exr", img)
    write_exr(tmp_path / "b.exr", img[..., :3])
    assert cli.main(["tonemap", str(tmp_path / "a.exr"), str(tmp_path / "b.exr"),
                     "--exposure", "0.5"]) == 0
    (tmp_path / "j.png").write_bytes(jencode_png(img[..., :3] * 0.5))
    want = read_png(tmp_path / "j.png")
    for name in ("a.png", "b.png"):
        np.testing.assert_array_equal(read_png(tmp_path / name), want)
