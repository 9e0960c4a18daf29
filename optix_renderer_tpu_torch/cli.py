"""Command-line interface: `render` a scene XML to EXR + PNG, and
`train-denoiser`.

Counterpart of the `render` and `train-denoiser` subcommands of
`optix_renderer_tpu/cli.py` (the headless `nori scene.xml` path,
src/utils/main.cpp:81-104), with the flags this package covers and
`--device`. A scene with `<sampler type="adaptive">` renders through
`render/adaptive.py` (unless `--no-adaptive`) and also writes
`<out>_variance.exr`. `--denoise [bilateral|learned]`, or a scene's
`<denoiser>` without the flag (`simple` is the bilateral filter), also
writes `<out>_denoised.exr` / `.png`. There is no fallback: `--device cuda`
without a GPU fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np


def cmd_render(args) -> int:
    from optix_renderer_tpu_torch.render.adaptive import render_adaptive
    from optix_renderer_tpu_torch.render.render import render, resolve_device
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.utils import imageio as iio

    device = resolve_device(args.device)
    scene, config, _ = load_scene(args.scene)
    overrides = {}
    if args.spp:
        overrides["sample_count"] = args.spp
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
        overrides["width"], overrides["height"] = w, h
    if args.integrator:
        overrides["integrator"] = args.integrator
    if args.depth:
        overrides["max_depth"] = args.depth
    if overrides:
        config = dataclasses.replace(config, **overrides)
    if args.resume and not args.checkpoint:
        print("warning: --resume has no effect without --checkpoint")

    out_base = Path(args.output) if args.output else Path(args.scene).with_suffix("")
    adaptive = config.adaptive and not args.no_adaptive
    print(f"Rendering {args.scene}: {config.width}x{config.height} @ "
          f"{config.sample_count}spp, integrator={config.integrator}, device={device}"
          + (" [adaptive]" if adaptive else ""))
    preview_cb = None
    if args.preview_every:
        def preview_cb(layers, spp_done):
            iio.write_png(str(out_base) + "_preview.png", layers["composite"])
            if args.verbose:
                print(f"  preview @ {spp_done}spp → {out_base}_preview.png")

    t0 = time.time()
    if adaptive:
        out = render_adaptive(scene, config, verbose=args.verbose, device=device)
    else:
        out = render(
            scene, config, device=device, verbose=args.verbose,
            preview_every=args.preview_every, preview_callback=preview_cb,
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    dt = time.time() - t0
    exr_path = out_base.with_suffix(".exr")
    iio.write_exr(exr_path, out["composite"])
    iio.write_png(out_base.with_suffix(".png"), out["composite"])
    if "variance" in out:
        iio.write_exr(str(out_base) + "_variance.exr",
                      out["variance"][..., None].repeat(3, axis=-1))
    denoise = args.denoise or {"simple": "bilateral"}.get(config.denoiser, config.denoiser)
    if denoise:
        den = _denoise(out, config, denoise, args.denoiser_ckpt, device)
        iio.write_exr(str(out_base) + "_denoised.exr", den)
        iio.write_png(str(out_base) + "_denoised.png", den)
    n_paths = out.get("samples_placed", config.width * config.height * config.sample_count)
    if adaptive:
        print(f"  adaptive: {n_paths} samples placed in "
              f"{n_paths // (config.width * config.height)} rounds")
    print(f"Done in {dt:.1f}s ({n_paths / dt / 1e6:.2f} Mpaths/s) → {exr_path}")
    return 0


def _denoise(out: dict, config, mode: str, ckpt: str, device) -> np.ndarray:
    """The denoised composite [H,W,3] of a render's layers `out`, on `device`
    (cli.py:152-204 of the JAX package)."""
    import os

    import torch

    from optix_renderer_tpu_torch.denoise import learned
    from optix_renderer_tpu_torch.denoise.bilateral import denoise_bilateral
    from optix_renderer_tpu_torch.render.render import _norm_ckpt_path
    from optix_renderer_tpu_torch.render.variance import variance_from_image

    def dev(key):
        return torch.as_tensor(np.asarray(out[key], np.float32)).to(device)

    if mode == "learned" and not os.path.exists(_norm_ckpt_path(ckpt)):
        # the JAX package's documented behaviour for a missing checkpoint:
        # the bilateral filter, on the same device, said on stdout
        print(f"warning: denoiser checkpoint {_norm_ckpt_path(ckpt)} not found — "
              "falling back to bilateral (train one with `train-denoiser`)")
        mode = "bilateral"
    if mode == "learned":
        params = learned.load_checkpoint(ckpt, device)
        den = learned.apply(params, dev("composite"), dev("albedo"), dev("normal"))
    else:
        # the variance of the film as the JAX CLI forms it: the composite
        # beside the filter weights, divided once more by them
        film = torch.cat([dev("composite"), dev("weights")[..., None]], dim=-1)
        den = denoise_bilateral(
            dev("composite"), variance_from_image(film),
            sigma_d=float(config.dprop("sigma_d", 1.0)),
            sigma_vr=float(config.dprop("sigma_vr", 0.6)),
            inner_range=min(int(config.dprop("range", 1)), 3),
        )
    return den.detach().cpu().numpy()


def cmd_train_denoiser(args) -> int:
    """Train the learned denoiser on self-rendered noisy / clean pairs of each
    `--scene` (repeatable; default the built-in Cornell box) at `--size`
    wide, 3/4 as high, and save the checkpoint (cli.py:213-257 of the JAX
    package)."""
    from optix_renderer_tpu_torch.denoise import learned
    from optix_renderer_tpu_torch.render.render import resolve_device
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    device = resolve_device(args.device)
    scenes = []
    for path in args.scene or ():
        scene, config, _ = load_scene(path)
        scenes.append((path, scene, dataclasses.replace(config, width=args.size,
                                                        height=args.size * 3 // 4)))
    if not scenes:
        scene, config, _ = make_cornell_box(width=args.size, height=args.size * 3 // 4, spp=1)
        scenes.append(("cornell(builtin)", scene, config))
    pairs = []
    for name, scene, config in scenes:
        print(f"rendering training pairs from {name}…")
        pairs += learned.render_training_pairs(scene, config, spps=(2, 4),
                                               clean_spp=args.clean_spp, device=device)
    print(f"training on {len(pairs)} pairs, {args.steps} steps, device={device}…")
    params, losses = learned.train(pairs, steps=args.steps, verbose=True, device=device)
    learned.save_checkpoint(args.output, params)
    print(f"loss {losses[0]:.5f} → {losses[-1]:.5f}; saved {args.output}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="optix_renderer_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene XML")
    pr.add_argument("scene")
    pr.add_argument("-o", "--output", help="output basename (default: scene name)")
    pr.add_argument("--spp", type=int, help="override sample count")
    pr.add_argument("--size", help="override resolution, e.g. 800x600")
    pr.add_argument("--integrator", help="override integrator: normals, av, direct, direct_ems, "
                    "direct_mats, direct_mis, preview, envmaptester, path_mats, path_mis, "
                    "path_vol_mats, path_vol_mis, photonmapper")
    pr.add_argument("--depth", type=int, help="max path depth")
    pr.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda launches the CUDA kernels; cpu runs their plain torch versions")
    pr.add_argument("--preview-every", type=int, default=0, metavar="K",
                    help="write a progressive preview PNG every K samples")
    pr.add_argument("--checkpoint", metavar="PATH", help="accumulator snapshot path")
    pr.add_argument("--checkpoint-every", type=int, default=8, metavar="K",
                    help="snapshot every K samples (with --checkpoint)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint if it exists")
    pr.add_argument("--no-adaptive", action="store_true",
                    help="render a <sampler type=\"adaptive\"> scene uniformly")
    pr.add_argument("--denoise", nargs="?", const="bilateral", choices=["bilateral", "learned"],
                    default=None, help="also write <out>_denoised: bilateral (simple.cpp) or "
                    "learned (the AI-denoiser analog)")
    pr.add_argument("--denoiser-ckpt", default="denoiser.npz",
                    help="checkpoint for --denoise learned")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)
    pd = sub.add_parser("train-denoiser", help="train the learned denoiser on self-rendered pairs")
    pd.add_argument("--scene", action="append",
                    help="scene XML, repeatable (default: the built-in Cornell box)")
    pd.add_argument("-o", "--output", default="denoiser.npz")
    pd.add_argument("--steps", type=int, default=300)
    pd.add_argument("--size", type=int, default=128)
    pd.add_argument("--clean-spp", type=int, default=256)
    pd.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda renders and trains on the GPU; cpu on the CPU")
    pd.set_defaults(fn=cmd_train_denoiser)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
