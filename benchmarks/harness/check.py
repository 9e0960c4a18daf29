"""How `correct` is decided: films of the timed renders against the reference.

For each render that the check samples (drawn from the seed among all
the renders of the window), a sample of its pixels (drawn from the seed
too) is rendered again by the configuration's plain reference (its
`reference`, a `module:function` such as
`reference.pathtrace:reference_film`, called with the configuration's
`reference_args`) with the render's own seed and sample count, and every
layer the program returned there (composite, albedo, normal rgb and the
weights) is compared. A pixel is off where any of its values differs
from the reference's by more than `rel` × (|reference| + `floor`). The
number compared is `pixels_off`, the share of the sampled pixels that
are off; its limit is the check file's.

Why these tolerances: the reference repeats each path's arithmetic, so a
sound pixel differs only by the order of its float32 sums (under 1e-6 on
the card); a path that takes another branch moves its pixel by about
1/spp of a path's value, far above `rel` = 1e-4. `floor` = 1e-3 keeps
dark values and the normals' cancelling sums from reading as large
relative errors.
"""

from __future__ import annotations

import numpy as np

LAYERS = ("composite", "albedo", "normal")


def pixel_errors(prog: dict, ref: dict, pixels, floor: float) -> np.ndarray:
    """Largest relative error over the layers and channels of each pixel."""
    errs = []
    for k in LAYERS:
        a = np.asarray(prog[k]).reshape(-1, 3)[pixels]
        b = np.asarray(ref[k])
        errs.append((np.abs(a - b) / (np.abs(b) + floor)).max(axis=-1))
    a = np.asarray(prog["weights"]).reshape(-1)[pixels]
    b = np.asarray(ref["weights"])
    errs.append(np.abs(a - b) / (np.abs(b) + floor))
    e = np.max(np.stack(errs), axis=0)
    return np.where(np.isfinite(e), e, np.inf)


def sample_pixels(rng: np.random.Generator, n_pix: int, n: int) -> np.ndarray:
    return np.sort(rng.choice(n_pix, size=min(n, n_pix), replace=False))


def reference_of(config: dict):
    """The configuration's plain reference, found by its name:
    `film(xml, pixels, spp, seed, device, dtype)` → the layers at `pixels`."""
    from harness.manifest import resolve

    fn = resolve(config["reference"])
    args = dict(config.get("reference_args", {}), max_depth=int(config["max_depth"]))

    def film(xml, pixels, spp, seed, device="cpu", dtype=None):
        import torch

        return fn(xml, pixels, spp, seed, device=device,
                  dtype=torch.float32 if dtype is None else dtype, **args)

    return film


def judge(kept, xml, config: dict, check: dict, seed: int, device, dtype=None) -> dict:
    """Compare the kept renders [(film dict, render seed, spp)] with the
    reference. Returns {"pixels_off": share, "max_err", "median_err",
    "pixels"}; a run with nothing kept compares nothing and reads 1."""
    reference = reference_of(config)
    scene = config["scene"]
    n_pix = scene["width"] * scene["height"]
    rng = np.random.default_rng([seed & (2**64 - 1), 2])
    errs = []
    for film, r_seed, spp in kept:
        pix = sample_pixels(rng, n_pix, check["pixels"])
        ref = reference(xml, pix, spp, r_seed, device, dtype)
        errs.append(pixel_errors(film, ref, pix, check["floor"]))
    if not errs:
        return {"pixels_off": 1.0, "max_err": float("inf"), "median_err": float("inf"),
                "pixels": 0}
    e = np.concatenate(errs)
    return {"pixels_off": float((e > check["rel"]).mean()), "max_err": float(e.max()),
            "median_err": float(np.median(e)), "pixels": int(e.size)}
