"""A run of the harness with the timed path broken underneath reads `correct` false.

Each test skips the look for a card and drives the rest of a run (set-up,
window, reservoir, reference, check) on the CPU at a small size, with
`render` replaced by a faulty one. The cells have one card, so the fault
of a missing exchange between cards does not apply.
"""

import time

import numpy as np
import pytest
import torch

from harness.cell import run_cell

torch.set_num_threads(1)

SMALL = {
    "cbox-offline-512spp": {"scene": {"width": 16, "height": 12}, "traffic": {"spp": 16},
                            "check": {"pixels": 64}},
    "cbox-live-16spp": {"scene": {"width": 16, "height": 12}, "traffic": {"spp": 16},
                        "check": {"pixels": 64, "renders": 2}},
    "tess100k-scan-4spp": {"scene": {"width": 10, "height": 8, "nu": 80, "nv": 60},
                           "traffic": {"spp": 1}, "check": {"pixels": 16}},
}


def _render():
    from optix_renderer_tpu_torch.render.render import render

    return render


def unchanged(scene, config, sample_count, device):
    """A render whose steps leave the film as it started."""
    return _render()(scene, config, sample_count=0, device=device)


def half(scene, config, sample_count, device):
    """Half of the samples left out, the film the mean over the rest."""
    return _render()(scene, config, sample_count=max(sample_count // 2, 1), device=device)


def altered(scene, config, sample_count, device):
    """Every answer altered where it is produced: the composite's red off by 1e-3."""
    out = _render()(scene, config, sample_count=sample_count, device=device)
    out["composite"] = out["composite"] + np.float32(1e-3) * np.array([1, 0, 0], np.float32)
    return out


def _run(workload, render_fn, seed=2**31 + 5):
    return run_cell(workload, seed, 0.2, False, time.perf_counter(), device="cpu",
                    overrides=SMALL[workload], render_fn=render_fn, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    r = _run(workload, None)
    assert r["correct"] and r["failed"] == 0 and r["check"]["pixels_off"]["value"] == 0.0


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_run_is_not_correct(workload, fault):
    if fault is half and SMALL[workload]["traffic"]["spp"] == 1:
        fault = _half_of_the_pixels
    r = _run(workload, fault)
    assert not r["correct"], r["check"]


def _half_of_the_pixels(scene, config, sample_count, device):
    """At one sample per pixel, half of the batch is half of the pixels: the
    other half keep the film's start."""
    out = _render()(scene, config, sample_count=sample_count, device=device)
    for k in ("composite", "albedo", "normal"):
        out[k][1::2] = 0.0
    out["weights"][1::2] = 0.0
    return out


def test_a_render_that_raises_counts_as_failed():
    def broken(*a, **k):
        raise RuntimeError("boom")

    r = run_cell("cbox-live-16spp", 3, 0.2, False, time.perf_counter(), device="cpu",
                 overrides=SMALL["cbox-live-16spp"], log=lambda *a, **k: None,
                 render_fn=_first_call_only(broken))
    assert r["failed"] > 0 and not r["correct"]


def _first_call_only(broken):
    """The warm-up succeeds; every render of the window raises."""
    calls = []

    def fn(scene, config, sample_count, device):
        calls.append(1)
        if len(calls) == 1:
            return _render()(scene, config, sample_count=sample_count, device=device)
        return broken()

    return fn
