"""What a run refuses: no card, too few cards, JAX in the process."""

from __future__ import annotations

import sys

# the JAX stack and the JAX package of this repository: a module whose
# top-level name (the part before the first dot) is one of these, whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optix_renderer_tpu")


class RunRefused(RuntimeError):
    """The run cannot give a result: no line is printed, the exit code is not 0."""


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is in FORBIDDEN. The comparison
    takes the whole name, so `optix_renderer_tpu_torch` passes."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def require_no_jax(names=None) -> None:
    found = forbidden_modules(names)
    if found:
        raise RunRefused(f"the process holds JAX or the JAX package: {', '.join(found[:20])}")


def require_cards(chips: int) -> None:
    """Refuse a run without as many CUDA cards as the cell asks for: the
    benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RunRefused("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise RunRefused(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
