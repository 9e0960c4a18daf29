"""Integrator registry of the general path: name → wavefront Li function.

Counterpart of `optix_renderer_tpu/integrators/__init__.py`. Every
integrator has the signature

    li(scene, config, ray, sampler) -> (L [N,3], albedo [N,3], normal [N,3], sampler)

The port has `path_mats` and `path_mis` so far; the JAX package's other
integrators raise `NotImplementedError` naming the ROADMAP item that ports
them.
"""

from optix_renderer_tpu_torch.integrators import path as _path

REGISTRY = {
    "path_mats": _path.li_path_mats,
    "path_mis": _path.li_path_mis,
}

# the JAX package's other integrators → the ROADMAP item that ports them
_NOT_YET = {
    **{name: "ROADMAP Queue 1 item 8 (integrators/simple.py)" for name in (
        "normals", "av", "direct", "direct_ems", "direct_mats", "direct_mis", "preview",
        "envmaptester")},
    "path_vol_mats": "ROADMAP Queue 1 item 9 (media)",
    "path_vol_mis": "ROADMAP Queue 1 item 9 (media)",
    "photonmapper": "ROADMAP Queue 1 item 13 (photon mapping)",
}


def get_integrator(name: str):
    if name in REGISTRY:
        return REGISTRY[name]
    if name in _NOT_YET:
        raise NotImplementedError(f"integrator '{name}' is not ported yet: {_NOT_YET[name]}")
    raise KeyError(f"unknown integrator '{name}'; available: {sorted(REGISTRY)}")
