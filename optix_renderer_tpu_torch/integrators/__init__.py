"""Integrator registry of the general path: name → wavefront Li function.

Counterpart of `optix_renderer_tpu/integrators/__init__.py`. Every
integrator has the signature

    li(scene, config, ray, sampler) -> (L [N,3], albedo [N,3], normal [N,3], sampler)

The port has all thirteen integrators of the JAX package: the ten surface
integrators, the single-bounce ones of `simple.py` and `path_mats` /
`path_mis`; the volumetric `path_vol_mats` / `path_vol_mis` of
`volpath.py`; and the photon mapper of `pmap.py`, whose map
`render.preprocess` builds before the render.
"""

from optix_renderer_tpu_torch.integrators import path as _path
from optix_renderer_tpu_torch.integrators import pmap as _pmap
from optix_renderer_tpu_torch.integrators import simple as _simple
from optix_renderer_tpu_torch.integrators import volpath as _volpath

REGISTRY = {
    "normals": _simple.li_normals,
    "av": _simple.li_av,
    "direct": _simple.li_direct,
    "direct_ems": _simple.li_direct_ems,
    "direct_mats": _simple.li_direct_mats,
    "direct_mis": _simple.li_direct_mis,
    "preview": _simple.li_preview,
    "envmaptester": _simple.li_envmaptester,
    "path_mats": _path.li_path_mats,
    "path_mis": _path.li_path_mis,
    "path_vol_mats": _volpath.li_path_vol_mats,
    "path_vol_mis": _volpath.li_path_vol_mis,
    "photonmapper": _pmap.li_photonmapper,
}


def get_integrator(name: str):
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown integrator '{name}'; available: {sorted(REGISTRY)}")
