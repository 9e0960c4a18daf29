"""optix_renderer_tpu_torch — the PyTorch / CUDA port of `optix_renderer_tpu`.

XML or preset scene in, film and EXR / PNG out, with the ten surface
integrators (normals, av, the direct family, preview, envmaptester,
`path_mats` and `path_mis`), constant, checkerboard and PNG textures,
normal maps, mesh and sphere area lights and constant or image envmaps.
`render()` dispatches as the JAX package does: a scene the path kernel
takes (up to 8,192 triangles, box / tent / gaussian filter, `path_mis` /
`path_mats`, none of the textures, normal maps, sphere lights or image
envmaps that `ops/cuda/mega.py: mega_unsupported` lists) runs through the regenerating path kernel `csrc/pathk.cu` (its small
branch up to 64 triangles, its medium branch above); every other scene
runs the general scan path, whose intersections go through the LBVH and
brute-force kernels of `csrc/isect.cu`. On a CUDA device the kernels
launch; on the CPU their plain torch versions run. Gradients of an image
loss (`parallel/shard.py: train_step`) and adaptive sampling
(`render/adaptive.py`) run on the scan path. The front end: the CLI
(`cli.py`: render, test, warptest, tonemap, train-denoiser), the
statistical `<test>` scenes (`validation/`) and the live view
(`serve.py`). The package imports torch, numpy and scipy, never JAX, and
builds its CUDA sources with `nvcc` at first use.
"""

__version__ = "0.2.0"
