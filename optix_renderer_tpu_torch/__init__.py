"""optix_renderer_tpu_torch — the PyTorch / CUDA port of `optix_renderer_tpu`.

XML or preset scene in, film and EXR / PNG out, with `path_mis` and
`path_mats`. `render()` dispatches as the JAX package does: a scene the
path kernel takes (up to 64 triangles, box / tent / gaussian filter) runs
through the regenerating path kernel `csrc/pathk.cu`; every other scene
runs the general scan path, whose intersections go through the LBVH and
brute-force kernels of `csrc/isect.cu`. On a CUDA device the kernels
launch; on the CPU their plain torch versions run. The package imports
torch and numpy, never JAX, and builds its CUDA sources with `nvcc` at
first use.
"""

__version__ = "0.2.0"
