"""optix_renderer_tpu_torch — the PyTorch / CUDA port of `optix_renderer_tpu`.

It renders what the JAX package's regenerating path kernel renders, for
scenes of up to 64 triangles: XML or preset scene in, film and EXR / PNG
out. On a CUDA device the path kernel is the hand-written CUDA kernel in
`csrc/pathk.cu`; on the CPU it is the kernel's plain torch version. The
package imports torch and numpy, never JAX, and builds its CUDA sources
with `nvcc` at first use.
"""

__version__ = "0.1.0"
