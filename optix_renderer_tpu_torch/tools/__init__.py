"""Probe entry points, the counterparts of the JAX package's Pallas probes
under `tools/`: `python -m optix_renderer_tpu_torch.tools.probe_copy` and
`python -m optix_renderer_tpu_torch.tools.prof_parts`. Both need a CUDA GPU."""
