"""Denoisers: the cross-bilateral filter (`bilateral.py`) and the learned
conv net (`learned.py`), counterparts of `optix_renderer_tpu/denoise/`."""
