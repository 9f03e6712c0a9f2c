"""PyTorch + CUDA port of the collaborative MoE serving system.

The JAX package ``repro`` is the reference; this package imports none of
it (nor JAX). Entry points: :func:`repro_torch.serving.build` (also
re-exported here) and ``python -m repro_torch.launch.serve``. Both run on
the GPU unless the caller asks for ``device="cpu"``.
"""
from .serving import build

__all__ = ["build"]
