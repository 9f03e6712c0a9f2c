"""Mesh descriptions (the port's ``launch/mesh.py``).

The reference builds JAX meshes; the port describes them
(:class:`repro_torch.sharding.Mesh`): the partition rules compute specs
for any of them, and only the host mesh of one device takes placements.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 devices a pod ("data", "model"); two pods add a
    leading "pod" axis that only batch and gradient traffic crosses. A
    description: its specs can be computed, nothing placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1 x 1 ("data", "model") mesh of one device: ``cuda`` unless the
    caller asks for the CPU; a missing GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda'): no CUDA device "
                           "available; pass device='cpu'")
    return Mesh(("data", "model"), (1, 1), device=str(dev))
