"""Mesh context for sharding constraints (the port's ``sharding/ctx.py``).

A :class:`Mesh` here is a description: axis names, their sizes and, for a
mesh of one device, that device. The partition rules
(:mod:`repro_torch.sharding.partition`) compute specs for any mesh, the
production meshes included (:mod:`repro_torch.launch.mesh`); nothing is
placed on a mesh of more than one device, which one card does not have.

:func:`constrain` takes logical axis tuples, as the reference's does. With
no mesh active, or a mesh of size 1, it returns its input unchanged (the
reference's no-op); under a larger mesh it raises
``NotImplementedError``. The port's models do not call it: at world size
1 every call would be a dead one.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

_CURRENT_MESH: Optional["Mesh"] = None


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh (the reference's
    ``jax.sharding.Mesh`` as far as the rules read it); ``device`` is where
    a mesh of size 1 places arrays."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: str = "cuda"

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Mesh
    spec: Spec


def set_current_mesh(mesh: Optional[Mesh]):
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def require_one_device(mesh: Mesh, what: str) -> None:
    """Placement on more than one device is not ported: raise for it."""
    if mesh.size > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size} devices "
            f"({mesh.shape}): the port places on one device only")


def _filter_spec(spec: Spec, mesh: Mesh) -> Spec:
    """Drop mesh axes this mesh lacks (e.g. 'pod' on a single pod)."""
    names = set(mesh.axis_names)
    out = []
    for ax in spec:
        if ax is None:
            out.append(None)
        elif isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in names)
            out.append(kept if kept else None)
        else:
            out.append(ax if ax in names else None)
    return tuple(out)


def batch_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    mesh = mesh or _CURRENT_MESH
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def constrain(x, *spec: Axis):
    """``x`` unchanged under no mesh or a mesh of size 1; a larger mesh
    raises (its constraint would place ``x`` across devices)."""
    mesh = _CURRENT_MESH
    if mesh is not None:
        require_one_device(mesh, "constrain")
    return x


def constrain_sp(x):
    """The sequence-parallel residual stream: as :func:`constrain`,
    unchanged at size 1 and raising on a larger mesh."""
    mesh = _CURRENT_MESH
    if mesh is not None:
        require_one_device(mesh, "constrain_sp")
    return x


def named(mesh: Mesh, *spec: Axis) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(spec, mesh))
