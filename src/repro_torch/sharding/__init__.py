"""Sharding at world size 1: the partition rules as pure functions of
path, shape and mesh, and the mesh context whose constraints are
identities on one device."""
from .ctx import (Mesh, NamedSharding, batch_axes, constrain, constrain_sp,
                  current_mesh, named, set_current_mesh, use_mesh)
from .partition import opt_state_spec, param_specs_for, spec_for

__all__ = ["Mesh", "NamedSharding", "batch_axes", "constrain",
           "constrain_sp", "current_mesh", "named", "set_current_mesh",
           "use_mesh", "opt_state_spec", "param_specs_for", "spec_for"]
