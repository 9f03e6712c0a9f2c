"""Parameter partitioning rules: param tree -> spec tree (the port's
``sharding/partition.py``).

Rules are keyed on the leaf's path name and rank, as the reference's:

  wq/w1/w3/in_proj      [.., D, F]     -> shard F on "model"   (column)
  wo/w2/out_proj        [.., F, D]     -> shard F on "model"   (row)
  wk/wv (+bk/bv)        [.., D, Hk*hd] -> "model" iff divisible
  moe w1/w3/w2          [.., E, *, *]  -> shard E on "model"   (EP)
  embed/lm_head         [V, D]         -> shard V on "model"
  conv_w                [ci, K]        -> shard ci on "model" iff divisible
  norms/scalars                        -> replicated

A dim is sharded only if the axis size divides it; leading stack dims are
skipped (rules address dims from the right). :func:`opt_state_spec` also
shards the largest free dim over "data" (ZeRO-1). A spec is a plain tuple
of axis names or ``None``, ``()`` when replicated: it equals
``tuple(PartitionSpec(...))`` of the reference's. The rules read only the
path, the shape and the mesh's axis names and sizes (a
:class:`~repro_torch.sharding.ctx.Mesh` or anything with ``axis_names``
and a ``shape`` dict), so they hold for meshes no card can place on.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

Spec = Tuple[Any, ...]

COL = {"wq", "w1", "w3", "in_proj", "frontend_proj", "bq"}
ROW = {"wo", "w2", "out_proj"}
KV = {"wk", "wv", "bk", "bv"}
VOCAB = {"embed", "lm_head"}


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _divides(dim: int, mesh, axis: str) -> bool:
    n = _axis_size(mesh, axis)
    return n > 1 and dim % n == 0


def spec_for(path: Sequence[Any], shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of the leaf at ``path`` (its dict keys, outermost first)."""
    names = tuple(str(k) for k in path)
    leaf = names[-1]
    in_moe = "moe" in names
    nd = len(shape)
    spec: list = [None] * nd

    def set_if(dim_from_right: int, axis: str):
        i = nd - dim_from_right
        if 0 <= i < nd and _divides(shape[i], mesh, axis):
            spec[i] = axis

    if in_moe and leaf in ("w1", "w2", "w3"):
        set_if(3, "model")                      # expert dim (EP)
    elif leaf in COL:
        set_if(1, "model")
    elif leaf in ROW:
        set_if(2, "model")
    elif leaf in KV:
        set_if(1, "model")
    elif leaf in VOCAB:
        set_if(2, "model")
    elif leaf == "conv_w":
        set_if(2, "model")
    elif leaf == "router":
        pass                                    # replicated (small, fp32)
    if all(s is None for s in spec):            # canonical replicated form
        return ()
    return tuple(spec)


def param_specs_for(params: Any, mesh, _path: Tuple[str, ...] = ()) -> Any:
    """Param tree (nested dicts of tensors, or of anything with a
    ``shape``) -> the same tree of specs."""
    if isinstance(params, dict):
        return {k: param_specs_for(v, mesh, _path + (k,))
                for k, v in params.items()}
    return spec_for(_path, tuple(params.shape), mesh)


def opt_state_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: add "data" sharding on the largest free divisible dim."""
    n = _axis_size(mesh, "data")
    if n <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (s, d) in enumerate(zip(parts, shape)):
        if s is None and d % n == 0 and d > best_dim:
            best, best_dim = i, d
    if best >= 0:
        parts[best] = "data"
    return tuple(parts)
