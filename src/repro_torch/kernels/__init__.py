"""Hand-written Hopper kernels of the port, each beside its plain version.

``ALL`` names every kernel wrapper with its source and the TPU kernel it
replaces, for the launch counters and the on-card checks.
"""
from .moe_gmm import ops as _moe_ops

ALL = (
    dict(name="swiglu_gmm", wrapper=_moe_ops.swiglu_gmm,
         plain=_moe_ops.swiglu_gmm_plain, source=_moe_ops.SOURCE,
         replaces="src/repro/kernels/moe_gmm/moe_gmm.py:82"),
    dict(name="gmm", wrapper=_moe_ops.gmm, plain=_moe_ops.gmm_plain,
         source=_moe_ops.SOURCE,
         replaces="src/repro/kernels/moe_gmm/moe_gmm.py:41"),
)


def reset_launches() -> None:
    for k in ALL:
        k["wrapper"].launches = 0


def launches() -> dict:
    return {k["name"]: k["wrapper"].launches for k in ALL}
