from . import encdec
from .model import decode_step, init_params, init_state, loss_fn, prefill
from .transformer import backbone, build_slots, lm_logits

__all__ = ["backbone", "build_slots", "decode_step", "encdec", "init_params",
           "init_state", "lm_logits", "loss_fn", "prefill"]
