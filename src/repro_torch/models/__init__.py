from .transformer import backbone, build_slots, init_params, init_state, \
    lm_logits

__all__ = ["backbone", "build_slots", "init_params", "init_state",
           "lm_logits"]
