from .adamw import (AdamWState, adamw_update, clip_by_global_norm,
                    compress_int8, decompress_int8, global_norm,
                    init_opt_state, lr_schedule, maybe_compress_grads)
from .train_step import make_train_step

__all__ = ["AdamWState", "adamw_update", "clip_by_global_norm",
           "compress_int8", "decompress_int8", "global_norm",
           "init_opt_state", "lr_schedule", "maybe_compress_grads",
           "make_train_step"]
