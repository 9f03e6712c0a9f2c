from .ops import (SOURCE, gmm, gmm_plain, grouped_matmul, moe_ffn,
                  swiglu_gmm, swiglu_gmm_plain)

__all__ = ["SOURCE", "gmm", "gmm_plain", "grouped_matmul", "moe_ffn",
           "swiglu_gmm", "swiglu_gmm_plain"]
