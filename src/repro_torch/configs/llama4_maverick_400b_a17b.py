"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048. MoE: 128 experts top-1 + 1 shared expert, interleaved with
dense FFN layers (early-fusion multimodal backbone). Served on the generic
path (a period of 2: a dense-FFN layer, then an MoE layer).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,  # dense FFN on non-MoE layers
        vocab_size=202048,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192,
                      num_shared_experts=1),
        moe_every=2,   # interleaved: every other layer is MoE
        moe_offset=1,
        rope_theta=500_000.0,
        max_seq_len=131072,
    )
