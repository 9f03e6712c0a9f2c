"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536. Mamba:attention 7:1 interleave; MoE 16 experts top-2 on every
other layer. [arXiv:2403.19887] Served on the generic path (a period of 8:
7 Mamba layers and 1 attention layer, each followed by a dense FFN or, on
odd layers, the MoE).
"""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig, register


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336),
        moe_every=2,
        moe_offset=1,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64),
        max_seq_len=262144,
    )
