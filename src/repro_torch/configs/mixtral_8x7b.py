"""mixtral-8x7b [moe] — the paper's primary evaluation model.

32L d_model=4096 32H (GQA kv=8) vocab=32000; MoE 8 experts top-2,
per-expert d_ff=14336 (352 MB/expert bf16). [arXiv:2401.04088]
"""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=32000,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
        rope_theta=1_000_000.0,
        max_seq_len=32768,
    )
