"""phi35-moe [moe] — the paper's second evaluation model.

32L d_model=4096 32H (GQA kv=8) vocab=32064; MoE 16 experts top-2,
per-expert d_ff=6400 (157 MB/expert bf16). Served by the collaborative
engine. [arXiv:2404.14219]
"""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("phi35-moe")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi35-moe",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=32064,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400),
        max_seq_len=131072,
    )
