"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936.

MoE: 128 experts, top-8, per-expert d_ff=768 (9.4 MB/expert bf16).
Served by the collaborative engine. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.config import ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=0,  # every FFN is MoE
        vocab_size=151936,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff=768),
        rope_theta=1_000_000.0,
        max_seq_len=131072,
    )
