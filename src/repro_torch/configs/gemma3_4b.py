"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local(sliding-window 1024):global attention interleave, 128k context.
Served on the generic path (a period of 6 attention layers, 4 of them in
the remainder: 34 = 5 x 6 + 4). [hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.config import ModelConfig, register


@register("gemma3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        window_pattern=(1024, 1024, 1024, 1024, 1024, -1),  # 5 local : 1 global
        rope_theta=1_000_000.0,
        logit_softcap=30.0,
        tie_embeddings=True,
        max_seq_len=131072,
    )
