"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (3D temporal/height/width rotary), dynamic resolution. The vision
frontend is a STUB — inputs include precomputed patch embeddings.
[arXiv:2409.12191; hf] Served on the generic path
(``repro_torch.models.prefill`` takes ``patches`` and ``positions``).
"""
from repro_torch.config import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        mrope=True,
        frontend_embed_dim=1280,   # precomputed vision patch embeddings
        rope_theta=1_000_000.0,
        max_seq_len=32768,
    )
