"""seamless-m4t-large-v2 [audio]: enc-dec, 24L each, d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. Multimodal; the speech frontend is a STUB — inputs
are precomputed frame embeddings. [arXiv:2308.11596; hf] Served on the
generic path through ``repro_torch.models.encdec``.
"""
from repro_torch.config import ModelConfig, register


@register("seamless-m4t-large-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,          # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,        # MHA (no GQA)
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        frontend_embed_dim=1024,  # precomputed audio frame embeddings
        max_seq_len=8192,
    )
