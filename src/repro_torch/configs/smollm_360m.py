"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model. Served on the generic path (attention +
dense SwiGLU FFN, tied embeddings). [hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.config import ModelConfig, register


@register("smollm-360m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        max_seq_len=8192,
    )
