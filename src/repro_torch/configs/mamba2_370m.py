"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128. SSD (state-space duality) blocks. [arXiv:2405.21060]
"""
from repro_torch.config import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        layer_pattern=("mamba",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        tie_embeddings=True,
        max_seq_len=1048576,
    )
