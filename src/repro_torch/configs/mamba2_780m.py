"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, vocab 50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060].

Attention-free: the decode cache is a per-layer conv tail and SSM state,
O(1) in the context length.  Field for field the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        tie_embeddings=True,
        ssm=SSMConfig(state_size=16, head_dim=16, expand=2, conv_width=4, chunk_size=32),
    )


register("mamba2-780m", full, reduced)
