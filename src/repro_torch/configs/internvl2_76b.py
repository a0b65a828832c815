"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672,
vocab 128256 [arXiv:2404.16821]. LLM backbone (Llama-3-70B-class dims).

The InternViT front-end is a stub, as in the JAX package: (batch, 256,
d_model) patch embeddings take the place of the first 256 token positions.
Field for field the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500_000.0,
        frontend="vision",
        frontend_seq=256,
        remat="full",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        frontend="vision",
        frontend_seq=8,
    )


register("internvl2-76b", full, reduced)
