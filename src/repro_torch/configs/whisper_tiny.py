"""whisper-tiny [audio] — enc-dec, 4+4L d_model=384 6H d_ff=1536,
vocab 51865 [arXiv:2212.04356]. LayerNorm + GELU + QKV bias, tied unembed.

The conv/mel front-end is a stub, as in the JAX package: the engine feeds
(batch, 1500, d_model) frame embeddings of zeros.  Positions are sinusoidal
on both sides (length-agnostic).  Field for field the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        qkv_bias=True,
        tie_embeddings=True,
        activation="gelu",
        encoder_layers=4,
        encoder_seq=1500,
        frontend="audio",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-reduced",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        activation="gelu",
        encoder_layers=2,
        encoder_seq=32,
        frontend="audio",
    )


register("whisper-tiny", full, reduced)
