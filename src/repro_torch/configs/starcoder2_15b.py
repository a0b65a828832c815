"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576,
vocab 49152, GQA + RoPE [arXiv:2402.19173]. GELU (non-gated) MLP."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        activation="gelu",
        rope_theta=100_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
    )


register("starcoder2-15b", full, reduced)
