"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152,
vocab 152064, QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        remat="full",
        optimizer="adafactor",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
    )


register("qwen1.5-110b", full, reduced)
