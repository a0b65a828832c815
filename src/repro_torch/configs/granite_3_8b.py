"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800,
vocab 49155, GQA [hf:ibm-granite/granite-3.0 family]. SwiGLU."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
    )


register("granite-3-8b", full, reduced)
