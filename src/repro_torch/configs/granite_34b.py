"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1, i.e. MQA)
d_ff=24576, vocab 49152, code model [arXiv:2405.04324]. GELU MLP."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        activation="gelu",
        remat="full",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-34b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
    )


register("granite-34b", full, reduced)
