"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert_d_ff=512,
vocab 49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0 family].

The header's "40e top-8" is taken as authoritative over the trailing
"32 experts" gloss, as in the JAX package. Experts are config-padded 40 → 48
so the expert axis divides a 16-way "model" mesh axis; the 8 padding experts
are masked in the router.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512, padded_experts=48),
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=128),
    )


register("granite-moe-3b-a800m", full, reduced)
