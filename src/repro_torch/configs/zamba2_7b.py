"""zamba2-7b [hybrid] — 81 Mamba2 layers, d_model=3584, one weight-SHARED
attention block (32H MHA + d_ff=14336 MLP) applied every 6th layer
(14 applications), vocab 32000, ssm_state=64 [arXiv:2411.15242].

The shared block takes concat(x, x0) (x0 = embedding output) through an
input projection, runs attention+MLP, and adds back through an output
projection — one weight set reused across all applications (Zamba2's global
shared attention; per-application LoRA deltas are omitted, as in the JAX
package).  Field for field the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        head_dim=112,
        ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_width=4, chunk_size=256),
        attn_every=6,
        remat="full",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        ssm=SSMConfig(state_size=16, head_dim=16, expand=2, conv_width=4, chunk_size=32),
        attn_every=2,
    )


register("zamba2-7b", full, reduced)
