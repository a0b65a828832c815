"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA, 1 shared + 256 routed
experts top-8, expert_d_ff=2048, vocab 129280, MTP [arXiv:2412.19437].

First 3 layers are dense (d_ff=18432) per the published config. Adam optimizer
states for 671B params would not fit a training pod's memory, so this config
pins ``optimizer="adafactor"``, as the JAX package does. The MLA cache is the
compressed (c, k_rope) pair.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=18432,  # dense (first_k) layers' MLP width
        vocab_size=129280,
        head_dim=128,
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            expert_d_ff=2048,
            num_shared=1,
            shared_d_ff=2048,
            ep_axes=("model", "data"),  # 256-way EP on the full pod
        ),
        first_k_dense=3,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        mtp=True,
        optimizer="adafactor",
        remat="full",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b-reduced",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64, num_shared=1, shared_d_ff=64),
        first_k_dense=1,
        mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        ),
        mtp=True,
        optimizer="adafactor",
    )


register("deepseek-v3-671b", full, reduced)
