"""Architecture registry of the port.  Importing this package registers the
configurations whose families the port's serving path covers (dense, the
moe family with MLA, ssm and hybrid); the other families of the JAX package
(audio, and the vlm's vision front-end) are registered when their modules
are ported (ROADMAP Queue A item 8)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    get_reduced_config,
    list_archs,
    register,
)

# One module per architecture, as in the JAX package.
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    granite_3_8b,
    granite_34b,
    granite_moe_3b_a800m,
    mamba2_780m,
    qwen15_110b,
    starcoder2_15b,
    zamba2_7b,
)
