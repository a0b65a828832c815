"""Architecture registry of the port.  Importing this package registers the
ten architectures of the JAX package, one module each: every family the
port serves (dense, vlm, moe with MLA, ssm, hybrid and the audio
encoder-decoder)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    get_reduced_config,
    input_specs,
    list_archs,
    register,
)

# One module per architecture, as in the JAX package.
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    granite_3_8b,
    granite_34b,
    granite_moe_3b_a800m,
    internvl2_76b,
    mamba2_780m,
    qwen15_110b,
    starcoder2_15b,
    whisper_tiny,
    zamba2_7b,
)
