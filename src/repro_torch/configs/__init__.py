"""Model configurations of the port.  Importing this package registers
the dense LLM archs, the VLM (internvl2-1b), the enc-dec (whisper-tiny),
the MoE archs (moonshot-v1-16b-a3b, mixtral-8x7b, arctic-480b), the
xLSTM (xlstm-350m) and the Mamba hybrid (jamba-1.5-large-398b)
(``get_config`` / ``list_configs``); the AgileNN config lives in
``agilenn_cifar``.  ``ASSIGNED_ARCHS`` names the ten LLM archs in the JAX
package's order."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    internvl2_1b,
    jamba_1_5_large_398b,
    llama3_2_1b,
    mixtral_8x7b,
    moonshot_v1_16b_a3b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_tiny,
    xlstm_350m,
)
from repro_torch.configs.base import ArchConfig, get_config, list_configs  # noqa: F401

ASSIGNED_ARCHS = [
    "internvl2-1b",
    "moonshot-v1-16b-a3b",
    "qwen2-1.5b",
    "xlstm-350m",
    "jamba-1.5-large-398b",
    "arctic-480b",
    "qwen2-0.5b",
    "llama3.2-1b",
    "whisper-tiny",
    "mixtral-8x7b",
]
