"""Model configurations of the port.  Importing this package registers
the dense LLM archs, the VLM (internvl2-1b), the enc-dec (whisper-tiny),
the MoE archs (moonshot-v1-16b-a3b, mixtral-8x7b, arctic-480b) and the
xLSTM (xlstm-350m) (``get_config`` / ``list_configs``); the AgileNN
config lives in ``agilenn_cifar``."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    internvl2_1b,
    llama3_2_1b,
    mixtral_8x7b,
    moonshot_v1_16b_a3b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_tiny,
    xlstm_350m,
)
from repro_torch.configs.base import ArchConfig, get_config, list_configs  # noqa: F401
