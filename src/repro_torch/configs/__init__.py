"""Model configurations of the port.  Importing this package registers
the dense LLM archs, the VLM (internvl2-1b) and the enc-dec
(whisper-tiny) (``get_config`` / ``list_configs``); the AgileNN config
lives in ``agilenn_cifar``."""
from repro_torch.configs import (  # noqa: F401
    internvl2_1b,
    llama3_2_1b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_tiny,
)
from repro_torch.configs.base import ArchConfig, get_config, list_configs  # noqa: F401
