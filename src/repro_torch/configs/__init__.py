"""Model configurations of the port.  Importing this package registers
the dense LLM archs (``get_config`` / ``list_configs``); the AgileNN
config lives in ``agilenn_cifar``."""
from repro_torch.configs import llama3_2_1b, qwen2_0_5b, qwen2_1_5b  # noqa: F401
from repro_torch.configs.base import ArchConfig, get_config, list_configs  # noqa: F401
