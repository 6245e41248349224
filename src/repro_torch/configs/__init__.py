from .base import (ARCH_IDS, PAPER_IDS, ModelConfig, MoEConfig, RGLRUConfig,
                   SSMConfig, get_config, register)
