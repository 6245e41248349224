from .base import (PAPER_IDS, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig,
                   get_config, register)
