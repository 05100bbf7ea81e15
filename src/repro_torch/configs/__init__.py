"""Architecture registry of the port: all ten of the JAX package's
architectures (dense, moe, hymba, rwkv6 and encoder families)."""
from repro_torch.configs import (dbrx_132b, gemma2_2b,  # noqa: F401
                                 h2o_danube_1_8b, hubert_xlarge, hymba_1_5b,
                                 llama3_8b, mixtral_8x7b, phi3_vision_4_2b,
                                 qwen1_5_0_5b, rwkv6_7b)
from repro_torch.configs.base import (ArchConfig, get, names,  # noqa: F401
                                      reduced)
