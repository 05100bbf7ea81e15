"""Architecture registry of the port: the dense (qwen1.5, h2o-danube,
llama3, gemma2), moe (mixtral, dbrx) and rwkv6 families so far."""
from repro_torch.configs import (dbrx_132b, gemma2_2b,  # noqa: F401
                                 h2o_danube_1_8b, llama3_8b, mixtral_8x7b,
                                 qwen1_5_0_5b, rwkv6_7b)
from repro_torch.configs.base import ArchConfig, get, reduced  # noqa: F401
