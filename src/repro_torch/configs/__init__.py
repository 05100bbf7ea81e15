"""Architecture registry of the port (llama3-8b and rwkv6-7b so far)."""
from repro_torch.configs import llama3_8b, rwkv6_7b  # noqa: F401
from repro_torch.configs.base import ArchConfig, get, reduced  # noqa: F401
