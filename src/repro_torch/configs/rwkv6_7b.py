"""RWKV6-7B (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336,
    vocab=65536, d_head=64, rwkv_head_dim=64, rope_theta=None,
    tie_embeddings=False, source="arXiv:2404.05892"))
