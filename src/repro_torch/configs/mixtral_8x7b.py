"""Mixtral-8x7B — 8 experts top-2, sliding window. [arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig, MoECfg, register

CFG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, d_head=128, window=4096, rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=8, top_k=2), tie_embeddings=False,
    source="arXiv:2401.04088"))
