"""Hymba-1.5B — hybrid head: parallel attention + mamba in every block;
SWA everywhere except 3 full-attention layers. [arXiv:2411.13676]
(Meta tokens omitted: they change no shape.)"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="hymba-1.5b", family="hymba",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504,
    vocab=32001, d_head=64, window=1024, full_attn_layers=(0, 15, 31),
    ssm_state=16, rope_theta=10000.0, tie_embeddings=True,
    source="arXiv:2411.13676"))
