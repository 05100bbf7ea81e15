"""Llama-3-8B — GQA, 128k vocab, rope theta 500k. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, d_head=128, rope_theta=500_000.0,
    tie_embeddings=False, source="arXiv:2407.21783"))
