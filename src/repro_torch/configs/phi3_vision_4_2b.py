"""Phi-3-vision-4.2B — phi3-mini backbone + CLIP frontend (STUB: the dry-run
feeds precomputed patch embeddings [B, 576, d_model]).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="phi-3-vision-4.2b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32064, d_head=96, rope_theta=10000.0, frontend="vision",
    n_img_tokens=576, tie_embeddings=False,
    source="hf:microsoft/Phi-3-vision-128k-instruct"))
