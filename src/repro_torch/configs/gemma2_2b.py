"""Gemma2-2B — alternating local/global attention, logit softcaps,
pre+post norms, GeGLU, 256k vocab. [arXiv:2408.00118]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216,
    vocab=256000, d_head=256, window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0, attn_scale=256.0 ** -0.5,
    post_norms=True, act="gelu", embed_scale=True, tie_embeddings=True,
    rope_theta=10000.0, source="arXiv:2408.00118"))
