"""HuBERT-XLarge — encoder-only audio transformer (w2v2 arch); the conv
feature extractor is a STUB (precomputed frame embeddings [B, S, 512]).
No decode step (encoder). [arXiv:2106.07447]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120,
    vocab=504, d_head=80, causal=False, gated_mlp=False, act="gelu",
    norm="layer", frontend="audio", audio_in_dim=512,
    tie_embeddings=False, rope_theta=10000.0,
    source="arXiv:2106.07447"))
