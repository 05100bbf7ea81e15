"""DBRX-132B — fine-grained MoE: 16 experts, top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ArchConfig, MoECfg, register

CFG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
    vocab=100352, d_head=128, rope_theta=500_000.0,
    moe=MoECfg(n_experts=16, top_k=4), tie_embeddings=False,
    source="hf:databricks/dbrx-base"))
