"""H2O-Danube-1.8B — llama architecture + mistral sliding window.
[arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]"""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8, d_ff=6912,
    vocab=32000, d_head=80, window=4096, rope_theta=10000.0,
    tie_embeddings=False, source="arXiv:2401.16818"))
