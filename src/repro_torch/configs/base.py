"""ArchConfig — the architecture schema, kept as the port's own copy.

Same fields, properties and smoke-size reduction as the JAX package's
``configs/base.py``, so a config built here and one built there describe
the same model.  Per-layer attention windows are an int vector (-1 = full
causal); the vocab is padded to a multiple of 128.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_REGISTRY = {}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    group_size: int = 1024
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hymba | rwkv6 | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    window: int = -1               # SWA width for local layers (-1 = full)
    local_global_period: int = 0   # gemma2: every k-th layer is global
    full_attn_layers: Tuple[int, ...] = ()  # hymba: these layers are global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None      # gemma2 query_pre_attn_scalar
    post_norms: bool = False                # gemma2 post-block norms
    act: str = "silu"
    gated_mlp: bool = True
    embed_scale: bool = False               # gemma2: x *= sqrt(d)
    tie_embeddings: bool = True
    causal: bool = True
    moe: Optional[MoECfg] = None
    ssm_state: int = 16
    rwkv_head_dim: int = 64
    frontend: Optional[str] = None          # vision | audio
    n_img_tokens: int = 576
    audio_in_dim: int = 512
    norm: str = "rms"                       # rms | layer
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def sub_quadratic(self) -> bool:
        """May this arch run long_500k decode? True for SSM/hybrid and
        bounded-window (SWA) attention; gemma2's alternating stack counts
        (local layers ring-cached; sparse global layers sequence-sharded)."""
        if self.family in ("rwkv6", "hymba"):
            return True
        if self.family == "encoder":
            return False
        return self.window > 0  # SWA (incl. gemma2 local/global)

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def layer_windows(self) -> Tuple[int, ...]:
        """Static per-layer window vector."""
        out = []
        for i in range(self.n_layers):
            w = self.window
            if self.local_global_period and \
                    (i % self.local_global_period ==
                     self.local_global_period - 1):
                w = -1                       # global layer
            if i in self.full_attn_layers:
                w = -1
            out.append(w)
        return tuple(out)

    def params_count(self) -> int:
        """Approximate parameter count (the launcher's report)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dh, h, hkv = self.head_dim, self.n_heads, self.n_kv
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            per = 4 * d * d + d * d + (d * f + f * d + d * d)  # tm + cm
        else:
            attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
            if self.moe:
                ffn = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts
            else:
                ffn = (3 if self.gated_mlp else 2) * d * f
            per = attn + ffn
            if self.family == "hymba":
                per += 2 * d * 2 * d  # mamba in/out projections (approx)
        return emb + L * per

    def active_params_count(self) -> int:
        """Active (per-token) params — MoE counts top_k experts only."""
        if not self.moe:
            return self.params_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dh, h, hkv = self.head_dim, self.n_heads, self.n_kv
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        ffn = self.moe.top_k * 3 * d * f
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + ffn)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates registry)
    return _REGISTRY[name]


def names():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, n_layers: int = 2, d_model: int = 128,
            d_ff: int = 256, vocab: int = 512) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        d_head=d_model // n_heads,
        full_attn_layers=tuple(i for i in cfg.full_attn_layers
                               if i < n_layers))
    if cfg.moe:
        kw["moe"] = MoECfg(n_experts=min(cfg.moe.n_experts, 4),
                           top_k=min(cfg.moe.top_k, 2), group_size=64,
                           capacity_factor=2.0)
    if cfg.window > 0:
        kw["window"] = 32
    return dataclasses.replace(cfg, **kw)
