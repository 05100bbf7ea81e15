"""AdamW with global-norm clipping and a warmup-cosine schedule, over the
param dict, with explicit f32 moment state.

Same arithmetic as the JAX package's ``optim/adamw.py``.  That one builds
new trees each step; here params and moments are updated in place under
``torch.no_grad()``, so no second copy of the training state is ever
held.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar, steps taken
    m: Any
    v: Any


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (the order of the
    JAX package's tree leaves)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init(params) -> OptState:
    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine down to
    ``min_lr_frac`` of the peak (f32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, opt: OptState,
          grads) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on clipped grads; params, m and v are updated in
    place and returned with the advanced step and {"grad_norm", "lr"}."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.m),
                          leaves(opt.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p.sub_(lr * (upd + cfg.weight_decay * p))
    return params, OptState(step=step, m=opt.m, v=opt.v), \
        {"grad_norm": gn, "lr": lr}
