"""Training loop: grad-accumulated microbatching, remat policies, optional
gradient compression and bf16 param casts, AdamW, straggler tracking.

The port's counterpart of the JAX package's ``train/trainer.py``.  The
step runs eagerly on one device (the card unless the caller asks for the
CPU); ``train_step(state, batch) -> (state, metrics)`` keeps the JAX
step's contract, with params and optimizer state updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.engine import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves, tree_map
from repro_torch.runtime.compression import roundtrip


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1          # gradient accumulation steps
    remat: str = "dots"            # none | dots | full
    attn_impl: str = "einsum"      # einsum | chunked | flash
    grad_compression: Optional[str] = None  # None | bf16 | int8
    streamed_loss: bool = False    # chunked cross-entropy
    loss_chunk: int = 512
    cast_params_bf16: bool = False  # matrices enter the step as bf16


def init_state(cfg: ArchConfig, gen: torch.Generator) -> TrainState:
    """Random params on the generator's device and zeroed AdamW state."""
    params = M.init_params(cfg, gen)
    return TrainState(params=params, opt=adamw.init(params))


def _fill(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def make_train_step(cfg: ArchConfig, tc: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics); ``batch`` is a
    dict of tensors on the params' device."""

    def loss(params, mb):
        if tc.cast_params_bf16:
            params = tree_map(
                lambda p: p.to(torch.bfloat16)
                if p.dtype == torch.float32 and p.dim() >= 2 else p, params)
        return M.loss_fn(cfg, params, mb, remat=tc.remat,
                         attn_impl=tc.attn_impl,
                         streamed_loss=tc.streamed_loss,
                         loss_chunk=tc.loss_chunk)

    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        lval, _ = loss(live, mb)
        # a leaf the loss never reads (an audio model's token embedding)
        # gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(lval, leaves(live), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves(live), grads)]
        return lval.detach(), _fill(params, iter(grads))

    def train_step(state: TrainState, batch: Dict):
        if tc.microbatches > 1:
            n = tc.microbatches
            b = next(iter(batch.values())).shape[0]
            if b % n:
                raise ValueError(f"batch {b} does not split into {n} "
                                 "microbatches")
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                            state.params)
            lsum = 0.0
            for i in range(n):
                mb = {k: x.reshape(n, b // n, *x.shape[1:])[i]
                      for k, x in batch.items()}
                lval, g = grad_fn(state.params, mb)
                for acc, gi in zip(leaves(gsum), leaves(g)):
                    acc.add_(gi)
                lsum = lsum + lval
            grads = tree_map(lambda g: g / n, gsum)
            lval = lsum / n
        else:
            lval, grads = grad_fn(state.params, batch)
        if tc.grad_compression:
            grads = roundtrip(grads, tc.grad_compression)
        params, opt, om = adamw.apply(tc.opt, state.params, state.opt, grads)
        return TrainState(params=params, opt=opt), {"loss": lval, **om}

    return train_step


def run(cfg: ArchConfig, tc: TrainConfig, data_iter, n_steps: int,
        state: Optional[TrainState] = None,
        gen: Optional[torch.Generator] = None, straggler=None,
        log_every: int = 10, log=print, device=None) -> TrainState:
    """Single-device training driver.  ``device`` None means the card
    (raises without one); a new state is drawn from ``gen`` (seed 0 on
    that device when None).  Step time is host time around the step,
    ending in a device synchronise."""
    device = resolve_device(device)
    if state is None:
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(cfg, gen)
    step_fn = make_train_step(cfg, tc)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda *a: None)
    for i in range(n_steps):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(np.asarray(x), device=device)
                 for k, x in next(data_iter).items()}
        state, metrics = step_fn(state, batch)
        sync(device)
        dt = time.perf_counter() - t0
        if straggler is not None:
            straggler.record(dt)
        if log_every and i % log_every == 0:
            log(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
    return state
