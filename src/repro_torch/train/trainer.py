"""Training loop: grad-accumulated microbatching, remat policies, optional
gradient compression and bf16 param casts, AdamW, checkpoint-restart,
straggler tracking, and data-parallel steps over a mesh of ranks.

The port's counterpart of the JAX package's ``train/trainer.py``.  The
step runs eagerly on one device (the card unless the caller asks for the
CPU), or on each rank of a (data, 1) mesh with the gradients exchanged
over ``torch.distributed``; ``train_step(state, batch) -> (state,
metrics)`` keeps the JAX step's contract, with params and optimizer state
updated in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
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


def make_train_step(cfg: ArchConfig, tc: TrainConfig, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics); ``batch`` is a
    dict of tensors on the params' device.

    With ``mesh`` (a ``launch.mesh.Mesh`` of shape (data, 1)) the step is
    data-parallel: every rank is handed the same global batch of B rows
    and takes rows [r B / n, (r + 1) B / n) of it, r its data index; the
    ranks' gradients and losses travel in one buffer a step (list-form
    all-gather), and every rank adds them in rank order from zeros and
    divides by n (:func:`exchange`).  With one microbatch a rank, n ranks
    give the bits of one device at ``microbatches=n``.  A mesh of one rank
    takes the single-device step."""
    n_data = 1
    if mesh is not None:
        n_data, n_model = mesh.shape
        if n_model != 1:
            raise NotImplementedError(
                f"training on a mesh with a model axis of {n_model}: "
                "tensor-parallel training needs a banded backward, not "
                "ported yet (ROADMAP queue 1 item 8); train on a "
                "(data, 1) mesh")

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

    def accumulate(params, batch, n):
        """(loss, grads) of one microbatch, or their sums over ``n``
        microbatches (added in order from zeros)."""
        if n == 1:
            return grad_fn(params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             "microbatches")
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = 0.0
        for i in range(n):
            mb = {k: x.reshape(n, b // n, *x.shape[1:])[i]
                  for k, x in batch.items()}
            lval, g = grad_fn(params, mb)
            for acc, gi in zip(leaves(gsum), leaves(g)):
                acc.add_(gi)
            lsum = lsum + lval
        return lsum, gsum

    def train_step(state: TrainState, batch: Dict):
        n = tc.microbatches
        if mesh is not None:                # this data rank's rows
            b = next(iter(batch.values())).shape[0]
            if b % n_data:
                raise ValueError(f"global batch {b} does not split over "
                                 f"{n_data} data ranks")
            r, w = mesh.coords[0], b // n_data
            batch = {k: x[r * w:(r + 1) * w] for k, x in batch.items()}
        lval, grads = accumulate(state.params, batch, n)
        if n > 1:
            grads = tree_map(lambda g: g / n, grads)
            lval = lval / n
        if n_data > 1:
            from repro_torch.shard import comm
            lval, grads = exchange(lval, grads, tc.grad_compression, n_data,
                                   comm.all_gather_list)
        elif tc.grad_compression:
            grads = roundtrip(grads, tc.grad_compression)
        params, opt, om = adamw.apply(tc.opt, state.params, state.opt, grads)
        return TrainState(params=params, opt=opt), {"loss": lval, **om}

    return train_step


def exchange(lval, grads, scheme, n_data, gather):
    """Every data rank's (loss, grads) through the wire, added in rank
    order from zeros and divided by ``n_data``.  The loss and the grads,
    or with ``scheme`` their compressed payload (``compress_grads``, as
    ``roundtrip`` compresses them: no error feedback), travel packed in
    one buffer; ``gather(buf, None)`` returns every rank's buffer in rank
    order, and every rank decompresses each before the sum.  At one rank
    this is ``roundtrip``'s result bit for bit."""
    from repro_torch.runtime import compression
    from repro_torch.shard import comm
    if scheme is None:
        payload = [g.float() for g in leaves(grads)]
    elif scheme == "int8":
        encs = compression.payload_leaves(
            compression.compress_grads(grads, scheme))
        payload = [t for enc in encs for t in (enc["q"], enc["scale"])]
    else:
        payload = leaves(compression.compress_grads(grads, scheme))
    like = [lval.float().reshape(())] + payload
    gsum = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in leaves(grads)]
    lsum = torch.zeros((), dtype=torch.float32, device=lval.device)
    for buf in gather(comm.pack(like), None):
        parts = comm.unpack(buf, like)
        lsum = lsum + parts[0]
        if scheme == "int8":
            dec = [compression.int8_decode({"q": q, "scale": s}, g.shape)
                   for q, s, g in zip(parts[1::2], parts[2::2], gsum)]
        else:
            dec = [p.float() for p in parts[1:]]
        for acc, g in zip(gsum, dec):
            acc.add_(g)
    return lsum / n_data, _fill(grads, (g / n_data for g in gsum))


def params_agree(params, mesh) -> bool:
    """Whether every rank of ``mesh`` holds the same params, bit for bit
    (one all-gather of their bytes)."""
    from repro_torch.shard import comm
    if mesh is None or not mesh.backend:
        return True
    return comm.all_equal(comm.pack(leaves(params)))


def save_checkpoint(mgr, step: int, state: TrainState, data_iter,
                    mesh=None) -> None:
    """``mgr.save`` of ``state`` at ``step`` with the data iterator's state
    as ``extra["data"]``; on a mesh, after checking that every rank holds
    the same params, by rank 0 alone."""
    if not params_agree(state.params, mesh):
        raise RuntimeError(f"the data-parallel ranks' params differ at "
                           f"step {step}")
    if mesh is None or mesh.rank == 0:
        mgr.save(step, state, extra={"data": data_iter.state()})


def run(cfg: ArchConfig, tc: TrainConfig, data_iter, n_steps: int,
        state: Optional[TrainState] = None,
        gen: Optional[torch.Generator] = None, straggler=None,
        log_every: int = 10, log=print, device=None, ckpt_mgr=None,
        ckpt_every: int = 0, mesh=None) -> TrainState:
    """The training loop.  ``device`` None means the card (raises without
    one); a new state is drawn from ``gen`` (seed 0 on that device when
    None).  Step time is host time around the step, ending in a device
    synchronise.  ``ckpt_mgr`` (a ``checkpoint.CheckpointManager``) saves
    the state every ``ckpt_every`` steps at its optimizer step, with the
    data iterator's state as ``extra["data"]``.  With ``mesh`` the steps
    are data-parallel over its ranks (``data_iter`` gives every rank the
    global batch; ``device`` is the mesh's) and, before each save, the
    ranks' params are checked equal; rank 0 saves."""
    device = mesh.device if mesh is not None else resolve_device(device)
    if state is None:
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        state = init_state(cfg, gen)
    step_fn = make_train_step(cfg, tc, mesh=mesh)
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
        if ckpt_mgr is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_mgr, int(state.opt.step), state, data_iter,
                            mesh)
    return state
