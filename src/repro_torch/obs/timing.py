"""`obs.timeit` — the port's best-of-N wall timer for kernels and steps.

One warmup call to absorb the first launch (a kernel library's build and
load, cuBLAS handles), then ``reps`` samples of ``inner`` back-to-back
calls with the best per-call mean kept.  A CUDA launch returns before the
card finishes, so each sample ends in ``torch.cuda.synchronize()`` on the
device of the result before the clock is read; a CPU result needs no
wait.  Sub-millisecond kernels need the inner loop, and min-of-reps is
the usual noise-floor estimate.
"""
from __future__ import annotations

import time

import torch


def _devices(out) -> set:
    """The CUDA devices the tensors in ``out`` (a tensor, or a tuple /
    list / dict of them, nested) live on."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_devices(o) for o in out)) if out else set()
    return set()


def _wait(out) -> None:
    for dev in _devices(out):
        torch.cuda.synchronize(dev)


def timeit(fn, *args, reps: int = 3, inner: int = 3,
           warmup: int = 1, **kw) -> float:
    """Best per-call seconds for ``fn(*args, **kw)``.

    ``warmup`` calls run first (waited on); then ``reps`` samples of
    ``inner`` back-to-back calls, waiting once per sample, keeping the
    least per-call mean.  Raises whatever the first call raises."""
    for _ in range(max(0, warmup)):
        _wait(fn(*args, **kw))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args, **kw)
        _wait(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best
