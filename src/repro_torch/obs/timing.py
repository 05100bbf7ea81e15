"""`obs.timeit` — the port's best-of-N timer for kernels and steps.

One warmup call to absorb the first launch (a kernel library's build and
load, cuBLAS handles), then ``reps`` samples of ``inner`` back-to-back
calls with the best per-call mean kept.  A call whose result lives on
one card is timed on the card: CUDA events bracket the ``inner`` calls,
and a sleep kernel queued before them keeps the card busy while the host
enqueues them, so a sample counts the card's work and not the host's
launch overhead (a kernel of tens of microseconds launches slower from
Python than it runs, and the wall clock would time the host).  Any other
result is timed on the host's clock (a CUDA result on several cards
after synchronising them).  Sub-millisecond kernels need the inner loop,
and min-of-reps is the usual noise-floor estimate.
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
    ``inner`` back-to-back calls, keeping the least per-call mean: device
    time where the warmup's result lives on one card, else wall time
    (waiting once per sample).  Raises whatever the first call raises."""
    out = None
    for _ in range(max(0, warmup)):
        out = fn(*args, **kw)
        _wait(out)
    devs = _devices(out)
    if len(devs) == 1:
        return _device_seconds(fn, args, kw, reps, inner, devs.pop())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args, **kw)
        _wait(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _device_seconds(fn, args, kw, reps, inner, dev) -> float:
    """The card's seconds a call, best of ``reps`` samples of ``inner``
    calls between two CUDA events; a sleep of twice the host's enqueue
    time (at <= 2 GHz) queued first, so the card waits on no launch."""
    with torch.cuda.device(dev):
        t0 = time.perf_counter()
        fn(*args, **kw)
        host = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        cycles = int(max(host * inner, 1e-4) * 4e9)
        best = float("inf")
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(inner):
                fn(*args, **kw)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3 / inner)
        return best
