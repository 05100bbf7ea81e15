"""Collectives of the mesh, and the helper that starts its ranks.

The shard layer needs two collectives over a model-axis group: the
all-gather that joins the ranks' output bands along the feature axis
(the gather policy) and the all-reduce sum of partial products (int8's
psum policy): the list form of ``dist.all_gather`` (what torch 2.11 and
later both take) and ``dist.all_reduce``, on the group's own backend
(and, before a session starts, the all-reduce max through which the
ranks' tuners agree on one winner); a
collective that fails raises, and the call with it.  Data-parallel
training gathers every rank's gradients as one buffer a step
(:func:`pack` / :func:`unpack`, :func:`all_gather_list`), and each rank
adds them in rank order.  ``STATS`` counts the collectives and the bytes
this rank sent into gathers and, when ``STATS["timed"]`` is set, the host
seconds spent in them (synchronising the card around each, so the count
includes its wait).

:func:`spawn` runs ``target(rank, *args)`` in ``n`` fresh processes that
form one process group through a ``file://`` rendezvous, and returns the
ranks' results; a rank that raises, dies or outlives the timeout fails the
whole call, and every rank is stopped.  The tests, the launcher and
``chip_smoke.py`` start their ranks through it.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pathlib
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

#: collectives run, the bytes this rank sent into gathers, and the host
#: seconds spent in them (when timed)
STATS = {"gathers": 0, "reduces": 0, "bytes": 0, "seconds": 0.0,
         "timed": False}
#: seconds a rank waits in a collective before the group gives up
GROUP_TIMEOUT = 120.0


def reset_stats(timed: bool = False) -> None:
    STATS.update(gathers=0, reduces=0, bytes=0, seconds=0.0, timed=timed)


class _Timed:
    def __init__(self, x: torch.Tensor):
        self.dev = x.device if x.is_cuda else None

    def __enter__(self):
        if STATS["timed"]:
            if self.dev is not None:
                torch.cuda.synchronize(self.dev)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if STATS["timed"]:
            if self.dev is not None:
                torch.cuda.synchronize(self.dev)
            STATS["seconds"] += time.perf_counter() - self.t0


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """The group's ranks' ``x`` (one shape on every rank), in rank
    order."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    with _Timed(x):
        dist.all_gather(parts, x, group=group)
    STATS["gathers"] += 1
    STATS["bytes"] += x.numel() * x.element_size()
    return parts


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's ranks' ``x`` (one shape on every rank) concatenated
    along ``dim`` in rank order."""
    return torch.cat(all_gather_list(x, group), dim=dim)


#: bytes each part of a packed buffer starts on (a multiple of any item)
_ALIGN = 8


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One uint8 buffer holding the bytes of every tensor in order (each
    part starting on an 8-byte boundary), so many tensors travel in one
    collective."""
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = (-b.numel()) % _ALIGN
        if pad:
            parts.append(b.new_zeros(pad))
    return torch.cat(parts)


def unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """The tensors :func:`pack` put in ``buf``, given tensors ``like``
    them (shape and dtype), as views of ``buf``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).reshape(t.shape))
        off += n + (-n) % _ALIGN
    if off != buf.numel():
        raise ValueError(f"buffer of {buf.numel()} bytes holds {off}")
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ranks' ``x`` (a new tensor)."""
    import torch.distributed as dist
    out = x.contiguous().clone()
    with _Timed(out):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    STATS["reduces"] += 1
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the group's ranks' ``x`` (a new tensor): the
    tuner's agreement on candidate times, so every rank picks the same
    winner."""
    import torch.distributed as dist
    out = x.contiguous().clone()
    with _Timed(out):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    STATS["reduces"] += 1
    return out


def max_over(group, device):
    """A tuner's ``reduce`` (`kernels.tune.autotune`): candidates' seconds
    -> their max over ``group``'s ranks, so every rank picks the same
    winner."""
    def reduce(secs):
        t = torch.tensor(secs, dtype=torch.float64, device=device)
        return all_reduce_max(t, group).tolist()
    return reduce


def all_equal(x: torch.Tensor, group=None) -> bool:
    """Whether every rank of ``group`` (None: all ranks) holds the same
    ``x``, bit for bit (the ranks' lockstep check)."""
    x = x.reshape(1, -1)
    sizes = all_gather_cat(torch.tensor([x.numel()], device=x.device),
                           group, dim=0)
    if not bool((sizes == sizes[0]).all()):
        return False
    parts = all_gather_cat(x, group, dim=0)
    return all(torch.equal(parts[0], p) for p in parts[1:])


# ------------------------------------------------------------------ ranks
def _rank_main(rank: int, n: int, backend: str, init: str, out: str,
               target: Callable, args: Sequence, threads: int) -> None:
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{init}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        result = target(rank, *args)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(n: int, target: Callable, args: Sequence = (), *,
          backend: str = "gloo", timeout: float = 300.0,
          workdir: Optional[str] = None,
          threads: Optional[int] = None) -> List[object]:
    """``[target(rank, *args) for rank in range(n)]``, each in its own
    process and rank of one ``backend`` process group (``nccl``: rank r on
    card r).  ``target`` is a module-level function (the ranks import its
    module) and returns what ``torch.save`` can write.  ``workdir`` holds
    the rendezvous file and the results (None: a fresh temporary
    directory, removed after).  ``threads``: torch threads a rank (None:
    the host's cores shared out).  Raises RuntimeError with the failing
    rank's traceback when a rank fails, dies or is still running after
    ``timeout`` seconds; no rank is left running."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; 'nccl' or 'gloo'")
    own = workdir is None
    work = pathlib.Path(tempfile.mkdtemp(prefix="mesh-") if own
                        else workdir)
    work.mkdir(parents=True, exist_ok=True)
    init = work / "rendezvous"
    if init.exists():
        init.unlink()
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, str(init),
                               str(work / f"rank{r}.pt"), target,
                               tuple(args), threads), daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                # a failed rank takes its peers' collectives down: give
                # them a few seconds to exit and report theirs too
                end = time.monotonic() + 5.0
                while any(p.exitcode is None for p in procs) \
                        and time.monotonic() < end:
                    time.sleep(0.02)
                raise RuntimeError(_failure(work, procs))
            if time.monotonic() > deadline:
                raise RuntimeError(f"mesh ranks still running after "
                                   f"{timeout:.0f} s")
            time.sleep(0.02)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(_failure(work, procs))
        return [torch.load(work / f"rank{r}.pt", weights_only=False)
                ["result"] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if own:
            shutil.rmtree(work, ignore_errors=True)


def _failure(work: pathlib.Path, procs) -> str:
    """Every failed rank's exit code and traceback: those that exited
    with an error, and those that wrote one and are still shutting down
    (the first to fail takes its peers' collectives down with it)."""
    lines = []
    for rank, proc in enumerate(procs):
        path, err = work / f"rank{rank}.pt", None
        if path.exists():
            try:
                err = torch.load(path, weights_only=False).get("error")
            except Exception:          # written by a rank that was dying
                err = "(its result file is unreadable)"
        if err is not None or proc.exitcode not in (None, 0):
            lines.append(f"mesh rank {rank} failed (exit code "
                         f"{proc.exitcode}):\n{err or ''}")
    return "\n".join(lines)
