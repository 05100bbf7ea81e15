"""Training launcher of the port, on the card unless ``--device cpu`` asks
for the plain versions::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --steps 100 --global-batch 256 --seq 4096 \\
      [--microbatches 4] [--grad-compression int8] [--ckpt-dir /ckpts]

Several processes: every process runs this same command with
``COORDINATOR_ADDR`` (host:port of rank 0), ``NUM_PROCESSES`` and
``PROCESS_ID`` set; they form one ``torch.distributed`` group (``nccl``
with a card a rank, ``gloo`` where ranks share a card or with ``--device
cpu``) and a (data = world, model = 1) mesh: every rank reads the same
global batch, trains on its rows and exchanges gradients each step
(``train.trainer.make_train_step(mesh=)``).  Without those variables it
runs on a mesh of one rank.  ``--ckpt-dir`` checkpoints every
``--ckpt-every`` steps (rank 0 writes, in the JAX package's format) and
runs under ``RestartLoop``: a failed run resumes from the newest committed
checkpoint, and a new launch with the same ``--ckpt-dir`` resumes from it
too (keep ``--steps`` the same: it sets the schedule's ``total_steps``).
The flags are the JAX package's launcher's, plus ``--device``,
``--keep-last`` and ``--log-every``; ``--multi-pod`` and a
production-sized group raise, as the production mesh is not ported.
Without a visible card and without ``--device cpu`` it stops with an
error; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from typing import List, Optional

from repro_torch.configs import get

#: ranks from which the JAX package's launcher builds its production mesh
PRODUCTION_RANKS = 256


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local-mesh", action="store_true",
                    help="train on the ranks there are, whatever their "
                    "number (the mesh is (data = world, model = 1))")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoints kept in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the loss every this many steps")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; "
                         "'cpu' runs every kernel's plain version)")
    return ap


def maybe_init_distributed(device_arg: Optional[str]):
    """(world, rank, backend, device) of this process: from the process
    group that ``COORDINATOR_ADDR`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
    describe, or a single rank without them."""
    import torch
    from repro_torch.core.device import resolve_device
    device = resolve_device(device_arg)
    if "COORDINATOR_ADDR" not in os.environ:
        return 1, 0, None, device
    import torch.distributed as dist
    world = int(os.environ["NUM_PROCESSES"])
    rank = int(os.environ["PROCESS_ID"])
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= world else "gloo"
        device = torch.device("cuda", rank % cards)
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['COORDINATOR_ADDR']}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(minutes=30))
    return world, rank, backend, device


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import (RestartLoop,
                                                     StragglerDetector)
    from repro_torch.train import trainer

    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs the production mesh (make_production_mesh), "
            "not ported yet (ROADMAP queue 1 item 10)")
    try:
        world, rank, backend, device = maybe_init_distributed(args.device)
    except RuntimeError as e:
        ap.exit(2, f"[launch] {e}\n")
    if world >= PRODUCTION_RANKS and not args.local_mesh:
        raise NotImplementedError(
            f"{world} ranks ask for the production mesh "
            "(make_production_mesh), not ported yet (ROADMAP queue 1 item "
            "10); pass --local-mesh for a (data, 1) mesh over them")
    try:
        say = print if rank == 0 else (lambda *a, **k: None)
        cfg = get(args.arch)
        mesh = make_host_mesh(1, world, backend=backend, device=device)
        device = mesh.device
        say(f"[launch] local mesh {world}x1 (data x model) over "
            f"{backend or 'no group'} on {device}")
        tc = trainer.TrainConfig(
            remat=args.remat, microbatches=args.microbatches,
            grad_compression=args.grad_compression,
            opt=AdamWConfig(lr=args.lr, total_steps=args.steps))
        mgr = CheckpointManager(args.ckpt_dir, keep_last=args.keep_last) \
            if args.ckpt_dir else None
        straggler = StragglerDetector()
        sync = torch.cuda.synchronize if device.type == "cuda" else \
            (lambda *a: None)

        def start_state():
            gen = torch.Generator(device=device).manual_seed(0)
            state = trainer.init_state(cfg, gen)
            if mgr is None or mgr.latest_step() is None:
                return state, 0
            state, extra = mgr.restore(state)
            start = extra["data"]["step"]
            say(f"[launch] restored step {start}")
            return state, start

        def run_once(_resume):
            state, start = start_state()
            step_fn = trainer.make_train_step(cfg, tc, mesh=mesh)
            data = DataIterator(cfg, PipelineConfig(
                seed=0, global_batch=args.global_batch, seq_len=args.seq),
                start_step=start)
            for i in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(np.asarray(v), device=device)
                         for k, v in next(data).items()}
                state, metrics = step_fn(state, batch)
                sync(device)
                dt = time.perf_counter() - t0
                if straggler.record(dt):
                    say(f"[ft] straggler step ({dt:.2f}s)")
                if i % args.log_every == 0:
                    say(f"step {i} loss={float(metrics['loss']):.4f} "
                        f"({dt*1e3:.0f} ms)")
                if mgr and (i + 1) % args.ckpt_every == 0:
                    trainer.save_checkpoint(mgr, i + 1, state, data, mesh)

        if mgr is not None:
            RestartLoop(mgr, log=say).supervise(run_once)
            mgr.wait()
        else:
            run_once(None)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
