"""Train a ~100M-parameter LM with the full production loop: checkpointing,
restart-on-failure supervision, straggler tracking, gradient compression.

Default is a short run; pass --steps 300 for the full run.

  PYTHONPATH=src python -m repro_torch.examples.train_llm [--steps N] \\
      [--arch qwen1.5-0.5b] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.api import Engine, Request
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get, reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataIterator, PipelineConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import RestartLoop, StragglerDetector
from repro_torch.train import trainer


def build_cfg(arch: str):
    """~100M-param member of the chosen family."""
    base = get(arch)
    return dataclasses.replace(
        reduced(base), name=base.name + "-100m", n_layers=6, d_model=512,
        d_ff=1536, vocab=8192,
        d_head=512 // max(2, min(base.n_heads, 8)))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_llm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg(args.arch)
    print(f"arch {cfg.name}: ~{cfg.params_count()/1e6:.0f}M params "
          f"on {device}")
    tc = trainer.TrainConfig(
        remat="dots", microbatches=2,
        grad_compression=args.grad_compression,
        opt=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
    pc = PipelineConfig(seed=0, global_batch=8, seq_len=256)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    straggler = StragglerDetector()

    final = {}

    def run_fn(resume_step):
        start = 0
        state = None
        if resume_step is not None:
            template = trainer.init_state(
                cfg, torch.Generator(device=device).manual_seed(0))
            state, extra = mgr.restore(template)
            start = extra["data"]["step"]
            print(f"[resume] from checkpoint step {resume_step}, "
                  f"data step {start}")
        data = DataIterator(cfg, pc, start_step=start)
        final["state"] = trainer.run(
            cfg, tc, data, n_steps=args.steps - start, state=state,
            gen=torch.Generator(device=device).manual_seed(0), ckpt_mgr=mgr,
            ckpt_every=10, straggler=straggler, log_every=5, device=device)

    RestartLoop(mgr, max_restarts=2).supervise(run_fn)
    mgr.wait()
    print(f"done; checkpoints at {mgr.list_steps()}; "
          f"straggler events: {straggler.flags}")

    if final.get("state") is not None and cfg.has_decode:
        # decode smoke on the trained weights through the serving facade
        eng = Engine(cfg, params=final["state"].params, device=device)
        res = eng.serve([Request(prompt=[1, 2, 3], max_new=8, rid=0)],
                        batch_slots=1, max_len=32)
        print(f"[api] decode smoke via Engine ({eng.backend.name}): "
              f"{res[0].tokens}")


if __name__ == "__main__":
    main()
