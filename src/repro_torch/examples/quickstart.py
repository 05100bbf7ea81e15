"""Quickstart: train a tiny llama-family model, checkpoint it, generate.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
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
from repro_torch.train import trainer


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get("llama3-8b"), n_layers=2, d_model=128, d_ff=256,
                  vocab=512)
    print(f"arch: {cfg.name}  params ~{cfg.params_count()/1e6:.1f}M "
          f"on {device}")

    tc = trainer.TrainConfig(
        remat="none",
        opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    data = DataIterator(cfg, PipelineConfig(seed=0, global_batch=8,
                                            seq_len=64))
    mgr = CheckpointManager(args.ckpt_dir, keep_last=2)
    state = trainer.run(cfg, tc, data, n_steps=args.steps,
                        gen=torch.Generator(device=device).manual_seed(0),
                        ckpt_mgr=mgr, ckpt_every=max(1, args.steps // 2),
                        log_every=10, device=device)
    mgr.wait()
    print(f"checkpoints: steps {mgr.list_steps()}")

    eng = Engine(cfg, params=state.params, device=device)
    reqs = [Request(prompt=[1, 2 + rid, 3], max_new=8, rid=rid)
            for rid in range(3)]
    for r in eng.serve(reqs, batch_slots=2, max_len=64):
        print(f"request {r.rid}: {r.tokens}")


if __name__ == "__main__":
    main()
