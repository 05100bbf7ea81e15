"""End-to-end AIDA serving (the paper's use case: FC-layer inference).

Pipeline: train a small model briefly -> Deep-Compression (prune + 16-entry
weight sharing, paper section 3 / EIE) every projection -> serve batched
requests through the compressed decode path (the blocked-ACSR and paged
attention kernels on the card) -> report compression ratio, logit fidelity
and agreement vs the dense model.  Everything runs through the
`repro_torch.api.Engine` facade.

  PYTHONPATH=src python -m repro_torch.examples.serve_aida \\
      [--mode aida|codebook4|int8] [--device cpu]
"""
import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api import CompressionSpec, Engine, Request
from repro_torch.configs import get, reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataIterator, PipelineConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="aida",
                    choices=["int8", "codebook4", "acsr", "aida"])
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get("llama3-8b"), n_layers=2, d_model=128, d_ff=256,
                  vocab=512)
    print(f"== train a {cfg.params_count()/1e6:.1f}M model "
          f"({args.train_steps} steps) on {device} ==")
    tc = trainer.TrainConfig(remat="none",
                             opt=AdamWConfig(lr=3e-3, warmup_steps=5,
                                             total_steps=args.train_steps))
    data = DataIterator(cfg, PipelineConfig(seed=0, global_batch=8,
                                            seq_len=64))
    state = trainer.run(cfg, tc, data, n_steps=args.train_steps,
                        gen=torch.Generator(device=device).manual_seed(0),
                        log_every=10, device=device)

    print(f"\n== Deep-Compression -> {args.mode} "
          f"(density {args.density}) ==")
    eng = Engine(cfg, params=state.params, device=device).compress(
        CompressionSpec(mode=args.mode, density=args.density))
    print(f"  projections compressed: {eng.stats['n_compressed']}  "
          f"weight-memory ratio vs bf16: {eng.stats['ratio']:.1f}x  "
          f"(backend: {eng.backend.name})")

    print("\n== fidelity: compressed vs dense decode ==")
    B, S = 4, 24
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(device)
    std = M.init_decode_state(cfg, B, S + 1, device=device)
    stc = M.init_decode_state(cfg, B, S + 1, device=device)
    agree, err = [], []
    with torch.no_grad():
        for t in range(S):
            std, ld = M.decode_step(cfg, state.params, std, toks[:, t])
            stc, lc = M.decode_step(cfg, eng.params, stc, toks[:, t])
            agree.append(float((ld.argmax(-1) == lc.argmax(-1))
                               .float().mean()))
            err.append(float((ld - lc).abs().mean()))
    print(f"  next-token argmax agreement: {np.mean(agree):.1%}  "
          f"mean |logit delta|: {np.mean(err):.4f}")

    print("\n== batched serving on the compressed model ==")
    reqs = [Request(prompt=[1, 2 + rid, 3, 4], max_new=8, rid=rid)
            for rid in range(8)]
    t0 = time.perf_counter()
    results = eng.serve(reqs, batch_slots=4, max_len=64)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results) + 8 * 4
    print(f"  served {len(results)} requests, "
          f"{n_tok/dt:.1f} tok/s on {device}")
    for r in results[:3]:
        print(f"  req {r.rid}: {r.tokens}")


if __name__ == "__main__":
    main()
