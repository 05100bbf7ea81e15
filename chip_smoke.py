#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--layers N]
    python3 chip_smoke.py --time-gather    # K1 gather's times only

Phases, each of which exits non-zero when it fails:

1. build the nine CUDA libraries (eleven kernels; the paged-attention
   source once for each of its three ranges) from
   ``src/repro_torch/csrc`` (one nvcc each, in parallel) and print the
   card (nvidia-smi name, power limit);
2. K1 (blocked-ACSR SpMV: a gather kernel up to 8 columns, a wide
   kernel beyond, both summing a column in one order) against its plain
   version at the seven llama3-8b projection geometries at 1, 3, 4, 8,
   12, 32 and 40 columns, rwkv6-7b's eight at 4, acsr with f32 and bf16
   values, 40000 columns (int32 ids), rows of row_nnz = 0, three dense
   rows and gemma2-2b's gelu gate, density 0.25; every call twice, bit-identical, and every column
   of every width bit-identical to the same column run alone and among 4;
   hymba-1.5b's nine at 1, 4 and 32 columns (one layer timed at 4);
   untimed, every other projection shape of the served families and
   hubert's;
   the kernels a call, from the profiler (the gather variant: one launch);
3. K2 (paged-attention decode) against its plain version at B=4, H=32,
   Hkv=8, Dh=128, page 16, contexts 37 and 2048, bf16 and int8 pages,
   window -1 / 64, softcap none / 30, with -1 holes and an empty row, at
   Dh 80, 96, 64 and 256 (softcap 50) too, at hymba's query group of 5
   (H 25 / Hkv 5, Dh 64, window 1024), and with an f32 q; every row run
   alone must equal the same row among 4 bit for bit;
4. K3 (paged-attention chunk) likewise at C = 1 and 8, with padded
   queries past the written context; every query of a chunk must equal K2
   on that query alone bit for bit, and every row alone the same row
   among 4;
5. K4 (int8 FC) and K5 (codebook4 FC) against their plain versions at the
   seven projections, M = 4 and 32 rows, with bias and silu, and at
   gemma2-2b's gate with gelu; every call twice, bit-identical, and every
   row alone bit-identical to the same row among 4 and among 32; then
   the tuner's candidate launch plans (``tune``, `kernels.tune`) at
   llama3-8b's shapes, each timed beside today's default: K1's (sy,
   nsplit) within tolerance at 4 and 32 columns, each column bit for bit
   alone; K4 / K5's K splits within tolerance at 4 and 32 rows, each row
   alone bit for bit among 32; K2 / K3's ranges and K3's query tiles at
   contexts 37, 2048 and 8192 (bf16 and int8 pages), K2 within tolerance
   and K3 at C = 8 bit for bit K2 on each query;
6. K7 (flash forward) and K8 (flash dq, dkv) against their plain versions
   at B=2, H=32, Hkv=8, T=2048, D=128 bf16 causal and over a grid
   (windows, softcaps, non-causal, Hkv 1-32, D 64 / 80 / 96 / 128 / 256,
   ragged T, bf16 and f32; hymba's 25 / 5 heads windowed, hubert's 16 /
   16 non-causal at D 80); a second run of each must repeat bit for
   bit; K8's errors are logged beside those of an f32-FMA K8, as its
   products run on the tensor cores with f32 operands split into bf16
   hi + lo; timed at each model's training shape;
7. K9 (the rwkv6 WKV scan) against its plain version at rwkv6-7b's
   forward shape (B=2, H=64, T=2048, 64 x 64 state, bf16 r / k / v read
   through strided head views), the reference's test shapes, its
   tiny-decay case, a ragged T, Dk 128 / Dv 256 and a 12-wide head
   (staged by plain loads); K6 (the fully-coded
   LUT product) at the seven llama3-8b projections, B = 4 and 32, with
   the reference's two tables, ragged B / N / K / nc and an integer table,
   all bit-identical to the plain version (exact int64 sums), every x row
   alone bit-identical to it among 4 and among 32 (and, profiled right
   after the K1 phase, one kernel a call), plus its entry point's launch
   count;
8. kernel, plain-version and library times (CUDA events, median, L2
   flushed) beside the least time the card needs for the same work (K2
   and K3 at contexts 37, 256, 2048 and 8192); then the paper's own model
   (``ap emulator``, no kernel: plain tensor ops): the bit-level AP
   emulator at 96 x 200, coded and bit-serial, equal to the CPU's (out,
   rounds, counters, CAM image), AlexNet FC6 (coded, 4096 x 9216, Table
   1's configuration) and FC8 (bit-serial, 1000 x 4096) at full size
   through ``Engine.estimate(backend="ap-emulator")``, equal to the
   integer oracle, with ``cycle-sim``'s closed-form cycles, each layer's
   PUs, CAM size, AP ops and wall time logged; the ``cuda`` backend's
   run_fc equal to apply_fc; Table 1's AIDA / EIE ratios;
9. the serving path: llama3-8b at full width, ``Engine.compress(aida
   0.25)`` then four requests served at chunk 1 and at chunk 8 (tokens
   equal up to near-tie flips; the logits' drift logged, and which ops
   give a row other bits among 4 rows than among 32, K3 against K2
   required to give none), with every launch counted; then timed traffic
   on the same engine (``run_workload``): the heterogeneous preset (10
   requests, fifo, chunk 8) and shared-prefix (8 requests) with sjf and
   the prefix cache, then fifo without it (tokens equal up to near-tie
   flips), exact launches, no leaked page, every record's scheduling
   clock and the stats equal to a reduced llama3-8b's on the CPU; an
   attached prefix page equal bit for bit to the page its request writes
   alone; seeded sampling repeated; the tick-clock trace equal to the CPU
   run's; and ``python -m repro_torch.launch.serve`` (qwen1.5-0.5b, full
   size, aida, shared-prefix, sjf, prefix cache) exiting 0 with every
   request served, none leaked and the card in its provenance; then
   disaggregated serving on the same engine: the burst workload (8
   requests, chunk 8) co-located (4 slots) and through a prefill role (2
   slots) and a decode role (4 slots) sharing the weights, each with its
   own page pool (tokens equal up to the drift rule's flips, exact
   launches per role, pages and bytes migrated, TTFT / TPOT, no leaked
   page, clean audits, the scheduling clock equal to the CPU run's), an
   int8 migration equal bit for bit (codes and scales), ``drop-handoff:1``
   and ``page-spike:0`` with deadlines and retries, each run twice to
   identical records and summaries, and the launcher with ``--disagg
   --fault-plan drop-handoff:3`` (qwen1.5-0.5b, full size); and, on
   the same engine, the four requests from the full KV cache
   (``kv_cache="full"``: chunk 1, no paged-attention launch, tokens equal
   to the paged chunk-1 serve's up to near-tie flips);
10. fresh int8 and codebook4 engines (8 of 32 layers) serve the same
    requests at chunk 8 through K4 / K5 (one launch a call), then a short
    profiled serve each (device busy, kernels a step, K4 / K5 as the "fc"
    family); then qwen1.5-0.5b (8 of 24 layers), h2o-danube-1.8b, gemma2-2b and
    phi-3-vision-4.2b (4 layers, text) and mixtral-8x7b (2 layers) at full
    width, aida 0.25, at chunk 1 and 8 with every launch counted (a dense
    family's chunk-8 tokens equal to its chunk-1 ones up to near-tie
    flips); then hymba-1.5b at full width and depth, aida 0.25, at chunk
    1, paged and from the full cache (K1 nine times a layer and step, K2
    once at a query group of 5 on the paged route; tokens equal up to
    near-tie flips), each then profiled;
11. the training path: llama3-8b at full width, depth cut to 4 layers,
    ``trainer.run(attn_impl="flash", remat="dots")`` for 4 steps on 2 x
    2048 tokens through K7 / K8 (exact launch counts: K7 twice a layer and
    step, once forward and once in the recompute; finite and falling
    loss; peak memory), then one profiled step, then the same steps under
    ``remat="none"`` beside it; then gemma2-2b (K7 / K8 at D 256, softcap
    50), h2o-danube-1.8b (D 80), hymba-1.5b (layer 0 global, layer 1
    windowed 1024, the mamba scan as plain ops) and phi-3-vision-4.2b (576
    image rows + 2048 tokens) at full width, 2 layers, and hubert-xlarge
    (non-causal) at 4, 2 steps each, finite losses, exact launch counts;
    hubert-xlarge's forward at full depth (48 layers, 2 x 2048 frames: K7
    once a layer), finite logits;
12. a reduced llama3-8b served on the card and on the CPU gives the same
    greedy tokens (or differs only at a near-tie), in all three modes, and
    trained 3 steps on both from the same state gives the same losses
    within 1e-2; each new family, reduced with its real head dim, gives
    the CPU's tokens (or a near-tie) and SWA reclamation at chunk 1 and 8;
    reduced hymba served paged and from the full cache gives the CPU's
    tokens, hubert's and phi-3-vision's training losses are the CPU's
    within 1e-2, and reduced h2o-danube's ring cache serves its paged
    tokens while the pages behind the window are freed;
13. rwkv6-7b at full width, all 32 layers: ``forward`` over 2 x 2048
    tokens (one K9 launch per layer, finite logits), equal to
    ``decode_step`` fed the first 32 tokens one at a time within the
    stated limits one layer deep (random weights amplify rounding
    differences with depth; the 32-layer gap is logged beside the
    forward's own), which three faults planted in the decode's WKV
    exceed, then ``Engine.compress(aida 0.25).serve`` of the
    four requests through K1 (8 launches per layer and step), then a
    reduced rwkv6-7b served on the card and on the CPU (same greedy
    tokens up to near-tie flips);
14. the mesh (``mesh bands`` right after phase 5, ``mesh serve`` after
    phase 9's disaggregated serves): llama3-8b's seven projections in
    aida, int8 and codebook4 cut into tp = 2 and 4 row bands, each band
    launched with the whole matrix's split (K1 gather at 4 columns, wide
    at 32, K4 / K5 at 4 and 32 rows), the bands concatenated bit for bit
    the whole launch, and K2 / K3 head groups (Hkv 8, contexts 37 and
    2048) bit for bit the whole, each band's ms beside the whole's; then
    ranks in processes of their own (``shard.comm.spawn``): a mesh of
    one over nccl, its collectives exact and its serve bit for bit the
    plain session's, and two ranks sharing the card over gloo serving
    llama3-8b at full width cut to 4 layers, aida 0.25, chunk 8, the four
    requests: rank 0's tokens and logits bit for bit the single-device
    serve's, both ranks the same tokens, each rank's launches as its
    layers and steps say, ms/step, kernels/step and gather ms/step
    logged;
15. checkpoints, restarts and data-parallel training (after hubert's
    forward): ``python -m repro_torch.launch.train`` on qwen1.5-0.5b at
    full width and depth (4 steps of 2 x 2048 tokens, a checkpoint every
    2) uninterrupted and, beside it, killed with SIGKILL once step 2's
    checkpoint is committed, then rerun: it reports resuming from the
    newest committed step and writes step 4's files byte for byte the
    uninterrupted run's; llama3-8b at full width, 2 layers, through K7 /
    K8: 4 steps uninterrupted, then a run checkpointed at step 2 that
    raises after step 3 and is resumed by ``RestartLoop`` (final params
    ``torch.equal`` the uninterrupted run's, the step-2 checkpoint
    restored onto the CPU equal to the card's step-2 state; save and
    restore seconds and GB logged); two gloo ranks sharing the card train
    qwen1.5-0.5b (1 x 2048 tokens a rank, 3 steps) with no compression
    (params and losses bit for bit one device's at ``microbatches=2``),
    bf16 and int8 on the wire (finite, falling losses, the ranks' params
    the same digest; int8 within DP_INT8_LOSS_TOL of the uncompressed
    losses), bytes a rank a step, gather ms and step ms logged;
16. the Engine's benchmark surface (``engine benchmarks``, last):
    ``Engine.benchmark`` over dense, int8, codebook4, acsr and aida, with
    its kv (full vs paged int8 pages, the attention / FC split of a
    decode step timed on the card), serving (chunked prefill, traffic,
    prefix cache, preemption), disagg, resil (four fault presets, each
    replayed) and capacity sections and the cost-model backends: a
    reduced llama3-8b on the card and on the CPU from the same seed-0
    weights, every deterministic fact (token, step, tick, page, handoff
    and fault counts, compression ratios, the capacity section, the
    backends) equal and every session's tokens equal up to near-tie
    flips ((a)'s launches logged, not counted); then llama3-8b at full
    width cut to 4 layers on the card: every mode serves all its tokens,
    token parity and determinism hold, no page leaks, the capacity replay
    is byte for byte and its choice the CPU's, the KV bytes / token the
    closed form, the attention shares in (0, 1), the engine's raw weights
    unchanged, no mode's or section's engine outliving it and the peak
    allocation within one compressed copy; tok/s per mode, TTFT / TPOT,
    disagg against co-located, goodput under faults, the attention / FC
    times and the peak logged, with K1-K5's launches by shape (K1 at 2, 3
    and 24 columns, K4 / K5 at 2 rows, K2 / K3 on pages of 8, K3 at
    C = 4: shapes phases 1-4 hold against the plain versions and time; K2
    and K3 timed again at this run's tables).

Every session on the card pre-tunes its kernels first (`Engine._pretune`,
logged with its seconds and new winners); the serves' launch counts
leave the tuner's own launches out (`tune.launches`, the kernels line's
``tune_launches``), and the winners are logged after phase 9.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA card; imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM, bf16 tensor cores, dense
# f32 additions: 132 SMs x 128 lanes x 1.98 GHz (an FMA's two flops are
# counted in F32_FLOPS); bounds K6's one addition a weight byte and x row
F32_ADDS = F32_FLOPS / 2
KERNELS = [                        # (name, csrc file, TPU kernel replaced)
    ("acsr_spmv_wide", "acsr_spmv.cu",
     "src/repro/kernels/acsr_spmv.py:160"),
    ("acsr_spmv_gather", "acsr_spmv.cu",
     "src/repro/kernels/acsr_spmv.py:160"),
    ("paged_attention_decode", "paged_attention.cu",
     "src/repro/kvstore/paged_attention.py:150"),
    ("paged_attention_chunk", "paged_attention.cu",
     "src/repro/kvstore/paged_attention.py:279"),
    ("int8_matmul", "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:27"),
    ("lut_matmul", "lut_matmul.cu", "src/repro/kernels/lut_matmul.py:41"),
    ("flash_attention_fwd", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:49"),
    ("flash_attention_dq", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:128"),
    ("flash_attention_dkv", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:163"),
    ("rwkv6_scan", "linear_scan.cu", "src/repro/kernels/linear_scan.py:28"),
    ("lut_product_matmul", "lut_product.cu",
     "src/repro/kernels/lut_matmul.py:126"),
]
FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
PROJECTIONS = [                    # llama3-8b: (name, n_out, n_in)
    ("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
    ("wo", 4096, 4096), ("gate", 14336, 4096), ("up", 14336, 4096),
    ("down", 4096, 14336)]
GELU_GATE = ("gemma2-gate-gelu", 9216, 2304)   # gemma2-2b's gelu gate


def log(*a):
    print(*a, flush=True)


def median_ms(fn, iters=20, warmup=3, flush=None):
    """Device time of ``fn``: median of ``iters`` CUDA-event timings, L2
    flushed before each when ``flush`` is given.  A sleep kernel keeps the
    card busy while the host enqueues ``fn``, so the events bracket the
    device work only.  Returns (ms, host enqueue ms of one call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host, 1e-4) * 4e9)  # >= 2x the enqueue at <= 2 GHz
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], host * 1e3


def bound(bytes_, flops, rate=F32_FLOPS):
    """Least ms for the call: its bytes over the memory rate or its
    operations over the peak ``rate`` for their type, whichever is more."""
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernels_of(fn, key):
    """The device kernels one call of ``fn`` launches whose names hold
    ``key``, from torch.profiler, or None when the profiler saw no device
    kernel at all (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [n for n in names if key in n] if names else None


def one_kernel(fn, key, what, tries=3):
    """Raise unless one call of ``fn`` launches exactly one kernel named
    ``key``, the profiler seeing it; returns 1.  The profiler now and then
    records no device kernel at all in a profile, so a call it saw nothing
    of is profiled again, ``tries`` times at most."""
    for attempt in range(tries):
        per_call = kernels_of(fn, key)
        if per_call is not None:
            break
        log(f"{what}: the profiler saw no device kernel (try {attempt + 1} "
            f"of {tries})")
        time.sleep(1.0)
    if per_call is None:
        raise AssertionError(f"{what}: the profiler saw no device kernel, "
                             "so one launch a call is not shown")
    if len(per_call) != 1:
        raise AssertionError(f"{what} launched {per_call}, not one kernel")
    return 1


def check_close(name, out, ref, rtol, atol):
    import torch
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=rtol, atol=atol) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    return err


# ------------------------------------------------------------------ K1
RWKV6_PROJECTIONS = [              # rwkv6-7b: time mix, then channel mix
    ("tm.wr", 4096, 4096), ("tm.wk", 4096, 4096), ("tm.wv", 4096, 4096),
    ("tm.wg", 4096, 4096), ("tm.wo", 4096, 4096), ("cm.wk", 14336, 4096),
    ("cm.wv", 4096, 14336), ("cm.wr", 4096, 4096)]
HYMBA_PROJECTIONS = [              # hymba-1.5b: attention, MLP, mamba
    ("wq", 1600, 1600), ("wk", 320, 1600), ("wv", 320, 1600),
    ("wo", 1600, 1600), ("gate", 5504, 1600), ("up", 5504, 1600),
    ("down", 1600, 5504), ("in_proj", 3200, 1600), ("out_proj", 1600, 1600)]
# column counts K1 is held at: 1 and 8 bound the gather variant, and 3
# takes its loop for widths other than 1, 4 and 8; 12 and 40 take the wide
# variant's 16-column pass and a second (8-column) group after a 32-column
# one; 4 (decode), 16 (a chunk-8 step of the disaggregated prefill role's
# 2 slots) and 32 (a chunk-8 step of 4 slots) are the serves', and timed;
# so are 2, 3 and 24, the engine benchmarks' (2 or 3 slots decoding, 3
# slots at chunk 8)
K1_COLUMNS = (1, 2, 3, 4, 8, 12, 16, 24, 32, 40)
K1_TIMED = (2, 3, 4, 16, 24, 32)


def _k1_weight(gen, dev, n_out, n_in, name):
    import torch
    w = torch.randn((n_out, n_in), generator=gen, device=dev) * n_in ** -0.5
    if name == "empty-rows":   # rows of row_nnz = 0: every third row, and
        w[::3] = 0.0           # all of rows 64-191 (two CUDA blocks of 64)
        w[64:192] = 0.0
    if name == "skewed-rows":  # three dense rows (pruning keeps them
        w[[5, 700, 3000]] *= 100.0   # whole): their blocks' ranges read x
    return w                         # across all 4096 columns


def _family_projections():
    """The compressed projections of the families that FAMILY_SERVES serves
    and of hubert (ungated gelu MLP; its session is refused, but
    compression takes its layers), as (label, n_out, n_in, activation,
    bias), one for each
    distinct (n_out, n_in, activation, bias) that llama3-8b's seven and
    GELU_GATE do not already cover (a MoE layer's experts stay
    uncompressed: only its attention)."""
    from repro_torch import get
    seen = {(o, i, {"gate": "silu"}.get(n), False) for n, o, i in PROJECTIONS}
    seen.add((GELU_GATE[1], GELU_GATE[2], "gelu", False))
    out = {}
    for arch in [a for a, _ in FAMILY_SERVES] + ["hubert-xlarge"]:
        cfg = get(arch)
        d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
        proj = [("wq", cfg.n_heads * hd, d, None, cfg.qkv_bias),
                ("wk", cfg.n_kv * hd, d, None, cfg.qkv_bias),
                ("wv", cfg.n_kv * hd, d, None, cfg.qkv_bias),
                ("wo", d, cfg.n_heads * hd, None, False)]
        if cfg.moe is None and cfg.gated_mlp:
            proj += [("gate", f, d, cfg.act, False), ("up", f, d, None, False),
                     ("down", d, f, None, False)]
        elif cfg.moe is None:
            proj += [("up", f, d, cfg.act, False), ("down", d, f, None, False)]
        for name, o, i, act, bias in proj:
            key = (o, i, act, bias)
            if key not in seen:
                out.setdefault(key, {}).setdefault(arch, []).append(name)
    return [(", ".join(f"{a} {'/'.join(n)}" for a, n in by.items()), *key)
            for key, by in out.items()]


def _k1_variant(batch):
    from repro_torch.kernels.acsr_spmv import GATHER_COLS
    return "acsr_spmv_gather" if batch <= GATHER_COLS else "acsr_spmv_wide"


def k1_phase(dev, flush):
    """K1's two variants (the gather kernel up to 8 columns, the wide
    kernel beyond) against their plain version (rtol = atol = 1e-4), each
    call run twice and bit-identical, and every column of every width
    bit-identical to the same column run alone and among 4 (one sum order
    a column): llama3-8b's seven projections (aida 0.25) at every column
    count of K1_COLUMNS, rwkv6-7b's eight at 4 columns, hymba-1.5b's nine
    (its mamba heads' in / out projections among them) at 1, 4 and 32
    columns, and five more
    containers: acsr with f32 and with bf16 values, 40000 columns (int32
    ids), rows of row_nnz = 0, three dense rows (at 1, 4, 8 columns) and
    gemma2-2b's gate with its tanh-gelu epilogue (at 1, 4, 32 columns);
    and, untimed at 1, 4 and 32 columns, every other projection shape of
    the families served at full width (``_family_projections``: qwen1.5's
    q / k / v with their bias, h2o-danube's and gemma2-2b's), qwen1.5-
    0.5b's at 16 columns too (the disaggregated launcher's prefill role).
    Times at the serves' shapes.  Returns
    the max errors, llama3-8b's per-layer totals by variant, and
    rwkv6-7b's and hymba-1.5b's per-layer totals at 4 columns."""
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"acsr_spmv_wide": 0.0, "acsr_spmv_gather": 0.0}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    totals = {(_k1_variant(m), m): dict.fromkeys(keys, 0.0)
              for m in K1_TIMED}
    rwkv6 = dict.fromkeys(keys, 0.0)
    hymba = dict.fromkeys(keys, 0.0)
    # (label, n_out, n_in, mode, value dtype, column counts, per-layer sum)
    cases = [(n, o, i, "aida", "f32", K1_COLUMNS, "llama")
             for n, o, i in PROJECTIONS] + \
        [(f"rwkv6 {n}", o, i, "aida", "f32", (4,), "rwkv6")
         for n, o, i in RWKV6_PROJECTIONS] + \
        [(f"hymba {n}", o, i, "aida", "f32", (1, 4, 32), "hymba")
         for n, o, i in HYMBA_PROJECTIONS] + \
        [("wo-acsr-f32", 4096, 4096, "acsr", "f32", K1_COLUMNS, None),
         ("wo-acsr-bf16", 4096, 4096, "acsr", "bf16", K1_COLUMNS, None),
         ("wide-int32", 1024, 40000, "aida", "f32", K1_COLUMNS, None),
         ("empty-rows", 4096, 4096, "aida", "f32", K1_COLUMNS, None),
         ("skewed-rows", 4096, 4096, "aida", "f32", (1, 4, 8), None),
         (*GELU_GATE, "aida", "f32", (1, 4, 32), None)] + \
        [(n, o, i, "aida", "f32", (1, 4, 16, 32) if "qwen1.5-0.5b" in n
          else (1, 4, 32), "held")
         for n, o, i, _, _ in _family_projections()]
    epilogue = {n: (a, b) for n, _, _, a, b in _family_projections()}
    n_same, calls = 0, {}
    for name, n_out, n_in, mode, vdt, columns, layer_of in cases:
        w = _k1_weight(gen, dev, n_out, n_in, name)
        layer = sfc.compress(w, mode=mode, density=0.25, dtype=vdt)
        b = layer.blocked
        if name == "wq":           # compression repeats bit for bit
            again = sfc.compress(w, mode=mode, density=0.25).blocked
            if not all(torch.equal(getattr(b, f), getattr(again, f)) for f
                       in ("values", "col_idx", "row_nnz", "centroids",
                           "chunk_off")):
                raise AssertionError("compressing the same matrix twice on "
                                     "the card gave different containers")
            del again
        if name == "wide-int32" and b.col_idx.dtype != torch.int32:
            raise AssertionError("40000 columns should take int32 ids")
        if name == "empty-rows" and int((b.row_nnz == 0).sum()) < 128:
            raise AssertionError("the empty-rows case has no empty rows")
        act, has_bias = epilogue.get(name, (None, False))
        act = {"gate": "silu", "hymba gate": "silu",
               GELU_GATE[0]: "gelu"}.get(name, act)
        bias = torch.randn((n_out,), generator=gen, device=dev) \
            if name in ("wq", "wide-int32") or has_bias else None
        rows = b.nblocks * b.block_rows
        pb = None if bias is None else \
            torch.nn.functional.pad(bias, (0, rows - n_out))
        w_lib = sfc.dense_equivalent(layer).T.contiguous().to(torch.bfloat16)
        nnz = int(b.row_nnz.sum())
        xs = torch.randn((n_in, max(columns)), generator=gen, device=dev)

        def run(x):
            return sp.acsr_spmv(b, x.contiguous(), bias=bias, activation=act)
        # every column alone and in fours: what each width must repeat
        alone = torch.stack([run(xs[:, j]) for j in range(xs.shape[1])], 1)
        fours = torch.cat([run(xs[:, j:j + 4])
                           for j in range(0, xs.shape[1] - 3, 4)], 1)
        for batch in columns:
            x = xs[:, :batch].contiguous()
            kern = _k1_variant(batch)
            plain = ref.blocked_acsr_spmv_ref(b.values, b.col_idx, b.row_nnz,
                                              x, b.centroids, pb, act)[:n_out]

            def fn():
                return run(x)
            out, out2 = fn(), fn()
            torch.cuda.synchronize()
            what = f"{kern} {name} B={batch}"
            if not torch.equal(out, out2):
                raise AssertionError(f"{what}: a rerun differs")
            n4 = min(batch, fours.shape[1])
            if not (torch.equal(out, alone[:, :batch])
                    and torch.equal(out[:, :n4], fours[:, :n4])):
                bad = int((out != alone[:, :batch]).any(0).sum())
                raise AssertionError(f"{what}: {bad} columns differ from the "
                                     "same columns run alone or in fours")
            n_same += 1
            err = check_close(what, out, plain, 1e-4, 1e-4)
            errs[kern] = max(errs[kern], err)
            if batch not in K1_TIMED or layer_of == "held" or \
                    (layer_of == "hymba" and batch != 4):
                log(f"K1 {what} {n_out}x{n_in} act={act} "
                    f"bias={bias is not None} err={err:.2e} (rerun and "
                    "every column bit-identical)")
                continue
            moved = nnz * (b.values.element_size()
                           + b.col_idx.element_size()) + \
                b.row_nnz.numel() * 4 + x.numel() * 4 + \
                n_out * batch * 4 + \
                (64 if b.centroids is not None else 0) + \
                (n_out * 4 if bias is not None else 0)
            bms, by = bound(moved, 2 * nnz * batch)
            x_lib = x.T.contiguous().to(torch.bfloat16)
            t_k, host = median_ms(fn, flush=flush)
            t_p, _ = median_ms(lambda: ref.blocked_acsr_spmv_ref(
                b.values, b.col_idx, b.row_nnz, x, b.centroids, pb, act),
                iters=5, flush=flush)
            t_l, _ = median_ms(lambda: torch.matmul(x_lib, w_lib),
                               flush=flush)
            if kern == "acsr_spmv_gather":
                n_call = one_kernel(fn, "spmv", what)
            else:
                per_call = kernels_of(fn, "spmv")
                n_call = None if per_call is None else len(per_call)
            calls.setdefault(kern, set()).add(n_call)
            log(f"K1 {what} {n_out}x{n_in} rmax={b.rmax} nnz={nnz} "
                f"err={err:.2e} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"library_ms={t_l:.4f} bound_ms={bms:.4f} ({by}) "
                f"host_enqueue_ms={host:.4f} kernels_a_call={n_call} (rerun "
                "and every column bit-identical)")
            row = None
            if layer_of == "llama":
                row = totals[(kern, batch)]
            elif layer_of == "rwkv6":
                row = rwkv6
            elif layer_of == "hymba":
                row = hymba
            if row is not None:    # one layer's projections
                for key, v in zip(keys, (t_k, t_p, bms, t_l)):
                    row[key] += v
                row["bound_by"] = by
        del w, layer, b, w_lib, xs, alone, fours
    log(f"K1: {n_same} products, every column of each bit-identical to the "
        "same column run alone and among 4 (gather and wide variants); "
        "kernels a call by variant (profiler): "
        + json.dumps({k: sorted(v, key=str) for k, v in calls.items()}))
    for (kern, batch), row in totals.items():
        log(f"K1 {kern} one layer (7 projections, B={batch}): "
            + " ".join(f"{k}={row[k]:.4f}" for k in keys))
    log("K1 acsr_spmv_gather one rwkv6-7b layer (8 projections, B=4): "
        + " ".join(f"{k}={rwkv6[k]:.4f}" for k in keys))
    times = {}
    for (kern, batch), row in totals.items():
        times.setdefault(kern, {})[batch] = row
    log("K1 acsr_spmv_gather one hymba-1.5b layer (9 projections, B=4): "
        + " ".join(f"{k}={hymba[k]:.4f}" for k in keys))
    return errs, times, {"rwkv6-7b": rwkv6, "hymba-1.5b": hymba}


def time_gather(dev, flush):
    """``--time-gather``: K1's gather variant through ``acsr_spmv`` at 1, 4
    and 8 columns, a llama3-8b layer (7 projections) and a rwkv6-7b layer
    (8), aida 0.25, beside bf16 ``torch.matmul``; ms a layer, summed over
    the projections, each the median of 20 with L2 flushed.  Uses only the
    wrapper, so a checkout of another commit can be timed by copying this
    script into it."""
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kernels import acsr_spmv as sp
    widths = (1, 4, 8)
    for model, projections in (("llama3-8b", PROJECTIONS),
                               ("rwkv6-7b", RWKV6_PROJECTIONS)):
        gen = torch.Generator(device=dev).manual_seed(0)
        ms = dict.fromkeys(widths, 0.0)
        lib = dict.fromkeys(widths, 0.0)
        for _, n_out, n_in in projections:
            w = torch.randn((n_out, n_in), generator=gen,
                            device=dev) * n_in ** -0.5
            b = sfc.compress(w, mode="aida", density=0.25).blocked
            w_lib = w.T.contiguous().to(torch.bfloat16)
            xs = torch.randn((n_in, max(widths)), generator=gen, device=dev)
            for m in widths:
                x = xs[:, :m].contiguous()
                ms[m] += median_ms(lambda: sp.acsr_spmv(b, x), flush=flush)[0]
                x_lib = x.T.contiguous().to(torch.bfloat16)
                lib[m] += median_ms(lambda: torch.matmul(x_lib, w_lib),
                                    flush=flush)[0]
            del w, b, w_lib, xs
        for m in widths:
            log(f"K1 gather one {model} layer ({len(projections)} "
                f"projections, B={m}): kernel_ms={ms[m]:.4f} "
                f"library_ms={lib[m]:.4f}")


# ------------------------------------------------------------------ K2
# contexts K2 and K3 are timed at (37: the serve's, in a table of 256)
PAGED_TIMED = ((37, 256), (256, 256), (2048, 2048), (8192, 8192))
# head dims beside llama3-8b's 128, held against the plain version:
# (Dh, H, Hkv, the window and softcap of the windowed case) of
# h2o-danube-1.8b, phi-3-vision-4.2b, qwen1.5-0.5b, gemma2-2b (its
# attention softcap) and hymba-1.5b (a query group of 5, its window 1024)
PAGED_HEAD_DIMS = ((80, 32, 8, 64, 30.0), (96, 32, 32, 64, 30.0),
                   (64, 16, 16, 64, 30.0), (256, 8, 4, 64, 50.0),
                   (64, 25, 5, 1024, None))
# the served geometries of this slice's models, timed at contexts 37 and
# 2048 beside llama3-8b's: (model, H, Hkv, Dh, window)
PAGED_MODELS = (("hymba-1.5b", 25, 5, 64, 1024),
                ("phi-3-vision-4.2b", 32, 32, 96, -1))
# llama3-8b's (page size, context) beside the serves' 16-key pages: the
# engine benchmarks' pages of 8 (serving, disagg, resil, capacity) and the
# 64 positions of their caches
PAGED_BENCH = ((8, 37), (8, 64), (16, 64))


def _k2_inputs(dev, gen, ctx, kv_dtype, batch=4, h=32, hkv=8, dh=128,
               ps=16, max_len=None):
    import torch
    from repro_torch.kvstore.pool import PagedKV
    npp = -(-(max_len or ctx) // ps)
    n_pages = 1 + batch * npp
    shape = (n_pages, hkv, ps, dh)
    if kv_dtype == "bf16":
        pool = PagedKV(
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16))
    else:
        pool = PagedKV(
            torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8),
            torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8),
            torch.rand((n_pages, hkv), generator=gen, device=dev) / 127,
            torch.rand((n_pages, hkv), generator=gen, device=dev) / 127)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm[: batch * npp].reshape(batch, npp).to(torch.int32)
    live = -(-ctx // ps)
    table[:, live:] = -1
    table[1, ::3] = -1                        # holes
    table[batch - 1] = -1                     # an idle row: no page at all
    cur = torch.full((batch,), ctx - 1, dtype=torch.int32, device=dev)
    q = torch.randn((batch, h, dh), generator=gen,
                    device=dev).to(torch.bfloat16)
    return q, pool, table.contiguous(), cur


def _alone_equals_among(fn, q, table, pos, out, what):
    """Every batch row run alone (B = 1) gives the bits it gets among the
    batch's rows: the split plan and the arithmetic are the row's own."""
    import torch
    for i in range(q.shape[0]):
        alone = fn(q[i:i + 1], table[i:i + 1].contiguous(),
                   pos[i:i + 1].contiguous())
        if not torch.equal(alone, out[i:i + 1]):
            raise AssertionError(f"{what}: row {i} alone differs from the "
                                 "same row among the batch")


def _paged_bound(dev, table, pos, hkv, ps, dh, q, out_elems, mask_pairs,
                 elem=2):
    """(bound ms, what bounds it): the live pages of each row read once
    (up to the page of its furthest query; ``elem`` bytes a value, int8
    pages with their f32 scales), q, table and positions read, the f32
    output written; 4 flops per open (query, key) pair, head dim and
    query head, at the bf16 tensor-core peak."""
    import torch
    npp = table.shape[1]
    last = torch.clamp(pos.reshape(table.shape[0], -1).max(dim=1).values
                       // ps, max=npp - 1)
    live_pages = int(((table >= 0) & (
        torch.arange(npp, device=dev)[None, :] <= last[:, None])).sum())
    moved = 2 * live_pages * hkv * (ps * dh * elem + (4 if elem == 1
                                                      else 0)) + \
        q.numel() * 2 + out_elems * 4 + table.numel() * 4 + pos.numel() * 4
    return bound(moved, 4 * mask_pairs * dh, BF16_FLOPS), live_pages


def k2_phase(dev, flush):
    """K2 against its plain version at llama3-8b's geometry (contexts 37
    and 2048, bf16 and int8 pages, window -1 / 64, cap none / 30, a row
    with holes, an idle row; PAGED_BENCH's pages of 8 and context 64),
    every row alone bit-identical to the same row among 4; at Dh 80,
    96, 64 and 256 (softcap 50) and hymba's query group of 5 (25 / 5
    heads, window 1024); with an f32 q; then timed at PAGED_TIMED and at
    PAGED_MODELS' geometries.  Returns (max abs err,
    {ctx: times}, {(model, ctx): times})."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kvstore.paged_attention import paged_attention
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err, n = 0.0, 0
    cases = [(128, 32, 8, ctx, kv, window, cap, 16)
             for ctx in (37, 2048) for kv in ("bf16", "int8")
             for window in (-1, 64) for cap in (None, 30.0)]
    cases += [(dh, h, hkv, ctx, kv, window, cap, 16)
              for dh, h, hkv, win, wcap in PAGED_HEAD_DIMS
              for ctx in (37, 2048) for kv in ("bf16", "int8")
              for window, cap in ((-1, None), (win, wcap))]
    cases += [(128, 32, 8, ctx, kv, -1, None, ps)
              for ps, ctx in PAGED_BENCH for kv in ("bf16", "int8")]
    for dh, h, hkv, ctx, kv_dtype, window, cap, ps in cases:
        q, pool, table, cur = _k2_inputs(dev, gen, ctx, kv_dtype, h=h,
                                         hkv=hkv, dh=dh, ps=ps)
        scale = dh ** -0.5
        what = (f"paged_attention Dh={dh} H={h}/{hkv} ctx={ctx} {kv_dtype} "
                f"window={window} cap={cap} ps={ps}")
        out = paged_attention(q, pool, table, cur, window, scale=scale,
                              cap=cap)
        plain = ref.paged_attention_ref(q, *pool, table, cur, window, scale,
                                        cap)
        torch.cuda.synchronize()
        max_err = max(max_err, check_close(what, out, plain, 0, 1e-4))
        _alone_equals_among(lambda qq, tt, cc: paged_attention(
            qq, pool, tt, cc, window, scale=scale, cap=cap),
            q, table, cur, out, what)
        n += 1
        if dh == 128 and ctx == 2048 and window < 0 and cap is None:
            out = paged_attention(q.float(), pool, table, cur, -1,
                                  scale=scale)
            plain = ref.paged_attention_ref(q.float(), *pool, table, cur,
                                            -1, scale, None)
            max_err = max(max_err, check_close(what + " f32 q", out, plain,
                                               0, 1e-4))
            n += 1
    log(f"K2 {n} cases agree (Dh 128, 80, 96, 64, 256; a query group of "
        f"5; f32 q; pages of 16 and 8), max abs err {max_err:.2e}; every "
        "row alone bit-identical to it among 4")
    rows = {ctx: _time_k2(dev, gen, flush, ctx, max_len, "")
            for ctx, max_len in PAGED_TIMED}
    models = {(m, ctx): _time_k2(dev, gen, flush, ctx, ctx, f" {m}", win,
                                 h=h, hkv=hkv, dh=dh)
              for m, h, hkv, dh, win in PAGED_MODELS for ctx in (37, 2048)}
    return max_err, rows, models


def _time_k2(dev, gen, flush, ctx, max_len, label, window=-1,
             kv_dtype="bf16", **geo):
    """K2's, its plain version's and SDPA's times (on K / V gathered from
    bf16 pages, the window as a mask; int8 pages have no library call) at
    one context and geometry, beside its bound.  Returns the row of the
    kernels line."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kvstore.paged_attention import paged_attention
    from repro_torch.kvstore.pool import chunk_attention_mask
    q, pool, table, cur = _k2_inputs(dev, gen, ctx, kv_dtype,
                                     max_len=max_len, **geo)
    _, hkv, ps, dh = pool.k_pages.shape
    b, h = q.shape[:2]
    scale = dh ** -0.5
    mask = chunk_attention_mask(table, cur[:, None], window, ps)  # [B, 1, S]
    pairs = int(mask.sum()) * h
    (bms, by), live_pages = _paged_bound(dev, table, cur, hkv, ps, dh, q,
                                         b * h * dh, pairs,
                                         pool.k_pages.element_size())
    t_k, host = median_ms(lambda: paged_attention(
        q, pool, table, cur, window, scale=scale), flush=flush)
    t_p, _ = median_ms(lambda: ref.paged_attention_ref(
        q, *pool, table, cur, window, scale, None), iters=5, flush=flush)
    if kv_dtype != "bf16":
        log(f"K2{label} H={h}/{hkv} Dh={dh} ps={ps} {kv_dtype} "
            f"window={window} ctx={ctx} npp={table.shape[1]} "
            f"live_pages={live_pages} kernel_ms={t_k:.4f} "
            f"plain_ms={t_p:.4f} bound_ms={bms:.5f} ({by}) "
            f"host_enqueue_ms={host:.4f}")
        return {"ms": t_k, "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
                "library_ms": None}
    safe = table.long().clamp(min=0)[:, : -(-ctx // ps)]
    kk = pool.k_pages[safe].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, -1, dh)[:, :, :ctx].contiguous()
    vv = pool.v_pages[safe].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, -1, dh)[:, :, :ctx].contiguous()
    qq = q[:, :, None, :]
    amask = None if window < 0 else \
        mask[:, None, :, :ctx].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l, _ = median_ms(lambda: sdpa(qq, kk, vv, attn_mask=amask, scale=scale,
                                    enable_gqa=True), flush=flush)
    log(f"K2{label} H={h}/{hkv} Dh={dh} ps={ps} window={window} ctx={ctx} "
        f"npp={table.shape[1]} live_pages={live_pages} kernel_ms={t_k:.4f} "
        f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={bms:.5f} ({by}) "
        f"host_enqueue_ms={host:.4f}")
    return {"ms": t_k, "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
            "library_ms": t_l}


# ------------------------------------------------------------------ K3
def _k3_inputs(dev, gen, ctx, kv_dtype, chunk, max_len=None, **geo):
    """K2's pool and table (holes in row 1, row 3 idle) with a chunk of
    queries per row: rows 0 and 1 end their chunk at ``ctx - 1``; row 2
    feeds 3 tokens, so its padded queries run past the written context,
    into -1 table entries (and past the table at the widest context)."""
    import torch
    q1, pool, table, _ = _k2_inputs(dev, gen, ctx, kv_dtype,
                                    max_len=max_len, **geo)
    b, h, dh = q1.shape
    q = torch.randn((b, h, chunk, dh), generator=gen,
                    device=dev).to(torch.bfloat16)
    start = torch.tensor([ctx - chunk, ctx - chunk, ctx - 3, 0],
                         dtype=torch.int32, device=dev)
    q_pos = (start[:, None] + torch.arange(chunk, dtype=torch.int32,
                                           device=dev)).contiguous()
    return q, pool, table, q_pos


def k3_phase(dev, flush):
    """K3 against its plain version at C = 1 and 8 over K2's cases (and
    Dh 80 / 96 / 64 / 256 and hymba's group of 5 at C = 8, that group at
    C = 1 too; llama3-8b at C = 4 and 8 over PAGED_BENCH's pages and
    contexts, the engine benchmarks' chunks): at C = 1 bit-identical to
    K2; at C = 4 and 8 every row bit-identical to K2 on that query alone
    at its position, and every batch row alone to it among 4; then timed
    at C = 8 at PAGED_TIMED and at phi-3-vision's geometry.  Returns
    (max abs err, {ctx: times}, {(model, ctx): times})."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err, n = 0.0, 0
    cases = [(128, 32, 8, chunk, ctx, kv, window, cap, 16)
             for chunk in (1, 8) for ctx in (37, 2048)
             for kv in ("bf16", "int8") for window in (-1, 64)
             for cap in (None, 30.0)]
    cases += [(dh, h, hkv, 8, ctx, kv, window, cap, 16)
              for dh, h, hkv, win, wcap in PAGED_HEAD_DIMS
              for ctx in (37, 2048) for kv in ("bf16", "int8")
              for window, cap in ((-1, None), (win, wcap))]
    cases += [(64, 25, 5, 1, ctx, "bf16", window, None, 16)
              for ctx in (37, 2048) for window in (-1, 1024)]
    cases += [(128, 32, 8, chunk, ctx, kv, -1, None, ps)
              for chunk in (4, 8) for ps, ctx in PAGED_BENCH
              for kv in ("bf16", "int8")]
    for dh, h, hkv, chunk, ctx, kv_dtype, window, cap, ps in cases:
        q, pool, table, q_pos = _k3_inputs(dev, gen, ctx, kv_dtype, chunk,
                                           h=h, hkv=hkv, dh=dh, ps=ps)
        scale = dh ** -0.5
        what = (f"paged_attention_chunk C={chunk} Dh={dh} H={h}/{hkv} "
                f"ctx={ctx} {kv_dtype} window={window} cap={cap} ps={ps}")
        out = paged_attention_chunk(q, pool, table, q_pos, window,
                                    scale=scale, cap=cap)
        plain = ref.paged_attention_chunk_ref(q, *pool, table, q_pos,
                                              window, scale, cap)
        torch.cuda.synchronize()
        max_err = max(max_err, check_close(what, out, plain, 0, 1e-4))
        n += 1
        # each query of the chunk, decoded alone at its position (C = 1:
        # the reference's own contract)
        for ci in range(chunk):
            dec = paged_attention(q[:, :, ci].contiguous(), pool, table,
                                  q_pos[:, ci].contiguous(), window,
                                  scale=scale, cap=cap)
            if not torch.equal(dec, out[:, :, ci]):
                raise AssertionError(f"{what}: query {ci} differs from the "
                                     "decode kernel on it alone")
        _alone_equals_among(lambda qq, tt, pp: paged_attention_chunk(
            qq, pool, tt, pp, window, scale=scale, cap=cap),
            q, table, q_pos, out, what)
    log(f"K3 {n} cases agree (Dh 128, 80, 96, 64, 256; a query group of "
        "5 at C = 1 and 8; llama3-8b at C = 4 and 8 on pages of 8), max "
        "abs err "
        f"{max_err:.2e}; "
        "every query bit-identical to K2 on it alone (C = 1 and 8), every "
        "row alone to it among 4")
    rows = {ctx: _time_k3(dev, gen, flush, ctx, max_len, "")
            for ctx, max_len in PAGED_TIMED}
    # this slice's chunked serve: phi-3-vision (hymba serves at chunk 1)
    models = {(m, ctx): _time_k3(dev, gen, flush, ctx, ctx, f" {m}", win,
                                 h=h, hkv=hkv, dh=dh)
              for m, h, hkv, dh, win in PAGED_MODELS[1:]
              for ctx in (37, 2048)}
    return max_err, rows, models


def _time_k3(dev, gen, flush, ctx, max_len, label, window=-1, chunk=8,
             **geo):
    """K3's (C = ``chunk``, bf16 pages), its plain version's and SDPA's
    (chunk mask) times at one context and geometry, beside its bound.
    Returns the row of the kernels line."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kvstore.paged_attention import paged_attention_chunk
    from repro_torch.kvstore.pool import chunk_attention_mask
    q, pool, table, q_pos = _k3_inputs(dev, gen, ctx, "bf16", chunk,
                                       max_len=max_len, **geo)
    _, hkv, ps, dh = pool.k_pages.shape
    b, h, c = q.shape[:3]
    scale = dh ** -0.5
    mask = chunk_attention_mask(table, q_pos, window, ps)     # [B, C, S]
    (bms, by), live_pages = _paged_bound(
        dev, table, q_pos, hkv, ps, dh, q, q.numel(), int(mask.sum()) * h)
    t_k, host = median_ms(lambda: paged_attention_chunk(
        q, pool, table, q_pos, window, scale=scale), flush=flush)
    t_p, _ = median_ms(lambda: ref.paged_attention_chunk_ref(
        q, *pool, table, q_pos, window, scale, None), iters=5, flush=flush)
    safe = table.long().clamp(min=0)
    kk = pool.k_pages[safe].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, -1, dh).contiguous()
    vv = pool.v_pages[safe].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, -1, dh).contiguous()
    amask = mask[:, None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l, _ = median_ms(lambda: sdpa(q, kk, vv, attn_mask=amask, scale=scale,
                                    enable_gqa=True), flush=flush)
    log(f"K3{label} C={c} H={h}/{hkv} Dh={dh} ps={ps} window={window} "
        f"ctx={ctx} "
        f"npp={table.shape[1]} live_pages={live_pages} kernel_ms={t_k:.4f} "
        f"plain_ms={t_p:.4f} library_ms={t_l:.4f} bound_ms={bms:.5f} ({by}) "
        f"host_enqueue_ms={host:.4f}")
    return {"ms": t_k, "plain_ms": t_p, "bound_ms": bms, "bound_by": by,
            "library_ms": t_l}


# -------------------------------------------------------------- K4, K5
#: the rows K4 and K5 are held and timed at: a decode step of the engine
#: benchmarks' 2 slots and of the serves' 4, and a chunk-8 step of 4 slots
FC_ROWS = (2, 4, 32)


def fc_phase(dev, flush):
    """K4 (int8) and K5 (codebook4) against their plain versions at
    llama3-8b's seven projections, at the decode rows (M = 2, 4) and a
    chunk-8 step's rows (M = 32), with bias on wq and silu on gate, and at
    gemma2-2b's gate with its tanh-gelu epilogue (not timed); every
    call repeated bit for bit, and every row alone bit-identical to the
    same row among the others.  Times are summed over one layer's seven
    projections per M; the bound counts the bf16 tensor-core rate."""
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import lut_matmul as lm
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = {"int8": 0.0, "codebook4": 0.0}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = {(mode, m): dict.fromkeys(keys, 0.0)
           for mode in errs for m in FC_ROWS}
    unequal = []
    for name, n_out, n_in in PROJECTIONS + [GELU_GATE]:
        w = torch.randn((n_out, n_in), generator=gen, device=dev) * \
            n_in ** -0.5
        act = {"gate": "silu", GELU_GATE[0]: "gelu"}.get(name)
        bias = torch.randn((n_out,), generator=gen, device=dev) \
            if name == "wq" else None
        for mode in errs:
            layer = sfc.compress(w, mode=mode)
            if mode == "int8":
                wts = (layer.qt.q, layer.qt.scale)
                kern, plain_fn = i8.int8_matmul, i8.int8_matmul_ref
                wbytes = n_out * n_in + n_out * 4
            else:
                wts = (layer.codes_packed, layer.centroids)
                kern, plain_fn = lm.lut_matmul, lm.lut_matmul_ref
                wbytes = n_out * n_in // 2 + 64
            w_lib = sfc.dense_equivalent(layer).T.contiguous().to(
                torch.bfloat16)
            for m in FC_ROWS:
                x = torch.randn((m, n_in), generator=gen, device=dev)
                out = kern(x, *wts, bias=bias, activation=act)
                again = kern(x, *wts, bias=bias, activation=act)
                alone = torch.cat([kern(x[i:i + 1], *wts, bias=bias,
                                        activation=act) for i in range(m)])
                plain = plain_fn(x, *wts, bias, act)
                torch.cuda.synchronize()
                what = f"{mode} {name} M={m}"
                err = check_close(what, out, plain, 1e-4, 1e-4)
                errs[mode] = max(errs[mode], err)
                if not torch.equal(again, out):
                    unequal.append(f"{what}: a rerun")
                rows = (alone != out).any(dim=1).nonzero().flatten()
                if len(rows):
                    unequal.append(f"{what}: {len(rows)} of {m} rows alone")
                if name == GELU_GATE[0]:      # held, not part of a layer
                    log(f"{'K4' if mode == 'int8' else 'K5'} {mode:9s} "
                        f"{name} {n_out}x{n_in} M={m:2d} gelu err={err:.2e}")
                    continue
                moved = wbytes + m * n_in * 4 + m * n_out * 4 + \
                    (n_out * 4 if bias is not None else 0)
                bms, by = bound(moved, 2 * m * n_out * n_in, BF16_FLOPS)
                t_k, host = median_ms(lambda: kern(x, *wts, bias=bias,
                                                   activation=act),
                                      flush=flush)
                t_p, _ = median_ms(lambda: plain_fn(x, *wts, bias, act),
                                   iters=5, flush=flush)
                x_lib = x.to(torch.bfloat16)
                t_l, _ = median_ms(lambda: torch.matmul(x_lib, w_lib),
                                   flush=flush)
                log(f"{'K4' if mode == 'int8' else 'K5'} {mode:9s} "
                    f"{name:4s} {n_out}x{n_in} M={m:2d} err={err:.2e} "
                    f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                    f"library_ms={t_l:.4f} bound_ms={bms:.4f} ({by}) "
                    f"host_enqueue_ms={host:.4f}")
                row = tot[(mode, m)]
                for key, v in zip(keys, (t_k, t_p, bms, t_l)):
                    row[key] += v
                row[by] = row.get(by, 0.0) + bms
            del layer, w_lib
        del w
    for (mode, m), row in tot.items():
        # the label of the larger share of the summed bound
        row["bound_by"] = max(("bytes", "operations"),
                              key=lambda k: row.pop(k, 0.0))
        log(f"{mode} one layer (7 projections, M={m}): "
            + " ".join(f"{k}={row[k]:.4f}" for k in keys)
            + f" bound_by={row['bound_by']}")
    log("K4/K5 bit for bit (reruns; every row alone vs among 2, 4 and 32): "
        + ("all equal" if not unequal else "; ".join(unequal)))
    if unequal:
        raise AssertionError("K4/K5: results that should repeat bit for "
                             "bit differ: " + "; ".join(unequal))
    return errs, tot


# ---------------------------------------------------------------- tuner
TUNE_CONTEXTS = (37, 2048, 8192)
TUNE_ROWS = (4, 32)            # a decode step's and a chunk-8 step's


def _us(fn, flush):
    """Device microseconds of one call of ``fn`` (median of 10)."""
    return median_ms(fn, iters=10, warmup=2, flush=flush)[0] * 1e3


def _tune_table(label, key, cands, times, default):
    """Log every candidate's µs (summed over ``times``' shapes), the
    winner and the default beside it; returns the winner."""
    tot = [sum(t.values()) for t in times]
    win = min(range(len(cands)), key=lambda i: tot[i])
    cells = "; ".join(
        f"{json.dumps(dict(c.tiles))} "
        + " ".join(f"{k}={v:.1f}" for k, v in t.items())
        + (" [default]" if c == default else "")
        for c, t in zip(cands, times))
    log(f"tune {label} {key}: {cells}; winner {json.dumps(dict(cands[win].tiles))}"
        f" {tot[win]:.1f} us vs default {tot[cands.index(default)]:.1f} us")
    return cands[win], tot[win], tot[cands.index(default)]


def tune_phase(dev, flush):
    """The tuner's candidate launch plans at llama3-8b's shapes, each held
    to what the plan must keep (`kernels.tune`): every candidate timed
    (device µs), the winner beside today's default.  K1 (aida 0.25, the
    seven projections): every (sy, nsplit) candidate within K1's
    tolerance of the plain version at 4 and 32 columns, and each column
    at 4 and at 32 columns bit for bit the same column alone.  K4 / K5
    (the seven projections): every K split within tolerance at 4 and 32
    rows, and each row alone bit for bit the same row among 32.  K2 / K3
    (H 32 / Hkv 8, Dh 128, pages of 16, bf16 and int8) at contexts
    TUNE_CONTEXTS: under every range K2 within tolerance of its plain
    version, and under every range and query tile K3 at C = 8 bit for bit
    K2 on each of its queries.  Nothing is recorded in the tuner's cache:
    the serves tune their own geometries.  Returns {kernel: (winner µs,
    default µs) summed over its shapes}."""
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.kernels import build, ref, tune
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    sms = build.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    gain = {}

    def add(name, won, default):
        w, d = gain.get(name, (0.0, 0.0))
        gain[name] = (w + won, d + default)

    for name, n_out, n_in in PROJECTIONS:           # K1
        w = _k1_weight(gen, dev, n_out, n_in, name)
        b = sfc.compress(w, mode="aida", density=0.25).blocked
        del w
        key = tune.acsr_key(b.nblocks, b.rmax, b.block_rows, n_in, True, sms)
        xs = torch.randn((n_in, max(TUNE_ROWS)), generator=gen, device=dev)
        plain = {m: ref.blocked_acsr_spmv_ref(
            b.values, b.col_idx, b.row_nnz, xs[:, :m].contiguous(),
            b.centroids, None, None)[:n_out] for m in TUNE_ROWS}
        cands = tune.acsr_candidates(b.nblocks, b.rmax, b.block_rows, sms)
        times = []
        for cand in cands:
            with tune.trial(key, cand):
                alone = torch.stack([sp.acsr_spmv(b, xs[:, j].contiguous())
                                     for j in range(xs.shape[1])], 1)
                t = {}
                for m in TUNE_ROWS:
                    x = xs[:, :m].contiguous()
                    out = sp.acsr_spmv(b, x)
                    what = f"K1 {name} {dict(cand.tiles)} B={m}"
                    check_close(what, out, plain[m], 1e-4, 1e-4)
                    if not torch.equal(out, alone[:, :m]):
                        raise AssertionError(f"{what}: a column differs "
                                             "from the same column alone")
                    t[f"B{m}"] = _us(lambda: sp.acsr_spmv(b, x), flush)
            times.append(t)
        won, t_w, t_d = _tune_table(f"K1 {name}", key, cands, times,
                                    cands[0])
        add("acsr_spmv", t_w, t_d)
        del b, xs, plain
    for name, n_out, n_in in PROJECTIONS:           # K4, K5
        w = torch.randn((n_out, n_in), generator=gen, device=dev) * \
            n_in ** -0.5
        x = torch.randn((max(TUNE_ROWS), n_in), generator=gen, device=dev)
        for mode in ("int8", "codebook4"):
            layer = sfc.compress(w, mode=mode)
            if mode == "int8":
                wts = (layer.qt.q, layer.qt.scale)
                kern, plain_fn = i8.int8_matmul, i8.int8_matmul_ref
            else:
                wts = (layer.codes_packed, layer.centroids)
                kern, plain_fn = lm.lut_matmul, lm.lut_matmul_ref
            key = tune.fc_key(mode, n_out, n_in, sms)
            cands = tune.fc_candidates(n_out, n_in, sms)
            times = []
            for cand in cands:
                with tune.trial(key, cand):
                    alone = torch.cat([kern(x[i:i + 1], *wts)
                                       for i in range(x.shape[0])])
                    t = {}
                    for m in TUNE_ROWS:
                        xm = x[:m].contiguous()
                        out = kern(xm, *wts)
                        what = f"{mode} {name} {dict(cand.tiles)} M={m}"
                        check_close(what, out, plain_fn(xm, *wts, None, None),
                                    1e-4, 1e-4)
                        if m == max(TUNE_ROWS) and not torch.equal(out,
                                                                   alone):
                            raise AssertionError(f"{what}: a row alone "
                                                 "differs from it among "
                                                 f"{m}")
                        t[f"M{m}"] = _us(lambda: kern(xm, *wts), flush)
                times.append(t)
            won, t_w, t_d = _tune_table(f"{mode} {name}", key, cands, times,
                                        cands[0])
            add(mode, t_w, t_d)
            del layer
        del w, x
    for kv in ("bf16", "int8"):                     # K2, K3
        for ctx in TUNE_CONTEXTS:
            q, pool, table, q_pos = _k3_inputs(dev, gen, ctx, kv, 8)
            b, h, c, dh = q.shape
            hkv, ps = pool.k_pages.shape[1], pool.k_pages.shape[2]
            scale = dh ** -0.5
            rkey = tune.paged_key(hkv, h // hkv, dh, ps, kv == "int8", sms)
            ckey = tune.paged_chunk_key(hkv, h // hkv, dh, ps, c,
                                        kv == "int8", sms)
            qd, cur = q[:, :, -1].contiguous(), q_pos[:, -1].contiguous()
            plain = ref.paged_attention_ref(qd, *pool, table, cur, -1, scale,
                                            None)
            ranges = tune.paged_candidates()
            qts = tune.paged_chunk_candidates(c, h // hkv)
            rtimes, qtimes = [], {}
            for rc in ranges:
                with tune.trial(rkey, rc):
                    out = paged_attention(qd, pool, table, cur, -1,
                                          scale=scale)
                    what = f"K2 {kv} ctx={ctx} {dict(rc.tiles)}"
                    check_close(what, out, plain, 0, 1e-4)
                    dec = [paged_attention(q[:, :, ci].contiguous(), pool,
                                           table,
                                           q_pos[:, ci].contiguous(), -1,
                                           scale=scale) for ci in range(c)]
                    t = {"K2": _us(lambda: paged_attention(
                        qd, pool, table, cur, -1, scale=scale), flush)}
                    for qc in qts:
                        with tune.trial(ckey, qc):
                            got = paged_attention_chunk(q, pool, table,
                                                        q_pos, -1,
                                                        scale=scale)
                            for ci in range(c):
                                if not torch.equal(got[:, :, ci], dec[ci]):
                                    raise AssertionError(
                                        f"K3 {kv} ctx={ctx} "
                                        f"{dict(rc.tiles)} "
                                        f"{dict(qc.tiles)}: query {ci} "
                                        "differs from K2 on it alone")
                            tq = _us(lambda: paged_attention_chunk(
                                q, pool, table, q_pos, -1, scale=scale),
                                flush)
                        qtimes[(rc, qc)] = tq
                        if qc == qts[0]:
                            t["K3"] = tq
                rtimes.append(t)
            won, t_w, t_d = _tune_table(f"paged {kv} ctx={ctx}", rkey,
                                        ranges, rtimes, ranges[0])
            add("paged_attention", t_w, t_d)
            _tune_table(f"K3 qt {kv} ctx={ctx} range "
                        f"{won.tile('range')}", ckey, qts,
                        [{"K3": qtimes[(won, qc)]} for qc in qts], qts[0])
            del q, pool, table, q_pos
    log("tune phase (winner vs default µs, summed over the shapes): "
        + json.dumps({k: [round(w, 1), round(d, 1)]
                      for k, (w, d) in gain.items()}))
    return gain


def _log_pretune():
    """Log every session's pre-tuning (`Engine._pretune`): its seconds and
    the winners it added, in this process."""
    from repro_torch.api import engine
    if getattr(engine.Engine._pretune, "logged", False):
        return
    inner = engine.Engine._pretune

    def logged(self, batch_slots, *a, **kw):
        n = len(self.tune_log)
        inner(self, batch_slots, *a, **kw)
        for e in self.tune_log[n:]:
            log(f"pretune {self.cfg.name} ({self.cfg.n_layers} layers) at "
                f"{batch_slots} slots: {e['seconds']:.2f} s, "
                f"{e['new_keys']} new winners")
    logged.logged = True
    engine.Engine._pretune = logged


# ---------------------------------------------------------------- K7, K8
# (hkv, d, t, dtype, causal, window, softcap) at B = 2, H = 32; the first
# is the training path's shape (llama3-8b, 2 x 2048 tokens)
FLASH_CASES = [
    (8, 128, 2048, "bf16", True, None, None),
    (8, 128, 512, "bf16", True, 64, None),
    (8, 128, 512, "bf16", True, 128, 30.0),
    (4, 64, 512, "f32", True, None, 50.0),
    (2, 64, 512, "f32", False, None, None),
    (1, 128, 300, "f32", True, None, None),
    (2, 64, 333, "bf16", False, 64, 30.0),
    (8, 64, 1000, "f32", True, 128, None),
    (4, 128, 2048, "bf16", False, None, None),
    # the head dims of h2o-danube (80), phi-3-vision (96) and gemma2 (256,
    # softcap 50), in both dtypes
    (8, 80, 2048, "bf16", True, None, None),
    (8, 80, 333, "f32", True, 64, 30.0),
    (4, 80, 300, "bf16", False, None, 50.0),
    (32, 96, 512, "bf16", True, None, None),
    (4, 96, 333, "f32", False, 128, None),
    (8, 96, 300, "f32", True, None, 50.0),
    (4, 256, 2048, "bf16", True, None, 50.0),
    (4, 256, 512, "bf16", True, 128, 50.0),
    (2, 256, 333, "f32", True, None, 50.0),
    (4, 256, 300, "f32", False, 64, None),
]
# the same at other query-head counts (H first): hymba's group of 5 (25 /
# 5 heads, D 64, windowed) and hubert's non-causal multi-head attention
# (16 / 16, D 80)
FLASH_GROUP_CASES = [
    (25, 5, 64, 2048, "bf16", True, 1024, None),
    (25, 5, 64, 333, "f32", True, 64, None),
    (25, 5, 64, 300, "bf16", True, None, 30.0),
    (16, 16, 80, 2048, "bf16", False, None, None),
    (16, 16, 80, 333, "f32", False, None, None),
]
# the timed shapes at 2 x 2048 tokens, bf16: (model, H, Hkv, D, causal,
# window), a model's training (or, hubert, forward) attention
FLASH_TIMED = (("h2o-danube-1.8b", 32, 8, 80, True, None),
               ("phi-3-vision-4.2b", 32, 32, 96, True, None),
               ("llama3-8b", 32, 8, 128, True, None),
               ("gemma2-2b", 8, 4, 256, True, None),
               ("hymba-1.5b", 25, 5, 64, True, 1024),
               ("hubert-xlarge", 16, 16, 80, False, None))
# kernel vs plain version: both f32 over the same (bf16-exact) inputs,
# summed in another order (tiles vs whole rows; dk / dv over G * T rows);
# K7's and K8's f32 operands enter their tensor-core products as bf16
# hi + lo pairs, each product within ~2^-16 of the exact one
FLASH_TOL = {"o": 1e-4, "lse": 1e-4, "dq": 1e-3, "dk": 1e-3, "dv": 1e-3}
# K8's max abs errors over FLASH_CASES when its five products ran as f32
# FMAs out of shared memory (this phase on an H100 80GB HBM3 at 700 W),
# logged beside this run's
FLASH_ERR_FMA = {"dq": 8.940696716308594e-08, "dk": 1.1920928955078125e-07,
                  "dv": 9.5367431640625e-07}


def _flash_inputs(dev, gen, hkv, d, t, dtype, b=2, h=32):
    import torch
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)
    q = rnd((b, h, t, d), 0.3)
    k = rnd((b, hkv, t, d), 0.3)
    v = rnd((b, hkv, t, d), 1.0)
    do = torch.randn((b, h, t, d), generator=gen, device=dev)
    return q, k, v, do


def flash_phase(dev, flush):
    """K7 and K8 against their plain versions over FLASH_CASES (32 query
    heads) and FLASH_GROUP_CASES, each kernel twice (bit-identical), then
    times at each model's training shape.  Returns the max errors and the
    timing rows by kernel and model."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = dict.fromkeys(FLASH_TOL, 0.0)
    for h, hkv, d, t, dtype, causal, window, cap in \
            [(32,) + c for c in FLASH_CASES] + FLASH_GROUP_CASES:
        q, k, v, do = _flash_inputs(dev, gen, hkv, d, t, dtype, h=h)
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do * o).sum(dim=-1, keepdim=True)
        dq = fa.flash_attention_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
        again = (*fa.flash_attention_fwd(q, k, v, **kw),
                 fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
                 *fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw))
        torch.cuda.synchronize()
        what = (f"flash B=2 H={h} Hkv={hkv} D={d} T={t} {dtype} "
                f"causal={causal} window={window} softcap={cap}")
        for name, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse, dq, dk, dv), again):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs on rerun")
        po, plse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        want = {"o": po, "lse": plse,
                "dq": ref.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                                 **kw)}
        want["dk"], want["dv"] = ref.flash_attention_dkv_ref(
            q, k, v, do, lse, delta, **kw)
        line = []
        for name, tol in FLASH_TOL.items():
            err = check_close(f"{what} {name}", got[name], want[name], tol,
                              tol)
            errs[name] = max(errs[name], err)
            line.append(f"{name} {err:.2e}")
        log(f"{what}: max abs err " + ", ".join(line) + "; max abs "
            + ", ".join(f"{n} {float(x.abs().max()):.3g}"
                        for n, x in got.items()))
        if (h, hkv, d, t, causal, window, cap) == (32, 8, 128, 2048, True,
                                                   None, None):
            _sdpa_check(q, k, v, do, got)
        del q, k, v, do, o, lse, dq, dk, dv, again, po, plse, got, want
    log(f"K7/K8 {len(FLASH_CASES) + len(FLASH_GROUP_CASES)} cases agree "
        "(tolerance rtol = atol: "
        + ", ".join(f"{k} {v:g}" for k, v in FLASH_TOL.items())
        + "); o, lse, dq, dk and dv bit-identical on rerun in every case")
    log(f"K7 max abs err over the cases (tensor cores, p as bf16 hi + lo): "
        f"o {errs['o']:.3g}, lse {errs['lse']:.3g} (tolerance "
        f"{FLASH_TOL['o']:g})")
    log("K8 max abs err over the cases (tensor cores, split bf16): "
        + ", ".join(f"{k} {errs[k]:.3g} (f32 FMA: {v:.3g})"
                    for k, v in FLASH_ERR_FMA.items()))
    return errs, flash_times(dev, flush)


def _sdpa_check(q, k, v, do, got):
    """An oracle independent of the port: PyTorch's attention and its
    autograd on the same inputs in f32 (same math, a third summation
    order), within the kernel-vs-plain tolerances."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (x.float().requires_grad_(True) for x in (q, k, v))
    o = sdpa(qq, kk, vv, is_causal=True, enable_gqa=True)
    grads = torch.autograd.grad(o, (qq, kk, vv), do)
    errs = []
    for name, want in zip(("o", "dq", "dk", "dv"), (o.detach(), *grads)):
        tol = FLASH_TOL[name]
        err = check_close(f"SDPA {name}", got[name], want, tol, tol)
        errs.append(f"{name} {err:.2e}")
    log("flash vs SDPA (f32, autograd): max abs err " + ", ".join(errs))


def flash_times(dev, flush):
    """Kernel, plain-version and SDPA times at each FLASH_TIMED shape (B 2,
    T 2048, bf16, causal or not, windowed or not; gemma2's softcap left
    out so that SDPA computes the same function, a window given to SDPA as
    a mask) with the least time the card needs: bytes (inputs read once,
    outputs written once) over 3.35 TB/s vs the open pairs' multiply-adds
    over the bf16 peak (the inputs are bf16).  Forward 4 flops per (pair,
    dim): q.k and p.v; dq 6 (q.k, do.v, ds.k); dkv 8 (q.k, do.v, p.do,
    ds.q).  Returns {kernel: {model: row}}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {name: {} for name in FLASH}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for model, h, hkv, d, causal, window in FLASH_TIMED:
        t = 2048
        q, k, v, do = _flash_inputs(dev, gen, hkv, d, t, "bf16", h=h)
        b = q.shape[0]
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do * o).sum(dim=-1, keepdim=True)
        mask = ref._attention_mask(t, t, causal, window, dev)
        pairs = b * h * int(mask.sum())
        qkv = (q.numel() + 2 * k.numel()) * 2
        rows_f32 = b * h * t * 4                        # lse or delta
        work = {
            "flash_attention_fwd": (qkv + q.numel() * 4 + rows_f32,
                                    4 * pairs * d),
            "flash_attention_dq": (qkv + 2 * q.numel() * 4 + 2 * rows_f32,
                                   6 * pairs * d),
            "flash_attention_dkv": (qkv + q.numel() * 4 + 2 * rows_f32
                                    + 2 * k.numel() * 4, 8 * pairs * d),
        }
        calls = {
            "flash_attention_fwd": (
                lambda: fa.flash_attention_fwd(q, k, v, **kw),
                lambda: ref.flash_attention_fwd_ref(q, k, v, **kw)),
            "flash_attention_dq": (
                lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, **kw),
                lambda: ref.flash_attention_dq_ref(q, k, v, do, lse, delta,
                                                   **kw)),
            "flash_attention_dkv": (
                lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta,
                                               **kw),
                lambda: ref.flash_attention_dkv_ref(q, k, v, do, lse, delta,
                                                    **kw)),
        }
        lib = dict(is_causal=True) if causal and window is None else \
            dict(attn_mask=mask) if window is not None else {}
        lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
        lo = sdpa(lq, lk, lv, enable_gqa=True, **lib)
        ldo = do.to(torch.bfloat16)
        t_lf, _ = median_ms(lambda: sdpa(q, k, v, enable_gqa=True, **lib),
                            flush=flush)
        t_lb, _ = median_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), ldo, retain_graph=True), flush=flush)
        for name, (kern, plain) in calls.items():
            bms, by = bound(*work[name], BF16_FLOPS)
            t_k, host = median_ms(kern, flush=flush)
            t_p, _ = median_ms(plain, iters=5, flush=flush)
            fwd = name == "flash_attention_fwd"
            t_l = t_lf if fwd else t_lb
            log(f"{name} {model} B={b} H={h} Hkv={hkv} T={t} D={d} bf16 "
                f"causal={causal} window={window} kernel_ms={t_k:.4f} "
                f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                f"({'SDPA forward' if fwd else 'SDPA backward'}) "
                f"bound_ms={bms:.4f} ({by}) "
                f"tflops={work[name][1] / t_k / 1e9:.2f} "
                f"host_enqueue_ms={host:.4f}")
            rows[name][model] = {"head_dim": d, "ms": t_k, "plain_ms": t_p,
                                 "bound_ms": bms, "bound_by": by,
                                 "library_ms": t_l}
        del q, k, v, do, o, lse, delta, lq, lk, lv, lo, ldo, mask
    return rows


# ------------------------------------------------------------------ K9
# (B, H, T, Dk, Dv, r / k / v type, impl, chunk, tiny decay): the first is
# rwkv6-7b's forward shape (2 x 2048 tokens, 64 heads of 64, read through
# the model's strided head views); then the reference's own kernel test
# shapes, its tiny-decay case, a ragged T under impl="scan", the widest
# head the kernel takes, and a head whose rows are no whole 16-byte pieces
# (24 bytes: the kernel stages it with plain loads)
K9_CASES = [
    (2, 64, 2048, 64, 64, "bf16", "scan", 64, False),
    (2, 2, 128, 16, 16, "f32", "kernel", 32, False),
    (2, 2, 64, 32, 64, "f32", "kernel", 64, False),
    (2, 2, 96, 8, 8, "f32", "kernel", 16, False),
    (1, 1, 64, 8, 8, "f32", "kernel", 16, True),
    (2, 64, 300, 64, 64, "bf16", "scan", 64, False),
    (1, 2, 100, 128, 256, "f32", "scan", 64, False),
    (1, 3, 40, 12, 13, "bf16", "scan", 64, False),
]


def _k9_inputs(dev, gen, b, h, t, dk, dv, dtype, tiny):
    """r, k, w as [B, H, T, Dk] head views of [B, T, H * Dk] tensors (the
    layout the model hands over), v likewise, w = exp(-exp(N(0, 1))) in
    (0, 1) f32, u [H, Dk] f32; the tiny case is the reference's: r = k =
    0.1, v = 1, w = 1e-9, u = 0."""
    import torch
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def heads(d, scale):
        x = torch.randn((b, t, h * d), generator=gen, device=dev) * scale
        return x.to(dt).reshape(b, t, h, d).transpose(1, 2)
    if tiny:
        full = lambda d, val: torch.full((b, h, t, d), val, device=dev)
        return (full(dk, 0.1), full(dk, 0.1), full(dv, 1.0), full(dk, 1e-9),
                torch.zeros((h, dk), device=dev))
    r, k, v = heads(dk, 0.5), heads(dk, 0.5), heads(dv, 1.0)
    w = torch.exp(-torch.exp(torch.randn((b, t, h * dk), generator=gen,
                                         device=dev)))
    w = w.reshape(b, t, h, dk).transpose(1, 2)
    u = torch.randn((h, dk), generator=gen, device=dev)
    return r, k, v, w, u


def k9_phase(dev, flush):
    """K9 (the WKV scan) against its plain version over K9_CASES at rtol =
    atol = 1e-4 (the tiny-decay case also at the reference's 1e-5 / 1e-6):
    both run the recurrence in f32 on the same inputs and differ only in
    summation order.  ``impl="kernel"`` must raise where the reference's
    kernel asserts, and autograd must raise on the card.  Then times at
    the forward shape."""
    import torch
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(6)
    max_err = 0.0
    for b, h, t, dk, dv, dtype, impl, chunk, tiny in K9_CASES:
        args = _k9_inputs(dev, gen, b, h, t, dk, dv, dtype, tiny)
        out = ops.rwkv6(*args, impl=impl, chunk=chunk)
        plain = ref.rwkv6_ref(*args)
        torch.cuda.synchronize()
        what = (f"rwkv6 B={b} H={h} T={t} Dk={dk} Dv={dv} {dtype} impl={impl}"
                f"{' tiny decay' if tiny else ''}")
        err = check_close(what, out, plain, 1e-4, 1e-4)
        if tiny:
            check_close(what, out, plain, 1e-5, 1e-6)
        max_err = max(max_err, err)
        log(f"K9 {what}: max abs err {err:.2e}, max |o| "
            f"{float(out.abs().max()):.3g}")
    r, k, v, w, u = _k9_inputs(dev, gen, 1, 1, 96, 8, 8, "f32", False)
    try:
        ops.rwkv6(r, k, v, w, u, impl="kernel", chunk=64)
    except ValueError:
        pass
    else:
        raise AssertionError("rwkv6 impl='kernel' took T = 96 at chunk 64")
    try:
        ops.rwkv6(r.requires_grad_(True), k, v, w, u)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("rwkv6 ran under autograd on the card")
    log(f"K9 {len(K9_CASES)} cases agree, max abs err {max_err:.2e}; "
        "impl='kernel' raises on T = 96 at chunk 64, autograd raises")
    b, h, t, dk, dv = K9_CASES[0][:5]
    args = _k9_inputs(dev, gen, b, h, t, dk, dv, "bf16", False)
    # r, k, v bf16 and w f32 read once, u once, o f32 written once; 5
    # flops per state element and step: r.S, k * v, w * S + kv
    moved = b * h * t * (3 * dk * 2 + dk * 4 + dv * 4) + h * dk * 4
    bms, by = bound(moved, 5 * b * h * t * dk * dv)
    t_k, host = median_ms(lambda: ls.rwkv6_scan(*args), flush=flush)
    t_p, _ = median_ms(lambda: ref.rwkv6_ref(*args), iters=3, warmup=1,
                       flush=flush)
    log(f"K9 B={b} H={h} T={t} Dk={dk} Dv={dv} bf16 kernel_ms={t_k:.4f} "
        f"plain_ms={t_p:.4f} library_ms=none bound_ms={bms:.4f} ({by}) "
        f"host_enqueue_ms={host:.4f}")
    return max_err, {"ms": t_k, "plain_ms": t_p, "bound_ms": bms,
                     "bound_by": by, "library_ms": None}


# ------------------------------------------------------------------ K6
def _k6_inputs(dev, gen, b, n, k, nc=16):
    import torch
    x = torch.randint(0, nc, (b, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    w = torch.randint(0, nc, (n, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    packed = (w[:, 0::2] | (w[:, 1::2] << 4)).contiguous()
    cents = torch.sort(torch.randn((nc,), generator=gen, device=dev)).values
    return x, w, packed, cents


def k6_phase(dev, flush):
    """K6 (the fully-coded LUT product) against its plain version at
    llama3-8b's seven projections, B = 4 and 32, for both of the
    reference's tables (rank-1 outer(c, c) and tanh(lut) + 0.1 sign(lut)),
    then ragged B, N, K and nc: bit-identical (both sum the same f32 runs
    exactly in int64), and so within rtol = atol = 1e-4; an integer table
    exact, a rerun bit-identical, every x row alone bit-identical to it
    among 4 and among 32.  Times per layer (seven
    projections) by B, beside the rank-1 table's one library call,
    torch.matmul(c[x], c[w].T) in f32 on the codes dequantised beforehand,
    and the least time for the work: its bytes, or one f32 addition a
    weight byte and x row at the f32 add rate.  Returns the max error, the
    times and the launches of the entry point ``ops.lut_product_matmul``
    over the seven projections at both B, counted from 0."""
    import torch
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(7)
    max_err, n_cases = 0.0, 0
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = {m: dict.fromkeys(keys, 0.0) for m in (4, 32)}
    main = []

    def exact(name, out, plain):
        err = check_close(name, out, plain, 1e-4, 1e-4)
        if not torch.equal(out, plain):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max abs err {err})")
        return err
    for name, n, kdim in PROJECTIONS:
        x32, w, packed, c = _k6_inputs(dev, gen, 32, n, kdim)
        outer = torch.outer(c, c)
        for b in (4, 32):
            x = x32[:b].contiguous()
            outs = []
            for table in (outer, torch.tanh(outer) + 0.1 * torch.sign(outer)):
                outs.append(ops.lut_product_matmul(x, packed, table))
                plain = ref.lut_product_matmul_ref(x, packed, table)
                torch.cuda.synchronize()
                err = exact(f"lut_product {name} B={b}", outs[-1], plain)
                max_err, n_cases = max(max_err, err), n_cases + 1
            # the rank-1 table is a product of dequantised codes: one f32
            # matmul (another summation order) is an independent oracle
            xf, wf = c[x.long()], c[w.long()]
            check_close(f"lut_product {name} B={b} vs matmul", outs[0],
                        torch.matmul(xf, wf.T), 1e-3, 1e-3)
            # bytes: x codes, packed weights, the table, out; operations:
            # one f32 addition a weight byte and x row (a table of more
            # than two codes a look-up has more entries than rows share it)
            moved = b * kdim + n * kdim // 2 + 16 * 16 * 4 + b * n * 4
            bms, by = bound(moved, b * n * kdim // 2, F32_ADDS)

            def fn():
                return lm.lut_product_matmul(x, packed, outer)
            t_k, host = median_ms(fn, flush=flush)
            t_p, _ = median_ms(lambda: ref.lut_product_matmul_ref(
                x, packed, outer), iters=3, warmup=1, flush=flush)
            t_l, _ = median_ms(lambda: torch.matmul(xf, wf.T), flush=flush)
            log(f"K6 {name:4s} {n}x{kdim} B={b:2d} err={err:.2e} "
                f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f}"
                f" bound_ms={bms:.4f} ({by}) host_enqueue_ms={host:.4f} "
                "(equal to the plain version)")
            row = tot[b]
            for key, val in zip(keys, (t_k, t_p, bms, t_l)):
                row[key] += val
            row["bound_by"] = by
            main.append((b, (x, packed, outer)))
            del xf, wf, outs, plain
        # every x row alone, and in fours, against it among 32
        whole = lm.lut_product_matmul(x32, packed, outer)
        alone = torch.cat([lm.lut_product_matmul(x32[i:i + 1].contiguous(),
                                                 packed, outer)
                           for i in range(32)])
        fours = torch.cat([lm.lut_product_matmul(x32[i:i + 4].contiguous(),
                                                 packed, outer)
                           for i in range(0, 32, 4)])
        if not (torch.equal(alone, whole) and torch.equal(fours, whole)):
            raise AssertionError(f"lut_product {name}: a row alone or among 4"
                                 " differs from it among 32")
        del x32, w, packed, whole, alone, fours
    for b, n, kdim, nc in ((5, 1000, 4090, 16), (3, 77, 130, 9),
                           (33, 4096, 4096, 16), (1, 1, 2, 4)):
        x, w, packed, c = _k6_inputs(dev, gen, b, n, kdim, nc)
        outer = torch.outer(c, c)
        for table in (outer, torch.tanh(outer) + 0.1 * torch.sign(outer)):
            out = ops.lut_product_matmul(x, packed, table)
            plain = ref.lut_product_matmul_ref(x, packed, table)
            torch.cuda.synchronize()
            err = exact(f"lut_product B={b} N={n} K={kdim} nc={nc}", out,
                        plain)
            max_err, n_cases = max(max_err, err), n_cases + 1
    x, w, packed, _ = _k6_inputs(dev, gen, 6, 14336, 4096)
    ints = torch.arange(16, device=dev, dtype=torch.float32) - 8
    table = torch.outer(ints, ints)
    if not torch.equal(ops.lut_product_matmul(x, packed, table),
                       ref.lut_product_matmul_ref(x, packed, table)):
        raise AssertionError("lut_product: an integer table is not exact")
    again = ops.lut_product_matmul(x, packed, table)
    if not torch.equal(again, ops.lut_product_matmul(x, packed, table)):
        raise AssertionError("lut_product differs on rerun")
    log(f"K6 {n_cases} cases equal to the plain version (max abs err "
        f"{max_err:.2e}); an integer table is exact, a rerun repeats bit "
        "for bit, and every x row alone equals it among 4 and among 32 at "
        "the seven projections")
    for b, row in tot.items():
        log(f"K6 one layer (7 projections, B={b}): "
            + " ".join(f"{k}={row[k]:.4f}" for k in keys)
            + f" bound_by={row['bound_by']}")
    # the entry point at each B, its launch count set to 0 just before
    launches = {}
    for b in tot:
        lm.lut_product_matmul.launches = 0
        for _, args in (m for m in main if m[0] == b):
            ops.lut_product_matmul(*args)
        torch.cuda.synchronize()
        launches[b] = lm.lut_product_matmul.launches
        if launches[b] != len(PROJECTIONS):
            raise AssertionError(f"ops.lut_product_matmul at B={b} launched K6 "
                                 f"{launches[b]} times over "
                                 f"{len(PROJECTIONS)} calls")
    log(f"K6 entry point: launches by B {launches} over "
        f"{len(PROJECTIONS)} calls each")
    return max_err, tot, launches


def k6_kernels_a_call(dev):
    """One call of the K6 entry point launches one kernel, at B = 4 and 32
    (llama3-8b's wk), from the profiler; profiled beside K1's probes."""
    import torch
    from repro_torch.kernels import lut_matmul as lm
    gen = torch.Generator(device=dev).manual_seed(8)
    counts = {}
    for b in (4, 32):
        x, _, packed, c = _k6_inputs(dev, gen, b, 1024, 4096)
        outer = torch.outer(c, c)
        counts[b] = one_kernel(lambda: lm.lut_product_matmul(x, packed, outer),
                               "lut_product", f"lut_product B={b}")
    log(f"K6 kernels a call by B (profiler): "
        f"{json.dumps(counts)}")
    return counts


# --------------------------------------------------------------- serve
AP_SMALL = (96, 200)              # card vs CPU, both modes, m = n = 4
AP_LAYERS = (                     # (name, n_out, n_in, w / b density, mode)
    ("alexnet-fc6", 4096, 9216, 0.09, 0.35, "coded"),     # Table 1's
    ("alexnet-fc8", 1000, 4096, 0.25, 0.38, "bitserial"))


def _ap_problem(rng, n_out, n_in, w_density, b_density, mode):
    """An FCProblem of seed-made integers: coded, 4-bit codes (nonzero
    where drawn) over codebooks of 16 with cents[0] = 0 and the rest in
    -99..99; bit-serial, signed 4-bit operands (m = n = 4)."""
    import numpy as np
    from repro_torch.api import FCProblem

    def draw(shape, density, signed):
        v = rng.integers(1, 16, size=shape)
        if signed:
            v = v * rng.choice(np.array([-1, 1]), size=shape)
        return v * (rng.random(shape) < density)

    w = draw((n_out, n_in), w_density, mode == "bitserial")
    b = draw((n_in,), b_density, mode == "bitserial")
    if mode == "bitserial":
        return FCProblem(w=w, b=b, m=4, n=4)
    cents_w = np.concatenate([[0], rng.integers(-99, 100, 15)])
    cents_a = np.concatenate([[0], rng.integers(-99, 100, 15)])
    return FCProblem(w=w, b=b, m=4, n=4, coded=True, cents_w=cents_w,
                     cents_a=cents_a)


def _ap_run(prob, device):
    from repro_torch.core import aida_fc
    if prob.coded:
        return aida_fc.aida_fc_layer_coded(prob.w, prob.b, prob.cents_w,
                                           prob.cents_a, device=device)
    return aida_fc.aida_fc_layer(prob.w, prob.b, prob.m, prob.n,
                                 device=device)


def ap_emulator_phase(dev):
    """The paper's own model on the card (no kernel of the port: the
    emulator is plain tensor ops, as the JAX package's is numpy).  At 96 x
    200, coded and bit-serial, the card's emulator must give the CPU's
    out, rounds, eight counters and final CAM image; AlexNet FC6 (coded,
    Table 1's configuration) and FC8 (bit-serial) at full size through
    ``Engine.estimate(backend="ap-emulator")`` must give the integer
    oracle's out exactly, ``cycle-sim``'s closed-form cycles and
    ``aida_sim.reduction_rounds`` rounds; the ``cuda`` backend's run_fc on
    a llama3-8b aida projection must equal apply_fc on it; Table 1's
    ratios on the card's engine must equal the CPU engine's."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, get_backend
    from repro_torch.core import aida_sim, sparse_fc
    for mode in ("coded", "bitserial"):
        prob = _ap_problem(np.random.default_rng(0), *AP_SMALL, 0.3, 0.35,
                           mode)
        card, cpu = _ap_run(prob, dev), _ap_run(prob, "cpu")
        same = {"out": torch.equal(card.out.cpu(), cpu.out),
                "rounds": card.rounds == cpu.rounds,
                "counters": card.counters == cpu.counters,
                "cam": np.array_equal(card.ap.image(), cpu.ap.image())}
        log(f"ap emulator {mode} {AP_SMALL[0]} x {AP_SMALL[1]}: card vs "
            f"CPU {same}, {card.cycles} cycles, {card.rounds} rounds")
        if not all(same.values()):
            raise AssertionError(f"ap emulator {mode}: the card differs "
                                 f"from the CPU: {same}")
        del card, cpu
    eng = Engine()
    for name, n_out, n_in, wd, bd, mode in AP_LAYERS:
        prob = _ap_problem(np.random.default_rng(0), n_out, n_in, wd, bd,
                           mode)
        emu = eng.estimate(backend="ap-emulator", workload=prob)
        sim = eng.estimate(backend="cycle-sim", workload=prob)
        rounds = aida_sim.reduction_rounds(prob.max_row_nnz)
        c = emu["counters"]
        ops = c["compare"] + c["write"] + c["move"] + c["if_match"]
        row = {"mode": mode, "pus": emu["pus"], "bits": emu["bits"],
               "cam_mb": emu["pus"] * emu["bits"] / 1e6,
               "cycles": emu["cycles"], "closed_form": sim["cycles"],
               "rounds": emu["rounds"], "nnz_b": emu["nnz_b"],
               "max_row_nnz": emu["max_row_nnz"], "ap_ops": ops,
               "encode_load_s": emu["seconds"]["encode_load"],
               "run_s": emu["seconds"]["run"],
               "ap_ops_per_s": ops / emu["seconds"]["run"]}
        log(f"ap emulator {name} {n_out} x {n_in}: " + json.dumps(row))
        if not emu["exact"]:
            raise AssertionError(f"ap emulator {name}: out differs from "
                                 "the integer oracle")
        if emu["cycles"] != sim["cycles"] or emu["rounds"] != rounds:
            raise AssertionError(
                f"ap emulator {name}: {emu['cycles']} cycles and "
                f"{emu['rounds']} rounds, closed form {sim['cycles']} and "
                f"{rounds}")
        del emu
    gen = torch.Generator(device=dev).manual_seed(0)
    _, n_out, n_in = PROJECTIONS[0]
    leaf = sparse_fc.compress(_k1_weight(gen, dev, n_out, n_in, "wq"),
                              mode="aida", density=0.25)
    x = torch.randn((4, n_in), generator=gen, device=dev)
    if not torch.equal(get_backend("cuda").run_fc(leaf, x),
                       sparse_fc.apply_fc(leaf, x)):
        raise AssertionError("ap emulator: the cuda backend's run_fc "
                             "differs from apply_fc")
    t1 = {where: e.estimate(backend="cycle-sim", workload="table1")
          for where, e in (("card", eng), ("cpu", Engine(device="cpu")))}
    ratios = {where: (t["aida"]["pp_gops"] / t["eie"]["pp_gops"],
                      t["aida"]["thrpt_inf_s"] / t["eie"]["thrpt_inf_s"])
              for where, t in t1.items()}
    log(f"ap emulator table 1: AIDA {t1['card']['aida']['pp_gops']} GOP/s "
        f"vs EIE {t1['card']['eie']['pp_gops']} (x{ratios['card'][0]}), "
        f"{t1['card']['aida']['thrpt_inf_s']} vs "
        f"{t1['card']['eie']['thrpt_inf_s']} inferences/s "
        f"(x{ratios['card'][1]})")
    if ratios["card"] != ratios["cpu"]:
        raise AssertionError(f"ap emulator table 1: {ratios}")


def _llama(layers):
    import dataclasses
    from repro_torch import get
    cfg = get("llama3-8b")
    if layers != cfg.n_layers:
        log(f"depth cut: {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _launch_counters():
    """The eleven kernel wrappers, by the name the kernels line gives them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.acsr_spmv import spmv_gather, spmv_wide
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.linear_scan import rwkv6_scan
    from repro_torch.kernels.lut_matmul import lut_matmul, lut_product_matmul
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    return {"acsr_spmv_wide": spmv_wide, "acsr_spmv_gather": spmv_gather,
            "paged_attention_decode": paged_attention,
            "paged_attention_chunk": paged_attention_chunk,
            "int8_matmul": int8_matmul, "lut_matmul": lut_matmul,
            **{name: getattr(fa, name) for name in FLASH},
            "rwkv6_scan": rwkv6_scan,
            "lut_product_matmul": lut_product_matmul}


def _compressed_engine(dev, cfg, spec, label):
    import torch
    from repro_torch import Engine
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev, seed=0)
    eng.params                                        # random init
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.compress(spec)
    torch.cuda.synchronize(dev)
    t_comp = time.perf_counter() - t0
    log(f"{label}: init {t_init:.2f} s, compress {t_comp:.2f} s, ratio "
        f"{eng.stats['ratio']:.3f} vs bf16, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    return eng


def _requests(cfg, max_new=16):
    import numpy as np
    from repro_torch import Request
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_new=max_new, rid=i)
            for i, n in enumerate((5, 9, 16, 23))]


def _serve(dev, eng, label, fc_kernel, chunk, kv_cache=None):
    """Serve the four requests once, every launch count set to 0 just
    before and read just after; checks 4/4 requests, finite logits, no
    leaked page and that every projection and layer went through the
    kernels (on the full cache: no paged-attention launch, and chunk 1
    whatever ``chunk`` asks).  Returns (results, session, launch counts,
    the FC kernel's launches by kernel and rows: 4 on a decode step, 4 *
    chunk on a chunked one); the session's ``emitted`` holds each
    request's logits rows."""
    import torch
    sess = eng.session(batch_slots=4, max_len=256, kv_cache=kv_cache,
                       scheduler={"chunk": chunk})
    if sess.alloc is None and sess.stats["chunk"] != 1:
        raise AssertionError(f"{label}: a full-cache session must serve at "
                             f"chunk 1, got {sess.stats['chunk']}")
    if sess.backend.name != eng.backend.name:
        raise AssertionError(f"{label}: the session steps through "
                             f"{sess.backend.name!r}, not the engine's "
                             f"{eng.backend.name!r}")
    for r in _requests(eng.cfg):
        sess.submit(r)
    sess.emitted = {}
    emit = sess._emit

    def keep(i, logits_i, now):        # the row each token was drawn from
        sess.emitted.setdefault(sess.slot_entry[i].req.rid, []).append(
            logits_i.copy())
        emit(i, logits_i, now)
    sess._emit = keep
    fns = _launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    n_layers, n_fc = eng.cfg.n_layers, _fc_per_layer(eng)
    steps = sess.stats["steps"]
    pre = sess.stats["prefill_steps"]
    n_tok = sum(len(r.tokens) for r in res)
    log(f"{label}: {len(res)}/4 requests, {n_tok} tokens, {steps} steps "
        f"({pre} chunked, {steps - pre} decode), "
        f"{dt * 1e3 / steps:.2f} ms/step, {n_tok / dt:.2f} tok/s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB while "
        "serving")
    # the FC kernel's launches by kernel and rows: 4 on a decode step, 4 *
    # chunk on a chunked one (K1: its gather variant up to 8 rows)
    by_rows = {}
    for rows, n in ((4, n_fc * n_layers * (steps - pre)),
                    (4 * chunk, n_fc * n_layers * pre)):
        kern = _fc_variant(fc_kernel, rows)
        by_rows.setdefault(kern, {})
        by_rows[kern][rows] = by_rows[kern].get(rows, 0) + n
    want = dict.fromkeys(fns, 0)
    want.update({k: sum(v.values()) for k, v in by_rows.items()})
    if sess.alloc is not None:        # paged: K3 / K2 once a layer and step
        want.update({"paged_attention_chunk": n_layers * pre,
                     "paged_attention_decode": n_layers * (steps - pre)})
    log(f"{label}: launches {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    log(f"{label}: tokens " + json.dumps({r.rid: r.tokens for r in res}))
    if len(res) != 4 or any(len(r.tokens) != 16 for r in res):
        raise AssertionError(f"{label} did not finish 4/4 requests")
    if counts != want:
        raise AssertionError(f"{label} did not go through the kernels on "
                             "every projection and layer")
    if sess.stats["nonfinite_logit_rows"]:
        raise AssertionError(f"{label}: non-finite logits were emitted")
    if sess.alloc is not None and sess.alloc.in_use:
        raise AssertionError(f"{label}: {sess.alloc.in_use} pages leaked")
    return res, sess, counts, by_rows


def _fc_per_layer(eng):
    """The compressed projections of one layer (7 in a gated dense layer,
    4 in a MoE layer, whose expert stacks stay uncompressed)."""
    from repro_torch.core.sparse_fc import CompressedFC

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return int(isinstance(tree, CompressedFC))
    return count(eng.params["layers"])


def _fc_variant(fc_kernel, rows):
    """The kernel an FC call of `rows` x columns launches: K1 ("acsr_spmv")
    takes its gather variant up to GATHER_COLS columns, its wide one
    beyond."""
    return _k1_variant(rows) if fc_kernel == "acsr_spmv" else fc_kernel


def _near_tie_flips(ref, margins, got, what):
    """Greedy streams agree, or first differ where the reference's top-2
    logit margin is below 1e-2 (a near-tie rounding may flip); returns the
    number of such flips."""
    flips = 0
    for r, g in zip(ref, got):
        for j, (a, b) in enumerate(zip(r.tokens, g.tokens)):
            if a != b:
                if margins[r.rid][j] >= 1e-2:
                    raise AssertionError(
                        f"{what}: rid {r.rid} token {j} differs at top-2 "
                        f"margin {margins[r.rid][j]:.3g}")
                flips += 1
                break
    return flips


def _drift_flips(ref, ref_sess, got, got_sess, what):
    """Greedy streams of two attention routes whose arithmetic differs in
    more than sum order (the dense cache's softmax rounds p to bf16, as
    the JAX package's does; K2 keeps p in f32): they agree, or first
    differ at a token whose top-2 margin in ``ref`` is below 1e-2 or below
    twice the gap between the two serves' logits rows there (drawn from
    the same prefix), so that the measured drift alone can swap the top
    two.  Returns (flips, the largest margin a flip had)."""
    import numpy as np
    flips, worst = 0, 0.0
    by_rid = {g.rid: g for g in got}
    for r in ref:
        g = by_rid[r.rid]
        j = next((j for j, (a, b) in enumerate(zip(r.tokens, g.tokens))
                  if a != b), None)
        if j is None:
            continue
        margin = ref_sess.margins[r.rid][j]
        gap = float(np.abs(ref_sess.emitted[r.rid][j]
                           - got_sess.emitted[r.rid][j]).max())
        if margin >= 1e-2 and margin > 2 * gap:
            raise AssertionError(f"{what}: rid {r.rid} token {j} differs at "
                                 f"top-2 margin {margin:.3g}, over twice "
                                 f"the logits gap {gap:.3g} there")
        flips += 1
        worst = max(worst, margin)
    return flips, worst


def _flips_text(flips, worst):
    return "identical" if not flips else \
        f"{flips} flips (largest margin {worst:.4g})"


def _logit_drift(ref, ref_sess, got, got_sess):
    """Max abs gap between two serves' logits rows, over each request's
    tokens up to its first differing one (drawn from the same prefix)."""
    import numpy as np
    worst = 0.0
    by_rid = {g.rid: g for g in got}
    for r in ref:
        g = by_rid[r.rid]
        n = next((j for j, (a, b) in enumerate(zip(r.tokens, g.tokens))
                  if a != b), len(r.tokens) - 1)
        for j in range(n + 1):
            worst = max(worst, float(np.abs(
                ref_sess.emitted[r.rid][j] - got_sess.emitted[r.rid][j]).max()))
    return worst


def _row_count_probe(dev, eng):
    """Which ops of a step give a row other bits among 32 rows (a chunk-8
    step of 4 slots) than among 4 (a decode step), on the served weights:
    each op's max abs gap between the two, per op."""
    import torch
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    p = eng.params
    lay = tfm.layer_view(p["layers"], 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((32, eng.cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    ops = {"rms_norm": lambda t: L.rms_norm(t, p["final_norm"]),
           "K1 wq": lambda t: L.dense(t, lay["attn"]["wq"],
                                      lay["attn"].get("bq"))}
    if "mlp" in lay:
        ops[f"K1 mlp (gate {eng.cfg.act} * up, down)"] = lambda t: L.mlp(
            t, lay["mlp"], eng.cfg.act)
    if eng.cfg.tie_embeddings:
        ops["tied lm_head (_bf16_matmul, f32 cuBLAS)"] = lambda t: \
            L.unembed(t, p["embed"])
    else:
        ops["lm_head (_bf16_matmul, f32 cuBLAS)"] = lambda t: \
            L._bf16_matmul(t, p["lm_head"])
    gaps = {}
    for name, op in ops.items():
        whole = op(x).float()
        fours = torch.cat([op(x[i:i + 4]) for i in range(0, 32, 4)]).float()
        gaps[name] = float((whole - fours).abs().max())
    # attention: a chunk of 8 queries (K3) against each query decoded alone
    # at its position (K2), over one pool
    q, pool, table, q_pos = _k3_inputs(dev, gen, 37, "bf16", 8)
    scale = eng.cfg.head_dim ** -0.5
    chunk = paged_attention_chunk(q, pool, table, q_pos, -1, scale=scale)
    gaps["K3 chunk of 8 vs K2 a query"] = max(float((paged_attention(
        q[:3, :, i].contiguous(), pool, table[:3].contiguous(),
        q_pos[:3, i].contiguous(), -1, scale=scale)
        - chunk[:3, :, i]).abs().max()) for i in range(8))
    return gaps


def serve_phase(dev, layers):
    """The slice's main path: the aida engine serves the four requests at
    chunk 1, then at chunk 8 (K3 on the chunked steps, K2 on the decode
    steps); the chunk-8 tokens must equal the chunk-1 ones up to near-tie
    flips.  K1 gives a column the same bits at every width, so what still
    parts the two serves' logits is logged: their drift, and which ops
    give a row other bits among 32 rows than among 4.  Returns the chunk-8
    serve's launch counts, K1's launches by variant and column count, and
    the engine (the traffic phase serves on it) and the chunk-1 serve's
    results and session (the full-cache phase is held against them)."""
    from repro_torch import CompressionSpec, Request
    cfg = _llama(layers)
    eng = _compressed_engine(dev, cfg, CompressionSpec(mode="aida",
                                                       density=0.25),
                             "serve aida")
    for chunk in (1, 8):                  # library load, cuBLAS handles
        warm = eng.session(batch_slots=4, max_len=256,
                           scheduler={"chunk": chunk})
        warm.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
        warm.run()
    ref, sess1, _, _ = _serve(dev, eng, "serve aida chunk 1", "acsr_spmv",
                              1)
    got, sess8, counts, by_rows = _serve(dev, eng, "serve aida chunk 8",
                                         "acsr_spmv", 8)
    drift = _logit_drift(ref, sess1, got, sess8)
    flips = _near_tie_flips(ref, sess1.margins, got, "chunk 8 vs chunk 1")
    log(f"serve: chunk-8 vs chunk-1 greedy tokens: "
        f"{'identical' if not flips else f'{flips} near-tie flips'}; "
        f"logits max abs drift {drift:.6g} over the shared prefixes")
    gaps = _row_count_probe(dev, eng)
    log("serve: ops' max abs gap, a row among 32 rows vs among 4: "
        + json.dumps(gaps))
    if gaps["K3 chunk of 8 vs K2 a query"] != 0.0:
        raise AssertionError("serve: a query of a K3 chunk differs from K2 "
                             "on it alone")
    del sess8
    trace_serve(eng, 1)
    trace_serve(eng, 8)
    return counts, by_rows, eng, (ref, sess1)


def full_cache_phase(dev, eng, paged):
    """Phase 9's engine serves the four requests from the full cache
    (``kv_cache="full"``; chunk 8 asked, chunk 1 served): K1 as often as
    the projections, layers and steps say and no paged-attention launch
    (the dense cache's attention is plain ops, as in the JAX package);
    tokens equal to the paged chunk-1 serve's up to flips that the two
    routes' logits gap explains (``_drift_flips``), the drift logged.
    Returns the launch counts."""
    ref, sess1 = paged
    got, sess, counts, _ = _serve(dev, eng, "serve aida full cache",
                                  "acsr_spmv", 8, kv_cache="full")
    flips, worst = _drift_flips(ref, sess1, got, sess,
                                "full cache vs paged")
    log(f"serve full cache: vs the paged chunk-1 serve, greedy tokens "
        f"{_flips_text(flips, worst)}; logits "
        f"max abs drift {_logit_drift(ref, sess1, got, sess):.6g} over the "
        f"shared prefixes; stats chunk {sess.stats['chunk']}")
    trace_serve(eng, 1, n_req=1, label="full cache", kv_cache="full")
    return counts


# -------------------------------------------------------- serve traffic
TRAFFIC_REQUESTS = {"heterogeneous": 10, "shared-prefix": 8}
#: record fields set by the scheduling clock alone, equal on the card and
#: on the CPU whatever the model's width: they follow lengths and arrivals
SCHED_FIELDS = ("rid", "prompt_len", "max_new", "submit_step", "admit_step",
                "first_token_step", "n_generated", "preemptions",
                "prefix_pages", "state")
SCHED_STATS = ("steps", "prefill_steps", "fills", "preemptions",
               "page_allocs", "pages_peak", "prefix_hits",
               "prefix_pages_reused")


def _traffic_session(eng, scheduler, obs=None, seed=0):
    return eng.session(batch_slots=4, max_len=256, page_size=16, seed=seed,
                       scheduler=scheduler, obs=obs)


def _run_counted(dev, eng, arrivals, scheduler, label, obs=None):
    """``run_workload`` on the card with every launch count set to 0 just
    before and read just after: every request completes, no page leaks
    (the prefix cache's own pins aside), and the launches are exact — 7
    K1 a layer and step (its gather variant on a decode step's 4 columns,
    the wide one on a chunked step's 32), one K3 a layer and chunked step,
    one K2 a layer and decode step."""
    import torch
    sess = _traffic_session(eng, scheduler, obs)
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sess.run_workload(arrivals)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    n_layers, n_fc = eng.cfg.n_layers, _fc_per_layer(eng)
    pre = sess.stats["prefill_steps"]
    dec = sess.stats["steps"] - pre
    want = dict.fromkeys(fns, 0)
    want.update({"acsr_spmv_gather": n_fc * n_layers * dec,
                 "acsr_spmv_wide": n_fc * n_layers * pre,
                 "paged_attention_decode": n_layers * dec,
                 "paged_attention_chunk": n_layers * pre})
    if counts != want:
        raise AssertionError(f"{label}: launches {json.dumps(counts)}, "
                             f"expected {json.dumps(want)}")
    if len(res) != len(arrivals) or any(
            r["state"] != "completed" for r in sess.records):
        raise AssertionError(f"{label}: {len(res)}/{len(arrivals)} "
                             "requests completed")
    cached = sess.prefix.pages if sess.prefix is not None else 0
    if sess.alloc.in_use != cached:
        raise AssertionError(f"{label}: {sess.alloc.in_use - cached} pages "
                             "leaked")
    if sess.stats["nonfinite_logit_rows"]:
        raise AssertionError(f"{label}: non-finite logits were emitted")
    return res, sess, dt


def _sched_equal(card, cpu, label):
    """The scheduling-clock fields of every record and the stats counters
    of a card run equal those of the reduced CPU run."""
    view = [[{k: r[k] for k in SCHED_FIELDS} for r in s.records]
            for s in (card, cpu)]
    if view[0] != view[1]:
        raise AssertionError(f"{label}: records differ from the CPU run's: "
                             f"{json.dumps(view)}")
    stats = [{k: s.stats[k] for k in SCHED_STATS} for s in (card, cpu)]
    if stats[0] != stats[1]:
        raise AssertionError(f"{label}: stats {json.dumps(stats[0])} vs the "
                             f"CPU run's {json.dumps(stats[1])}")
    return stats[0]


def _attached_page_bytes(eng, arrivals):
    """Serve request 0 alone, then request 1 alone with the prefix cache
    on; the page request 1 attaches must equal, bit for bit, the page it
    writes when served alone with the cache off.  Returns the first
    (layer, k / v) where they part, or None."""
    import torch
    from repro_torch.sched import page_hashes
    r0, r1 = arrivals[0][1], arrivals[1][1]
    cached = _traffic_session(eng, {"chunk": 8, "prefix_cache": True})
    cached.run_workload([(0, r0)])
    cached.run_workload([(0, r1)])
    if cached.stats["prefix_pages_reused"] != 1:
        raise AssertionError("attached page: request 1 attached "
                             f"{cached.stats['prefix_pages_reused']} pages")
    shared = cached.prefix.peek(page_hashes(r1.prompt, 16)[0])
    alone = _traffic_session(eng, {"chunk": 8})
    written = []
    release = alone._release_slot_pages

    def snap(i):                          # the page it wrote, on release
        if alone.host_table[i][0] >= 0:
            written.append(int(alone.host_table[i][0]))
        release(i)
    alone._release_slot_pages = snap
    alone.run_workload([(0, r1)])
    kv_a, kv_b = cached.state["layers"]["kv"], alone.state["layers"]["kv"]
    for layer in range(eng.cfg.n_layers):
        for name in ("k_pages", "v_pages"):
            a = getattr(kv_a, name)[layer, shared]
            b = getattr(kv_b, name)[layer, written[0]]
            if not torch.equal(a, b):
                return layer, name, float((a.float() - b.float()).abs().max())
    return None


LAUNCH = ("--arch", "qwen1.5-0.5b", "--full-size", "--compress", "aida",
          "--density", "0.25", "--workload", "shared-prefix",
          "--prefix-cache", "--policy", "sjf", "--chunk", "8")


def _launch_serve(out):
    """``python -m repro_torch.launch.serve`` as a user runs it (qwen1.5-0.5b
    at full size, aida 0.25, shared-prefix traffic, sjf, the prefix cache,
    chunk 8, traced and reported into ``out``); its lines are logged and its
    ``--json`` dump returned.  Raises unless it exits 0."""
    import os
    files = {k: str(out / f"{k}.json") for k in ("trace", "report", "json")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
         "--trace", files["trace"], "--report", files["report"], "--json",
         files["json"]],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(f"launcher: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"launcher exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return json.loads(pathlib.Path(files["json"]).read_text())


def traffic_phase(dev, eng):
    """Timed traffic on the aida engine of phase 9 (llama3-8b, full width):
    the heterogeneous workload (fifo), shared-prefix twice (sjf with the
    prefix cache, then fifo without it, on the same arrivals), the bytes of
    an attached page, seeded sampling, the tick-clock trace, each run's
    scheduling clock against a reduced llama3-8b's on the CPU, and the
    launcher as a subprocess (qwen1.5-0.5b, full size)."""
    import tempfile

    from repro_torch import Engine, Request, get, reduced
    from repro_torch.obs import Tracer, analyze
    from repro_torch.sched import WorkloadSpec, generate, summarize
    cfg = eng.cfg
    # the CPU twin: the same slots, max_len, page size, pool and chunk at a
    # reduced width (the scheduling clock follows lengths and arrivals)
    cpu = Engine(reduced(get("llama3-8b"), vocab=cfg.vocab), device="cpu")
    fifo8 = {"chunk": 8, "policy": "fifo"}
    # the CPU run takes the very arrivals list: generate() draws token
    # values between lengths, so a spec at another vocabulary need not
    # give the same lengths
    het = generate(WorkloadSpec.preset(
        "heterogeneous", n_requests=TRAFFIC_REQUESTS["heterogeneous"],
        vocab=cfg.vocab, seed=0))
    _, sess, dt = _run_counted(dev, eng, het, fifo8, "traffic heterogeneous")
    ref = _traffic_session(cpu, fifo8)
    ref.run_workload(het)
    stats = _sched_equal(sess, ref, "traffic heterogeneous")
    m = summarize(sess.records, dt, sess.stats["steps"])
    log(f"traffic heterogeneous ({len(het)} requests, fifo, chunk 8): "
        f"{m['tokens']} tokens in {dt:.2f} s, {m['tok_per_s']} tok/s, TTFT "
        f"p50 {m['ttft_s']['p50'] * 1e3:.1f} / p99 "
        f"{m['ttft_s']['p99'] * 1e3:.1f} ms, {m['ttft_sched']['p50']} / "
        f"{m['ttft_sched']['p99']} steps; TPOT p50 "
        f"{m['tpot_s']['p50'] * 1e3:.1f} ms; {stats['steps']} steps "
        f"({stats['prefill_steps']} chunked), "
        f"{stats['preemptions']} preemptions; records and stats = the CPU "
        "run's")
    sp = generate(WorkloadSpec.preset(
        "shared-prefix", n_requests=TRAFFIC_REQUESTS["shared-prefix"],
        vocab=cfg.vocab, seed=0))
    sjf = {"chunk": 8, "policy": "sjf", "prefix_cache": True}
    got, cached, dt = _run_counted(dev, eng, sp, sjf, "traffic shared-prefix")
    ref = _traffic_session(cpu, sjf)
    ref.run_workload(sp)
    stats = _sched_equal(cached, ref, "traffic shared-prefix")
    if not (stats["prefix_pages_reused"] > 0 and stats["prefix_hits"] > 0):
        raise AssertionError("traffic shared-prefix: the cache was never hit")
    cached.prefix.clear(cached.alloc)
    if cached.alloc.in_use:
        raise AssertionError("traffic shared-prefix: pages held after the "
                             "cache was cleared")
    base, plain, _ = _run_counted(dev, eng, sp, fifo8,
                                  "traffic shared-prefix, no cache")
    flips = _near_tie_flips(base, plain.margins, got,
                            "shared-prefix with the cache vs without")
    m = summarize(cached.records, dt, cached.stats["steps"])
    log(f"traffic shared-prefix ({len(sp)} requests, sjf + prefix cache): "
        f"{stats['prefix_hits']} hits, {stats['prefix_pages_reused']} pages "
        f"reused (= the CPU run's), {stats['steps']} steps against "
        f"{plain.stats['steps']} without the cache, {m['tok_per_s']} tok/s; "
        "tokens vs no cache: "
        f"{'identical' if not flips else f'{flips} near-tie flips'}")
    parted = _attached_page_bytes(eng, sp)
    if parted is not None:
        raise AssertionError(
            "attached page: differs from the page written alone at layer "
            f"{parted[0]} {parted[1]} (max abs {parted[2]:.3g})")
    log("traffic: the attached prefix page equals the page request 1 "
        "writes alone, bit for bit, in all layers")
    draws = []
    for _ in range(2):
        s = _traffic_session(eng, {"chunk": 8}, seed=0)
        s.submit(Request(prompt=sp[0][1].prompt, max_new=16,
                         temperature=0.8, rid=0))
        draws.append(s.run()[0].tokens)
    if draws[0] != draws[1] or not all(0 <= t < cfg.vocab
                                       for t in draws[0]):
        raise AssertionError(f"sampling: seeded draws {draws}")
    log(f"traffic sampling (T 0.8, seed 0): {draws[0]} twice")
    traces = []
    for e, where in ((eng, "card"), (cpu, "CPU")):
        tr = Tracer()
        s = _traffic_session(e, fifo8, obs=tr)
        s.run_workload(het)
        if not analyze(tr).segments_consistent():
            raise AssertionError(f"trace ({where}): segments inconsistent")
        traces.append(tr.to_chrome())
    if traces[0] != traces[1]:
        raise AssertionError("trace: the card's tick-clock trace differs "
                             "from the CPU run's")
    log(f"traffic trace: {len(traces[0]['traceEvents'])} events, equal to "
        "the CPU run's event for event; segments consistent")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="traffic_") as out:
        dump = _launch_serve(pathlib.Path(out))
    mm, prov = dump["metrics"], dump["provenance"]
    if mm["completed"] != mm["requests"] or dump["pages"]["leaked"]:
        raise AssertionError(f"launcher: {mm['completed']}/"
                             f"{mm['requests']} requests, "
                             f"{dump['pages']['leaked']} pages leaked")
    if not prov.get("card") or "W" not in prov["card"]:
        raise AssertionError(f"launcher: provenance names no card: {prov}")
    log(f"launcher: exit 0 in {time.perf_counter() - t0:.1f} s, "
        f"{mm['completed']}/{mm['requests']} requests, 0 leaked, card "
        f"{prov['card']!r}")


# ------------------------------------------------- disaggregated serving
DISAGG = {"prefill_slots": 2, "decode_slots": 4}
DISAGG_REQUESTS = 8
DISAGG_FAULTS = ("drop-handoff:1", "page-spike:0")
#: the fault runs' resilience knobs (the launcher's --deadline-ticks and
#: --max-retries) and a decode pool of 8 usable pages, so that a page
#: spike's holdback (60 %) stalls handoffs
DISAGG_RESIL = {"deadline_ticks": 64, "max_retries": 2, "watchdog_every": 8}
DISAGG_FAULT_POOL = 9
#: record fields of a disaggregated run set by the scheduling clock alone
#: (bytes follow the model's width, so a reduced twin's differ)
DISAGG_FIELDS = SCHED_FIELDS + ("submit_tick", "first_token_tick",
                                "prefill_done_tick", "handoff_ticks",
                                "migrated_pages", "failed_reason", "retries")
DISAGG_LAUNCH = ("--arch", "qwen1.5-0.5b", "--full-size", "--compress",
                 "aida", "--density", "0.25", "--disagg", "--prefill-slots",
                 "2", "--decode-slots", "4", "--fault-plan", "drop-handoff:3",
                 "--deadline-ticks", "64", "--max-retries", "2", "--chunk",
                 "8")


def _keep_rows(*sessions):
    """Wrap each session's ``_emit`` to keep the logits row each token was
    drawn from, by rid in emission order (a disaggregated request's first
    row from its prefill role, the rest from its decode role)."""
    rows = {}
    for sess in sessions:
        def keep(i, logits_i, now, sess=sess, emit=sess._emit):
            rows.setdefault(sess.slot_entry[i].req.rid, []).append(
                logits_i.copy())
            emit(i, logits_i, now)
        sess._emit = keep
    return rows


def _disagg_counted(dev, eng, arrivals, label, disagg=DISAGG, **kw):
    """A disaggregated ``run_workload`` on the card, every launch count set
    to 0 just before and read just after: exact launches from each role's
    steps (the prefill role's chunked steps: K1 at 2 x 8 columns and K3;
    a decode step of either role: K1 at its slots' columns and K2), both
    pools drained, the audits clean, finite logits.  Returns (results,
    session, its logits rows, seconds, launch counts)."""
    import torch
    from repro_torch import resil
    sess = eng.session(max_len=256, page_size=16, disagg=disagg,
                       scheduler={"chunk": 8, "policy": "fifo"}, **kw)
    rows = _keep_rows(sess.pre, sess.dec)
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sess.run_workload(arrivals, on_incomplete="warn"
                            if sess.resil is not None else "raise")
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    n_layers, n_fc = eng.cfg.n_layers, _fc_per_layer(eng)
    want = dict.fromkeys(fns, 0)
    for role in (sess.pre, sess.dec):
        pre = role.stats["prefill_steps"]
        dec = role.stats["steps"] - pre
        for kern, n in ((_k1_variant(role.slots), n_fc * n_layers * dec),
                        (_k1_variant(role.slots * role.chunk),
                         n_fc * n_layers * pre)):
            want[kern] += n
        want["paged_attention_decode"] += n_layers * dec
        want["paged_attention_chunk"] += n_layers * pre
    if counts != want:
        raise AssertionError(f"{label}: launches {json.dumps(counts)}, "
                             f"expected {json.dumps(want)}")
    if len(res) + len(sess.failed) != len(arrivals):
        raise AssertionError(f"{label}: {len(res)} served and "
                             f"{len(sess.failed)} failed of {len(arrivals)}")
    left = sess.pre.alloc.in_use + sess.dec.alloc.in_use
    audits = resil.audit_session(sess.pre) + resil.audit_session(sess.dec)
    if left or audits or sess.dec.stats["preemptions"]:
        raise AssertionError(f"{label}: {left} pages leaked, audits "
                             f"{audits}, {sess.dec.stats['preemptions']} "
                             "decode preemptions")
    if sess.pre.stats["nonfinite_logit_rows"] or \
            sess.dec.stats["nonfinite_logit_rows"]:
        raise AssertionError(f"{label}: non-finite logits were emitted")
    return res, sess, rows, dt, counts


def _disagg_view(sess):
    """The scheduling-clock view of a disaggregated run: every record's
    tick and step fields, both roles' stats, role_stats, the router's
    counters and the resilience summary (byte counts left out)."""
    def clock(stats):
        return {k: v for k, v in stats.items() if k != "migrated_bytes"}
    return {"records": [{k: r.get(k) for k in DISAGG_FIELDS}
                        for r in sess.records],
            "stats": clock(sess.stats), "roles": sess.role_stats(),
            "pre": clock(sess.pre.stats), "dec": clock(sess.dec.stats),
            "router": sess.router.stats, "resil": sess.resil_summary(),
            "failed": [repr(f) for f in sess.failed]}


def _int8_migration(eng, arrivals):
    """Two requests through int8 pools: every page the decode role admits
    must equal, codes and scales, the prefill page it came from
    (``torch.equal``).  Returns the pages compared."""
    import dataclasses

    import torch
    sess = eng.session(max_len=256, page_size=16, disagg=DISAGG,
                       kv_dtype="int8", scheduler={"chunk": 8})
    admit, seen = sess.dec.admit_handoff, []

    def check(i, h, src_state, **kw):
        moved = admit(i, h, src_state, **kw)
        src, dst = src_state["layers"]["kv"], sess.dec.state["layers"]["kv"]
        for j, pid in h.live():
            for name in src._fields:
                a = getattr(src, name)[:, pid]
                b = getattr(dst, name)[:, int(sess.dec.host_table[i, j])]
                if not torch.equal(a, b):
                    raise AssertionError(f"int8 migration: page {pid} "
                                         f"{name} differs after the copy")
            seen.append(pid)
        return moved
    sess.dec.admit_handoff = check
    for _, r in arrivals[:2]:
        sess.submit(dataclasses.replace(r, max_new=4))
    res = sess.run()
    if not sess.dec.state["layers"]["kv"].quantized or len(res) != 2 \
            or not seen:
        raise AssertionError("int8 migration: no int8 page was migrated")
    return len(seen)


def _launch_disagg(out):
    """``python -m repro_torch.launch.serve --disagg --fault-plan
    drop-handoff:3`` (qwen1.5-0.5b, full size, aida 0.25) as a user runs
    it; its lines are logged and its ``--json`` dump returned."""
    import os
    path = out / "disagg.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *DISAGG_LAUNCH,
         "--json", str(path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(f"launcher disagg: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"launcher --disagg exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return json.loads(path.read_text())


def _ms(dist):
    return "-" if not dist else \
        f"{dist['p50'] * 1e3:.1f} / {dist['p99'] * 1e3:.1f}"


def disagg_phase(dev, eng):
    """Disaggregated serving on the aida engine of phase 9 (llama3-8b, full
    width, chunk 8): the burst workload co-located (4 slots) and
    disaggregated (2 prefill + 4 decode slots, one card, one set of
    weights), tokens held by the drift rule, exact launches, pages and
    bytes migrated, TTFT / TPOT, no leaked page, the scheduling clock equal
    to a reduced llama3-8b's on the CPU; an int8 migration bit for bit;
    two fault plans each run twice to identical records and summaries;
    and the launcher with ``--disagg --fault-plan``.  Returns the K1-K3
    launches of the disaggregated run and the columns of its wide K1
    launches (the prefill role's chunked steps)."""
    import tempfile

    import torch
    from repro_torch import Engine, get, reduced
    from repro_torch.sched import WorkloadSpec, generate, summarize
    cfg = eng.cfg
    cpu = Engine(reduced(get("llama3-8b"), vocab=cfg.vocab), device="cpu")
    arrivals = generate(WorkloadSpec.preset(
        "burst", n_requests=DISAGG_REQUESTS, vocab=cfg.vocab, seed=0))
    fifo8 = {"chunk": 8, "policy": "fifo"}
    co = _traffic_session(eng, fifo8)
    co_rows = _keep_rows(co)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    co_res = co.run_workload(arrivals)
    torch.cuda.synchronize(dev)
    co_dt = time.perf_counter() - t0
    res, d, rows, dt, counts = _disagg_counted(dev, eng, arrivals,
                                               "disagg burst")
    flips, worst = _drift_flips(
        co_res, types.SimpleNamespace(margins=co.margins, emitted=co_rows),
        res, types.SimpleNamespace(margins=d.margins, emitted=rows),
        "disagg vs co-located")
    twin = cpu.session(max_len=256, page_size=16, disagg=DISAGG,
                       scheduler=fifo8)
    twin.run_workload(arrivals)
    if _disagg_view(d) != _disagg_view(twin):
        raise AssertionError("disagg burst: the scheduling clock differs "
                             "from the CPU run's: " + json.dumps(
                                 [_disagg_view(d), _disagg_view(twin)]))
    m_co = summarize(co.records, co_dt, co.stats["steps"])
    m = summarize(d.records, dt, d.pre.stats["steps"] + d.dec.stats["steps"],
                  roles=d.role_stats())
    hand = m["handoff"]
    log(f"disagg burst ({len(arrivals)} requests, chunk 8): co-located "
        f"{co.stats['steps']} steps in {co_dt:.2f} s, TTFT p50 / p99 "
        f"{_ms(m_co['ttft_s'])} ms, TPOT {_ms(m_co['tpot_s'])} ms; "
        f"disaggregated {d.ticks} ticks (prefill {d.pre.stats['steps']} "
        f"steps, decode {d.dec.stats['steps']}) in {dt:.2f} s, TTFT "
        f"{_ms(m['ttft_s'])} ms ({m['ttft_sched']['p50']} / "
        f"{m['ttft_sched']['p99']} ticks against "
        f"{m_co['ttft_sched']['p50']} / {m_co['ttft_sched']['p99']} steps), "
        f"TPOT {_ms(m['tpot_s'])} ms; {hand['count']} handoffs, "
        f"{hand['migrated_pages']} pages, {hand['migrated_bytes']} bytes "
        f"migrated, handoff latency p50 / p99 {_ms(hand['latency_s'])} ms; "
        f"0 leaked; tokens vs co-located: {_flips_text(flips, worst)}; "
        f"scheduling clock = the CPU run's")
    log(f"disagg burst: launches {json.dumps(counts)}")
    n = _int8_migration(eng, arrivals)
    log(f"disagg int8: {n} migrated pages equal their prefill pages, codes "
        "and scales, bit for bit")
    for plan in DISAGG_FAULTS:
        resil = dict(DISAGG_RESIL, fault_plan=plan)
        views, toks = [], []
        for _ in range(2):
            res_f, df, rows_f, dt_f, _ = _disagg_counted(
                dev, eng, arrivals, f"disagg {plan}", resil=resil,
                disagg=dict(DISAGG, decode_pool_pages=DISAGG_FAULT_POOL))
            views.append(_disagg_view(df))
            toks.append([(r.rid, r.tokens) for r in res_f])
        if views[0] != views[1] or toks[0] != toks[1]:
            raise AssertionError(f"disagg {plan}: the replay differs")
        flips, worst = _drift_flips(
            [r for r in co_res if r.rid in {rid for rid, _ in toks[0]}],
            types.SimpleNamespace(margins=co.margins, emitted=co_rows),
            res_f, types.SimpleNamespace(margins=df.margins, emitted=rows_f),
            f"disagg {plan} vs co-located")
        s = views[0]["resil"]
        log(f"disagg {plan}: {len(res_f)} served, {len(df.failed)} failed "
            f"{views[0]['failed']}, {df.ticks} ticks in {dt_f:.2f} s, "
            f"faults {json.dumps(s['faults'])}, wait ticks "
            f"{s['wait_ticks']}, deadline misses {s['deadline_miss']}; "
            f"replay identical; tokens vs co-located: "
            f"{_flips_text(flips, worst)}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="disagg_") as out:
        dump = _launch_disagg(pathlib.Path(out))
    mm = dump["metrics"]
    failed = len(dump["failed"])
    if mm["completed"] + failed != mm["requests"] or dump["pages"]["leaked"] \
            or mm["resil"]["fault_plan"] != "drop-handoff:3" \
            or not mm["handoff"]["migrated_bytes"] \
            or "W" not in (dump["provenance"].get("card") or ""):
        raise AssertionError(f"launcher --disagg: {json.dumps(dump)}")
    log(f"launcher disagg: exit 0 in {time.perf_counter() - t0:.1f} s, "
        f"{mm['completed']}/{mm['requests']} served, {failed} failed, "
        f"faults {json.dumps(mm['resil']['faults'])}, roles "
        f"{json.dumps(mm['roles'])}, 0 leaked")
    wide = d.pre.slots * d.pre.chunk
    if wide not in K1_TIMED:
        raise AssertionError(f"disagg: K1 runs at {wide} columns, which "
                             "K1_TIMED does not time")
    return counts, wide


# the int8 / codebook4 serves' depth (of llama3-8b's 32): cut so that the
# run stays well inside its time limit on a loaded host; their K4 / K5
# launches and times are per layer
FC_MODE_LAYERS = 8


def fc_mode_serves(dev, layers):
    """Fresh int8 and codebook4 engines at full width serve the four
    requests at chunk 8 through K4 / K5, then a short traced serve each.
    Returns each one's FC kernel launches by kernel and rows."""
    import gc

    import torch
    from repro_torch import CompressionSpec
    cfg = _llama(layers)
    counts = {}
    for mode, kern in (("int8", "int8_matmul"), ("codebook4", "lut_matmul")):
        gc.collect()
        torch.cuda.empty_cache()
        eng = _compressed_engine(dev, cfg, CompressionSpec(mode=mode),
                                 f"serve {mode}")
        counts.update(_serve(dev, eng, f"serve {mode} chunk 8", kern, 8)[3])
        trace_serve(eng, 8, label=mode)
        del eng
    return counts


def trace_serve(eng, chunk, n_req=4, label="", kv_cache=None):
    """Device busy share and kernel time by family over a short serve of
    the first ``n_req`` of the same requests (4 new tokens each), from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sess = eng.session(batch_slots=4, max_len=256, kv_cache=kv_cache,
                       scheduler={"chunk": chunk})
    for r in _requests(eng.cfg, max_new=4)[:n_req]:
        sess.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("trace: the profiler saw no device events (not measured)")
        return
    fam = {"acsr_spmv": 0.0, "paged_attention": 0.0, "fc": 0.0,
           "other": 0.0}
    for e in kernels:     # K4 / K5 live in namespace fc (csrc/fc_tile.cuh)
        key = "acsr_spmv" if "spmv" in e.name else \
            "paged_attention" if "paged_" in e.name else \
            "fc" if "fc::" in e.name else "other"
        fam[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(fam.values())
    steps = sess.stats["steps"]
    log(f"trace {label + ' ' if label else ''}chunk {chunk}: {steps} "
        f"steps, wall {wall * 1e3 / steps:.2f} ms/step, "
        f"device busy {busy / steps:.3f} ms/step "
        f"({100 * busy / (wall * 1e3):.1f}% of wall), kernels "
        f"{len(kernels) / steps:.0f}/step; ms/step by family: " +
        ", ".join(f"{k} {v / steps:.3f}" for k, v in fam.items()))


# --------------------------------------------------------------- train
TRAIN_LAYERS = 4      # of llama3-8b's 32: f32 params, grads and moments
TRAIN_STEPS = 4       # take 16 B a parameter


def _train_config():
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig
    # no warmup, so that 4 steps move the loss.  At d_model 4096 AdamW's
    # first step moves every weight by about lr: from 12.09, lr 1e-4 and
    # 3e-4 overshoot (16.1 and 17.6 at step 1), 2e-5 falls every step
    return TrainConfig(attn_impl="flash", remat="dots",
                       opt=AdamWConfig(lr=2e-5, warmup_steps=1))


def train_phase(dev, layers):
    """The training path at llama3-8b's full width: ``trainer.run`` with
    ``attn_impl="flash"`` and ``remat="dots"`` over 2 x 2048-token
    batches, every launch count set to 0 just before and read just after.
    Checks a finite loss that falls, and dq = dkv = layers x steps
    launches, K7 twice that (one microbatch; "dots" keeps the projections'
    outputs and recomputes the rest of each layer, K7 included, in the
    backward).  Then the same steps under "none", for the memory "dots"
    saves and the time it costs.  Returns the launch counts."""
    import gc
    import re

    import torch
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.train import trainer
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _llama(layers)
    tc = _train_config()
    it = DataIterator(cfg, PipelineConfig(seed=0, global_batch=2,
                                          seq_len=2048))
    steps = []

    def record(line):
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"train: {line} peak {peak:.2f} GiB")
        steps.append((float(re.search(r"loss=(\S+)", line).group(1)),
                      float(re.search(r"(\d+)ms$", line).group(1))))

    fns = _launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state = trainer.run(cfg, tc, it, TRAIN_STEPS, log_every=1, log=record,
                        device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    want = dict.fromkeys(fns, 0)
    want.update(dict.fromkeys(FLASH, cfg.n_layers * TRAIN_STEPS))
    want["flash_attention_fwd"] *= 2       # forward, and "dots" recompute
    losses = [loss for loss, _ in steps]
    log(f"train llama3-8b d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"B=2 T=2048: {TRAIN_STEPS} steps in {wall:.2f} s (init included), "
        f"ms/step {[ms for _, ms in steps]}, losses {losses}, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    log(f"train: launches {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    if counts != want:
        raise AssertionError("the training path did not go through K7 / K8 "
                             "as often as its layers, steps and remat say")
    if len(losses) != TRAIN_STEPS or not all(
            x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"train: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall {losses}")
    trace_train(dev, cfg, tc, state, it)
    del state
    _remat_none_run(dev, cfg, steps)
    return counts


def _remat_none_run(dev, cfg, dots_steps):
    """The same steps with ``remat="none"`` (every activation kept): the
    memory "dots" saves and the time its recompute costs, on this card."""
    import dataclasses
    import gc
    import re

    import torch
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.train import trainer
    gc.collect()
    torch.cuda.empty_cache()
    tc = dataclasses.replace(_train_config(), remat="none")
    it = DataIterator(cfg, PipelineConfig(seed=0, global_batch=2,
                                          seq_len=2048))
    lines = []
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.run(cfg, tc, it, TRAIN_STEPS, log_every=1, log=lines.append,
                device=dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms = [float(re.search(r"(\d+)ms$", ln).group(1)) for ln in lines]
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines]
    same = losses == [loss for loss, _ in dots_steps]
    log(f"train remat none (every activation kept): ms/step {ms}, losses "
        f"{losses} ({'equal to' if same else 'unlike'} those of \"dots\"), "
        f"peak {peak:.2f} GiB")


def trace_train(dev, cfg, tc, state, it):
    """Device time by kernel family over one more training step, from
    torch.profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import trainer
    step = trainer.make_train_step(cfg, tc)
    batch = {k: torch.as_tensor(np.asarray(x), device=dev)
             for k, x in next(it).items()}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("trace train: the profiler saw no device events (not measured)")
        return
    fam = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0, "gemm": 0.0,
           "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        key = next((f for f in ("flash_fwd", "flash_dq", "flash_dkv")
                    if f in name), None)
        if key is None:
            key = "gemm" if ("gemm" in name or "sm90" in name
                             or "cutlass" in name) else "other"
        fam[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(fam.values())
    log(f"trace train step: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}% of wall), {len(kernels)} kernels; ms by "
        "family: " + ", ".join(f"{k} {v:.2f}" for k, v in fam.items()))


def train_cross_check(dev):
    """A reduced llama3-8b (D = 32) trained 3 steps through the flash path
    on the card and on the CPU from the same state and batches: per-step
    losses within 1e-2 (both round to bf16 at the same places; the CPU
    port itself is held within 2e-3 of the JAX package)."""
    import torch
    from repro_torch import bridge, get, reduced
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.train import trainer
    cfg = reduced(get("llama3-8b"))
    tc = _train_config()
    init = trainer.init_state(cfg, torch.Generator().manual_seed(0))
    # a copy for the card first: the CPU run then updates ``init`` in place
    states = {"cuda": bridge.to_device(init, dev), "cpu": init}
    losses = {}
    for name, state in states.items():
        lines = []
        trainer.run(cfg, tc, DataIterator(cfg, PipelineConfig(
            seed=1, global_batch=2, seq_len=256)), 3, state=state,
            log_every=1, log=lines.append,
            device=dev if name == "cuda" else "cpu")
        losses[name] = [float(ln.split("loss=")[1].split()[0])
                        for ln in lines]
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    log(f"cross-check: reduced llama3-8b flash training, losses cpu "
        f"{losses['cpu']} cuda {losses['cuda']}, max diff {diff:.2e}")
    if diff > 1e-2:
        raise AssertionError("card and CPU training losses disagree")


def cross_check(dev):
    """A reduced llama3-8b served on the card and on the CPU from the same
    weights gives the same greedy tokens (or differs only at a near-tie):
    aida at chunk 1 and 8, int8 and codebook4 at chunk 8."""
    from repro_torch import CompressionSpec, Engine, Request, bridge, get
    from repro_torch import reduced
    cfg = reduced(get("llama3-8b"))
    for mode, chunk in (("aida", 1), ("aida", 8), ("int8", 8),
                        ("codebook4", 8)):
        cpu = Engine(cfg, device="cpu", seed=0).compress(
            CompressionSpec(mode=mode, density=0.25))
        gpu = Engine(cfg, params=bridge.to_device(cpu.params, dev),
                     device=dev)
        out = {}
        for name, eng in (("cpu", cpu), ("cuda", gpu)):
            sess = eng.session(batch_slots=4, max_len=256,
                               scheduler={"chunk": chunk})
            for i, n in enumerate((5, 9, 16, 23)):
                sess.submit(Request(prompt=[(7 * i + 3 * j) % cfg.vocab
                                            for j in range(n)],
                                    max_new=16, rid=i))
            out[name] = (sess.run(), sess.margins)
        (ref, margins), (got, _) = out["cpu"], out["cuda"]
        flips = _near_tie_flips(ref, margins, got,
                                f"cross-check {mode} chunk {chunk}")
        log(f"cross-check: reduced llama3-8b {mode} chunk {chunk}, cuda vs "
            f"cpu greedy tokens: "
            f"{'identical' if not flips else f'{flips} near-tie flips'}")


# ------------------------------------------------------------ families
# the families served at full width, with their depth cuts (None: all);
# phi-3-vision serves text, as the JAX package serves it
FAMILY_SERVES = (("qwen1.5-0.5b", 8), ("h2o-danube-1.8b", 4),
                 ("gemma2-2b", 4), ("mixtral-8x7b", 2),
                 ("phi-3-vision-4.2b", 4))
# the families trained at full width through K7 / K8: (name, layers,
# tokens a row).  hymba's 2 layers are its global layer 0 and a layer
# windowed at 1024, so 2048 tokens make the window bite; phi-3-vision's
# rows are 576 image rows, then 2048 text tokens; hubert's are frames
FAMILY_TRAINS = (("gemma2-2b", 2, 2048), ("h2o-danube-1.8b", 2, 2048),
                 ("hymba-1.5b", 2, 2048), ("phi-3-vision-4.2b", 2, 2624),
                 ("hubert-xlarge", 4, 2048))
FAMILY_TRAIN_STEPS = 2


def _family(name, layers):
    import dataclasses
    from repro_torch import get
    cfg = get(name)
    if layers is not None and layers != cfg.n_layers:
        log(f"depth cut: {name} {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def serve_families_phase(dev):
    """qwen1.5-0.5b, h2o-danube-1.8b, gemma2-2b and mixtral-8x7b at full
    width (depth cut as FAMILY_SERVES says): ``Engine.compress(aida
    0.25)`` serves the four requests at chunk 1 and at chunk 8, every
    launch counted.  A dense family's chunk-8 tokens must equal its chunk-1
    ones up to near-tie flips.  A MoE layer routes each step's tokens as
    one group whose capacity follows its size (a decode step of 4 tokens:
    capacity 1 an expert; a chunk of 32: 10), so mixtral's two serves may
    drop different tokens and are not compared; its tokens are held
    against the CPU in ``families_cross_check``.  Returns each serve's
    launch counts."""
    import gc

    import torch
    from repro_torch import CompressionSpec, Request
    counts = {}
    for name, layers in FAMILY_SERVES:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = _family(name, layers)
        eng = _compressed_engine(dev, cfg, CompressionSpec(
            mode="aida", density=0.25), f"serve {name}")
        for chunk in (1, 8):              # cuBLAS handles, first launches
            warm = eng.session(batch_slots=4, max_len=256,
                               scheduler={"chunk": chunk})
            warm.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
            warm.run()
        ref, sess1, c1, _ = _serve(dev, eng, f"serve {name} chunk 1",
                                   "acsr_spmv", 1)
        got, sess8, c8, _ = _serve(dev, eng, f"serve {name} chunk 8",
                                   "acsr_spmv", 8)
        counts[name] = {1: c1, 8: c8}
        if cfg.moe is None:
            flips = _near_tie_flips(ref, sess1.margins, got,
                                    f"{name} chunk 8 vs chunk 1")
            log(f"serve {name}: chunk-8 vs chunk-1 greedy tokens: "
                f"{'identical' if not flips else f'{flips} near-tie flips'}; "
                f"logits max abs drift "
                f"{_logit_drift(ref, sess1, got, sess8):.6g}")
            gaps = _row_count_probe(dev, eng)
            log(f"serve {name}: ops' max abs gap, a row among 32 rows vs "
                "among 4: " + json.dumps(gaps))
            if gaps["K3 chunk of 8 vs K2 a query"] != 0.0:
                raise AssertionError(f"serve {name}: a query of a K3 chunk "
                                     "differs from K2 on it alone")
        else:
            m = cfg.moe
            cap = [max(1, int(min(m.group_size, n) * m.top_k
                              * m.capacity_factor / m.n_experts))
                   for n in (4, 32)]
            same = sum(a == b for r, g in zip(ref, got)
                       for a, b in zip(r.tokens, g.tokens))
            log(f"serve {name}: chunk 8 and chunk 1 route other token "
                f"groups (capacity {cap[0]} vs {cap[1]} an expert); {same} "
                f"of {sum(len(r.tokens) for r in ref)} tokens agree")
        del eng, sess1, sess8
    return counts


def train_families_phase(dev):
    """gemma2-2b (head dim 256, attention softcap 50), h2o-danube-1.8b
    (head dim 80), hymba-1.5b (a query group of 5 at D 64, windowed and
    global, beside the mamba heads' plain scan), phi-3-vision-4.2b (D 96,
    H = Hkv, image rows first) and hubert-xlarge (non-causal, D 80) at full
    width, depth cut to FAMILY_TRAINS' layers: ``trainer.run(attn_impl=
    "flash", remat="dots")`` for FAMILY_TRAIN_STEPS steps on 2 rows of
    FAMILY_TRAINS' tokens, every launch count set to 0 just before and
    read just after: finite losses, K7 twice a layer and step, dq = dkv
    once.  Returns K7 / K8's launches by model."""
    import gc

    import torch
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.train import trainer
    by_model = {name: {} for name in FLASH}
    for name, layers, seq_len in FAMILY_TRAINS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = _family(name, layers)
        it = DataIterator(cfg, PipelineConfig(seed=0, global_batch=2,
                                              seq_len=seq_len))
        lines = []
        fns = _launch_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        for f in fns.values():
            f.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer.run(cfg, _train_config(), it, FAMILY_TRAIN_STEPS,
                    log_every=1, log=lines.append, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in fns.items()}
        want = dict.fromkeys(fns, 0)
        want.update(dict.fromkeys(FLASH, cfg.n_layers * FAMILY_TRAIN_STEPS))
        want["flash_attention_fwd"] *= 2   # forward, and "dots" recompute
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines]
        log(f"train {name} d_model {cfg.d_model} head_dim {cfg.head_dim} "
            f"H {cfg.n_heads}/{cfg.n_kv}, {cfg.n_layers} layers "
            f"{cfg.layer_windows()}, B=2 T={seq_len}: {FAMILY_TRAIN_STEPS} "
            f"steps in {wall:.2f} s (init included), lines {lines}, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        log(f"train {name}: launches {json.dumps(counts)} (expected "
            f"{json.dumps(want)})")
        if counts != want:
            raise AssertionError(f"train {name} did not go through K7 / K8 "
                                 "as often as its layers and steps say")
        if len(losses) != FAMILY_TRAIN_STEPS or not all(
                x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"train {name}: non-finite losses {losses}")
        for k in FLASH:
            by_model[k][name] = counts[k]
    return by_model


# ------------------------------------------ checkpoint, restart, data parallel
CKPT_LAYERS = 2       # llama3-8b at full width: 1.49 B params, 12 B each
CKPT_STEPS = 4        # checkpointed at step 2, a fault after step 3
LAUNCH_STEPS = 4      # a checkpoint every 2: killed at step 2's commit
LAUNCH_TRAIN = ("--arch", "qwen1.5-0.5b", "--global-batch", "2", "--seq",
                "2048", "--steps", str(LAUNCH_STEPS), "--ckpt-every", "2",
                "--keep-last", "1", "--log-every", "1")
DP_STEPS = 3          # qwen1.5-0.5b at full depth, 1 x 2048 tokens a rank
DP_SCHEMES = (None, "bf16", "int8")
#: the int8 wire's per-step loss against the uncompressed one's: about six
#: times the 8.7e-4 read on an H100 at this size (a loss of 9.6 to 12.5)
DP_INT8_LOSS_TOL = 5e-3


def _state_bytes(state):
    from repro_torch.checkpoint.ckpt import flatten
    return sum(x.numel() * x.element_size() for x in flatten(state))


def _need_disk(path, nbytes, what):
    """Fail loudly, before any write, when ``path``'s disk cannot hold
    ``nbytes``."""
    import shutil
    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    log(f"{what}: {nbytes / 1e9:.2f} GB needed, {free / 1e9:.2f} GB free "
        f"under {path}")
    if free < nbytes * 1.1:
        raise AssertionError(f"{what}: {free / 1e9:.2f} GB free under "
                             f"{path}, {nbytes / 1e9:.2f} GB needed")


def _flash_counts(fns):
    return {k: fns[k].launches for k in FLASH}


def ckpt_restart_phase(dev):
    """Checkpoint, kill and resume at llama3-8b's full width cut to
    CKPT_LAYERS layers (``_train_config()``: flash, K7 / K8), 2 x 2048
    tokens: CKPT_STEPS uninterrupted steps, then a run checkpointed at
    step 2 that raises after step 3 and is resumed by ``RestartLoop``
    from step 2's checkpoint.  The final params must equal the
    uninterrupted run's (``torch.equal`` per leaf), and the step-2
    checkpoint restored onto the CPU the card's step-2 state copied to
    the host, leaf for leaf.  Returns the K7 / K8 launches."""
    import gc
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.ckpt import flatten, unflatten
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime.fault_tolerance import RestartLoop
    from repro_torch.train import trainer
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _llama(CKPT_LAYERS)
    tc = _train_config()
    pc = PipelineConfig(seed=0, global_batch=2, seq_len=2048)
    root = ROOT / "build" / "ckpt-smoke"
    shutil.rmtree(root, ignore_errors=True)
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    whole = trainer.run(cfg, tc, DataIterator(cfg, pc), CKPT_STEPS,
                        log_every=0, device=dev)
    nbytes = _state_bytes(whole)
    want = [p.to("cpu", copy=True) for p in leaves(whole.params)]
    # the state's structure on the meta device: a template costs nothing
    skel = unflatten(whole, [torch.empty(x.shape, dtype=x.dtype,
                                         device="meta")
                             for x in flatten(whole)])
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    _need_disk(root, 2 * nbytes, "checkpoint phase")
    times = {}

    class Timed(CheckpointManager):
        """Times save and restore; keeps the card's state as saved."""

        def save(self, step, tree, extra=None, blocking=False):
            self.card_copy = [x.to("cpu", copy=True) for x in flatten(tree)]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            super().save(step, tree, extra=extra)
            times["snapshot"] = time.perf_counter() - t0
            self.wait()
            times["save"] = time.perf_counter() - t0

        def restore(self, template, step=None, device=None):
            t0 = time.perf_counter()
            out = super().restore(template, step=step, device=device)
            if device is None or torch.device(device).type == "cuda":
                torch.cuda.synchronize(dev)
            times[f"restore {device or dev}"] = time.perf_counter() - t0
            return out

    mgr = Timed(str(root), keep_last=1)
    calls, final = [], {}

    def run_fn(resume):
        calls.append(resume)
        state, start = None, 0
        if resume is not None:
            state, extra = mgr.restore(skel, device=dev)
            start = extra["data"]["step"]
        it = DataIterator(cfg, pc, start_step=start)
        state = trainer.run(cfg, tc, it, 3 if resume is None
                            else CKPT_STEPS - start, state=state,
                            log_every=0, device=dev,
                            ckpt_mgr=mgr if resume is None else None,
                            ckpt_every=2)
        if resume is None:
            raise RuntimeError("fault injected after step 3")
        final["state"] = state

    restarts = RestartLoop(mgr, log=log).supervise(run_fn)
    state = final.pop("state")
    got = leaves(state.params)
    same = len(got) == len(want) and all(
        torch.equal(a.cpu(), b) for a, b in zip(got, want))
    del got, want, state
    gc.collect()
    torch.cuda.empty_cache()
    host, _ = mgr.restore(skel, step=2, device="cpu")
    host = flatten(host)
    n_leaves = len(mgr.card_copy)
    saved = len(host) == n_leaves and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(host, mgr.card_copy))
    del host, mgr.card_copy
    counts = _flash_counts(fns)
    steps = CKPT_STEPS + 3 + (CKPT_STEPS - 2)
    want_counts = dict.fromkeys(FLASH, CKPT_LAYERS * steps)
    want_counts["flash_attention_fwd"] *= 2      # "dots" recomputes it
    log(f"checkpoint phase: llama3-8b {CKPT_LAYERS} layers, "
        f"{nbytes / 1e9:.2f} GB a checkpoint ({n_leaves} leaves): save "
        f"{times['save']:.2f} s (host copy {times['snapshot']:.2f} s, then "
        f"written), restore onto the card "
        f"{times[f'restore {dev}']:.2f} s, onto the CPU "
        f"{times['restore cpu']:.2f} s (file cache warm); restarts "
        f"{restarts}, resumed from {calls[1:]}; final params "
        f"{'equal to' if same else 'DIFFER from'} the uninterrupted run's; "
        f"the step-2 checkpoint on the CPU "
        f"{'equals' if saved else 'DIFFERS from'} the card's state; "
        f"launches {json.dumps(counts)}")
    shutil.rmtree(root, ignore_errors=True)
    if restarts != 1 or calls != [None, 2] or not same or not saved or \
            counts != want_counts:
        raise AssertionError(f"checkpoint phase: restarts {restarts}, "
                             f"calls {calls}, params equal {same}, "
                             f"checkpoint equal {saved}, launches {counts} "
                             f"(expected {want_counts})")
    return {"llama3-8b": counts}


def _launch_train(ckpt_dir, popen=False):
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_TRAIN,
           "--ckpt-dir", str(ckpt_dir)]
    if popen:
        return subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    proc = subprocess.run(cmd, env=env, cwd=ROOT, text=True,
                          capture_output=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"launch.train exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _same_bytes(a, b, chunk=64 << 20):
    """Whether files ``a`` and ``b`` hold the same bytes (read in chunks
    of 64 MiB: ``filecmp`` reads 8 KiB at a time)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def launcher_restart_phase(dev):
    """``python -m repro_torch.launch.train`` on qwen1.5-0.5b at full width
    and depth (LAUNCH_TRAIN: LAUNCH_STEPS steps of 2 x 2048 tokens, a
    checkpoint every 2, one kept): once uninterrupted and, beside it on
    the same card, once killed with SIGKILL as soon as step 2's
    checkpoint is committed; then the killed command again, which must
    report resuming from the newest committed step and write the last
    step's files byte for byte the uninterrupted run's.  (The launcher trains with the JAX package's
    default attention, einsum: no kernel of the port on this path.)"""
    import os
    import signal
    import shutil

    import torch
    from repro_torch import get
    from repro_torch.checkpoint import CheckpointManager
    torch.cuda.empty_cache()
    root = ROOT / "build" / "launch-smoke"
    shutil.rmtree(root, ignore_errors=True)
    nbytes = 12 * get("qwen1.5-0.5b").params_count()
    _need_disk(root, 4 * nbytes, "launcher phase")
    t0 = time.perf_counter()
    whole = _launch_train(root / "whole", popen=True)
    killed = root / "killed"
    proc = _launch_train(killed, popen=True)
    marker = killed / "step_00000002" / ".COMMITTED"
    while not marker.exists() and proc.poll() is None:
        time.sleep(0.05)
    if proc.poll() is not None:
        raise AssertionError("launch.train ended before step 2 was "
                             f"committed:\n{proc.communicate()[0][-3000:]}")
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    t_killed = time.perf_counter() - t0
    newest = CheckpointManager(str(killed)).latest_step()
    t1 = time.perf_counter()
    resumed = _launch_train(killed)
    t_resumed = time.perf_counter() - t1
    out = whole.communicate(timeout=600)[0]
    t_whole = time.perf_counter() - t0
    if whole.returncode != 0:
        raise AssertionError(f"launch.train exited {whole.returncode}:\n"
                             f"{out[-3000:]}")
    last = f"step_{LAUNCH_STEPS:08d}"
    a, b = root / "whole" / last, killed / last
    names = sorted(os.listdir(a))
    same = names == sorted(os.listdir(b)) and all(
        _same_bytes(a / n, b / n) for n in names)
    line = f"[launch] restored step {newest}"
    losses = [ln for ln in resumed.splitlines() if ln.startswith("step ")]
    log(f"launcher phase: qwen1.5-0.5b {' '.join(LAUNCH_TRAIN)}: "
        f"killed (SIGKILL) at step {newest}'s commit {t_killed:.1f} s "
        f"after its start, resumed in {t_resumed:.1f} s "
        f"({'reports' if line in resumed else 'does NOT report'} "
        f"{line!r}; {losses}); the uninterrupted run beside them "
        f"{t_whole:.1f} s; {last}'s {len(names)} files "
        f"{'byte for byte equal' if same else 'DIFFER'} "
        f"({nbytes / 1e9:.2f} GB a checkpoint)")
    shutil.rmtree(root, ignore_errors=True)
    if newest is None or not 2 <= newest < LAUNCH_STEPS or \
            line not in resumed or \
            not same:
        raise AssertionError("launcher phase: the resumed run did not "
                             "resume from the newest checkpoint or did not "
                             "write the uninterrupted run's files")


def _dp_batches(cfg, dev):
    import torch
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    it = DataIterator(cfg, PipelineConfig(seed=0, global_batch=2,
                                          seq_len=2048))
    return [{k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
            for _ in range(DP_STEPS)]


def _dp_config(scheme, microbatches=1):
    import dataclasses
    return dataclasses.replace(_train_config(), grad_compression=scheme,
                               microbatches=microbatches)


def _digest(params):
    """Per leaf, the int64 sum of its 32-bit words weighted by their
    position (mod 65521, plus 1): one small tensor that ranks holding
    other params would not share."""
    import torch
    from repro_torch.optim.adamw import leaves
    out = []
    for p in leaves(params):
        w = p.detach().contiguous().reshape(-1).view(torch.int32).long()
        out.append((w * (torch.arange(w.numel(), device=w.device) % 65521
                         + 1)).sum())
    return torch.stack(out)


def _dp_rank(rank, one_path):
    """One of two data-parallel ranks sharing the card over gloo:
    DP_STEPS steps of qwen1.5-0.5b under each wire scheme, timed;
    uncompressed, the params checked against one device's bit for bit,
    compressed, the ranks' digests of their params checked equal."""
    import torch
    from repro_torch import get
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import leaves
    from repro_torch.shard import comm
    from repro_torch.train import trainer
    mesh = make_host_mesh(1, 2, backend="gloo", device="cuda:0")
    dev = mesh.device
    cfg = get("qwen1.5-0.5b")
    batches = _dp_batches(cfg, dev)
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    out = {}
    for scheme in DP_SCHEMES:
        state = trainer.init_state(cfg, torch.Generator(
            device=dev).manual_seed(0))
        step = trainer.make_train_step(cfg, _dp_config(scheme), mesh=mesh)
        losses, ms = [], []
        comm.reset_stats(timed=True)
        for batch in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        stats = dict(comm.STATS)
        row = {"losses": losses, "ms": ms,
               "bytes": stats["bytes"] / DP_STEPS,
               "gather_ms": stats["seconds"] * 1e3 / DP_STEPS,
               "gathers": stats["gathers"] / DP_STEPS}
        if scheme is None:          # both equal to one device: they agree
            one = torch.load(one_path, weights_only=False)
            row["one_device"] = one["losses"] == losses and all(
                torch.equal(a.cpu(), b)
                for a, b in zip(leaves(state.params), one["params"]))
            row["agree"] = row["one_device"]
            del one
        else:
            row["agree"] = comm.all_equal(_digest(state.params))
        out[scheme] = row
        del state, step
        torch.cuda.empty_cache()
    out["launches"] = _flash_counts(fns)
    return out


def dp_train_phase(dev):
    """Data-parallel training on the card: two gloo ranks sharing it
    (``make_train_step(mesh=)``), qwen1.5-0.5b at full width and depth,
    1 x 2048 tokens a rank, DP_STEPS steps under no compression, bf16 and
    int8 on the wire.  Uncompressed, both ranks' params and losses equal
    one device's at ``microbatches=2`` (run here first) bit for bit;
    bf16 / int8 give finite, falling losses, int8 within DP_INT8_LOSS_TOL
    of the uncompressed run's.  Logs bytes on the wire a step, gather ms
    and step ms.  Returns the K7 / K8 launches of both ranks and the one
    device."""
    import shutil

    import torch
    from repro_torch import get
    from repro_torch.optim.adamw import leaves
    from repro_torch.shard import comm
    from repro_torch.train import trainer
    torch.cuda.empty_cache()
    cfg = get("qwen1.5-0.5b")
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    state = trainer.init_state(cfg, torch.Generator(device=dev)
                               .manual_seed(0))
    step = trainer.make_train_step(cfg, _dp_config(None, microbatches=2))
    losses = []
    for batch in _dp_batches(cfg, dev):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    counts = _flash_counts(fns)
    root = ROOT / "build" / "dp-smoke"
    root.mkdir(parents=True, exist_ok=True)
    one_path = root / "one.pt"
    torch.save({"losses": losses,
                "params": [p.cpu() for p in leaves(state.params)]}, one_path)
    del state, step
    torch.cuda.empty_cache()
    ranks = comm.spawn(2, _dp_rank, (str(one_path),), backend="gloo",
                       timeout=900)
    shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    base = r0[None]["losses"]
    for scheme in DP_SCHEMES:
        row = r0[scheme]
        log(f"dp train qwen1.5-0.5b, 2 ranks x 1 x 2048 over gloo on one "
            f"card, wire {scheme or 'f32'}: losses {row['losses']}, step ms "
            f"{[round(x, 2) for x in row['ms']]}, {row['bytes'] / 1e6:.2f} "
            f"MB a rank a step in {row['gathers']:.0f} gather, gather "
            f"{row['gather_ms']:.2f} ms a step (host clock, card "
            f"synchronised), ranks {'agree' if row['agree'] else 'DIFFER'}")
    log(f"dp train: one device at microbatches=2, losses {losses}; the "
        f"ranks' uncompressed params and losses "
        f"{'equal' if r0[None]['one_device'] else 'DIFFER from'} it bit "
        "for bit")
    bad = []
    for r in ranks:
        if not r[None]["one_device"]:
            bad.append("uncompressed ranks differ from one device")
        for scheme in DP_SCHEMES:
            row = r[scheme]
            if not row["agree"] or row["losses"] != r0[scheme]["losses"]:
                bad.append(f"{scheme}: the ranks disagree")
            if not all(x == x and abs(x) < float("inf")
                       for x in row["losses"]) or \
                    not row["losses"][-1] < row["losses"][0]:
                bad.append(f"{scheme}: losses not finite and falling")
    gap = max(abs(a - b) for a, b in zip(r0["int8"]["losses"], base))
    if gap > DP_INT8_LOSS_TOL:
        bad.append(f"int8 losses {gap} from the uncompressed run's")
    want = {k: cfg.n_layers * DP_STEPS * len(DP_SCHEMES) for k in FLASH}
    want["flash_attention_fwd"] *= 2
    for r in ranks:
        if r["launches"] != want:
            bad.append(f"rank launches {r['launches']} are not {want}")
    if bad:
        raise AssertionError("dp train: " + "; ".join(bad))
    return {"qwen1.5-0.5b": {k: counts[k] + sum(r["launches"][k]
                                                 for r in ranks)
                             for k in FLASH}}


def families_cross_check(dev):
    """Each new family served on the card and on the CPU from the same
    weights, at a reduced config that keeps the real head dim (``reduced``
    with ``d_head=cfg.head_dim``: K2 / K3 at Dh 64, 80, 256 and 128), aida
    at chunk 1 and 8: the same greedy tokens (or a first difference at a
    near-tie) and the same SWA page reclamation (the reduced window is 32,
    and the longest request runs to position 75)."""
    import dataclasses

    from repro_torch import CompressionSpec, Engine, Request, bridge, get
    from repro_torch import reduced
    for name, _ in FAMILY_SERVES:
        cfg = dataclasses.replace(reduced(get(name)),
                                  d_head=get(name).head_dim)
        cpu = Engine(cfg, device="cpu", seed=0).compress(
            CompressionSpec(mode="aida", density=0.25))
        gpu = Engine(cfg, params=bridge.to_device(cpu.params, dev),
                     device=dev)
        for chunk in (1, 8):
            out = {}
            for where, eng in (("cpu", cpu), ("cuda", gpu)):
                sess = eng.session(batch_slots=4, max_len=128,
                                   scheduler={"chunk": chunk})
                for i, n in enumerate((5, 9, 16, 60)):
                    sess.submit(Request(prompt=[(7 * i + 3 * j) % cfg.vocab
                                                for j in range(n)],
                                        max_new=16, rid=i))
                out[where] = (sess.run(), sess.margins,
                              sess.stats["pages_reclaimed_swa"])
            (ref, margins, rec_cpu), (got, _, rec_gpu) = out["cpu"], \
                out["cuda"]
            flips = _near_tie_flips(ref, margins, got,
                                    f"cross-check {name} chunk {chunk}")
            log(f"cross-check: reduced {name} (head dim {cfg.head_dim}) aida "
                f"chunk {chunk}, cuda vs cpu greedy tokens: "
                f"{'identical' if not flips else f'{flips} near-tie flips'}; "
                f"SWA pages reclaimed cpu {rec_cpu} cuda {rec_gpu}")
            if rec_cpu != rec_gpu:
                raise AssertionError(f"cross-check {name}: the card and the "
                                     "CPU reclaimed other SWA pages")


# --------------------------------------------- hymba, hubert, the zoo
def hymba_serve_phase(dev):
    """hymba-1.5b at full width and depth (32 layers: windows of 1024,
    global layers 0, 15 and 31; 25 query heads over 5 kv heads),
    ``Engine.compress(aida 0.25)``, serves the four requests at chunk 1
    (hymba's mamba heads are recurrent: chunk 8 asked, chunk 1 served),
    paged (K1 nine times a layer and step, with the mamba in / out
    projections; K2 once at a query group of 5) and from the full cache
    (K1 only); tokens equal up to flips that the two routes' logits gap
    explains (``_drift_flips``), every launch counted, then a profiled
    short serve of each.  Returns both serves' launch
    counts."""
    import gc

    import torch
    from repro_torch import CompressionSpec, Request, get
    gc.collect()
    torch.cuda.empty_cache()
    eng = _compressed_engine(dev, get("hymba-1.5b"), CompressionSpec(
        mode="aida", density=0.25), "serve hymba-1.5b")
    for kv in ("paged", "full"):          # cuBLAS handles, first launches
        warm = eng.session(batch_slots=4, max_len=256, kv_cache=kv)
        warm.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
        warm.run()
    ref, sessp, cp, _ = _serve(dev, eng, "serve hymba-1.5b paged",
                               "acsr_spmv", 8)
    got, sessf, cf, _ = _serve(dev, eng, "serve hymba-1.5b full cache",
                               "acsr_spmv", 8, kv_cache="full")
    if sessp.stats["chunk"] != 1 or _fc_per_layer(eng) != 9:
        raise AssertionError("hymba must serve at chunk 1 with 9 compressed "
                             "projections a layer")
    flips, worst = _drift_flips(ref, sessp, got, sessf,
                                "hymba full vs paged")
    log(f"serve hymba-1.5b: full cache vs paged greedy tokens: "
        f"{_flips_text(flips, worst)}; logits "
        f"max abs drift {_logit_drift(ref, sessp, got, sessf):.6g}")
    trace_serve(eng, 1, n_req=1, label="hymba-1.5b paged")
    trace_serve(eng, 1, n_req=1, label="hymba-1.5b full cache",
                kv_cache="full")
    del eng, sessp, sessf
    return {"paged": cp, "full": cf}


HUBERT_FRAMES = 2048


def hubert_forward_phase(dev):
    """hubert-xlarge at full width and depth (48 layers): ``forward`` over
    2 x 2048 frames of 512 features, no grad, attention through K7
    (non-causal, D 80; one launch a layer and nothing else), after a short
    warm-up forward: finite logits of the expected shape, ms and peak GiB
    logged.  Returns K7's launches."""
    import gc

    import torch
    from repro_torch import get
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get("hubert-xlarge")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen)
    frames = torch.randn((2, HUBERT_FRAMES, cfg.audio_in_dim), generator=gen,
                         device=dev)
    with torch.no_grad():
        M.forward(cfg, params, {"frames": frames[:, :128]}, remat="none",
                  attn_impl="flash")
        fns = _launch_counters()
        torch.cuda.reset_peak_memory_stats(dev)
        for f in fns.values():
            f.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = M.forward(cfg, params, {"frames": frames}, remat="none",
                              attn_impl="flash")
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    counts = {k: f.launches for k, f in fns.items()}
    want = dict.fromkeys(fns, 0)
    want["flash_attention_fwd"] = cfg.n_layers
    log(f"hubert-xlarge forward, {cfg.n_layers} layers, B=2 T="
        f"{HUBERT_FRAMES} frames, K7 non-causal D {cfg.head_dim}: "
        f"{ms:.2f} ms, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, logits "
        f"{tuple(logits.shape)} max |x| {float(logits.abs().max()):.4g}; "
        f"launches {json.dumps(counts)}")
    if counts != want:
        raise AssertionError("hubert's forward did not launch K7 once a "
                             "layer")
    if tuple(logits.shape) != (2, HUBERT_FRAMES, cfg.vocab_padded) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("hubert's forward gave non-finite logits or "
                             "the wrong shape")
    return counts["flash_attention_fwd"]


def zoo_cross_check(dev):
    """This slice's paths at ``reduced()`` size on the card against the
    CPU from the same weights: hymba (window 32) served paged and from the
    full cache with requests past the window (aida): the same greedy
    tokens, or a first difference at a near-tie; hubert's and
    phi-3-vision's training losses (flash, 2 steps) within 1e-2; and
    h2o-danube's ring cache served on the card against its paged serve
    with SWA reclamation (tokens equal up to near-tie flips, pages
    reclaimed, at most window / page + 2 held)."""
    import torch
    from repro_torch import CompressionSpec, Engine, Request, bridge, get
    from repro_torch import reduced
    from repro_torch.data.pipeline import DataIterator, PipelineConfig
    from repro_torch.train import trainer
    cfg = reduced(get("hymba-1.5b"))
    cpu = Engine(cfg, device="cpu", seed=0).compress(
        CompressionSpec(mode="aida", density=0.25))
    gpu = Engine(cfg, params=bridge.to_device(cpu.params, dev), device=dev)
    for kv in ("paged", "full"):
        out = {}
        for where, eng in (("cpu", cpu), ("cuda", gpu)):
            sess = eng.session(batch_slots=2, max_len=128, kv_cache=kv)
            for i, n in enumerate((5, 40, 60)):
                sess.submit(Request(prompt=[(7 * i + 3 * j) % cfg.vocab
                                            for j in range(n)],
                                    max_new=16, rid=i))
            out[where] = (sess.run(), sess.margins)
        flips = _near_tie_flips(out["cpu"][0], out["cpu"][1],
                                out["cuda"][0], f"cross-check hymba {kv}")
        log(f"cross-check: reduced hymba-1.5b aida {kv}, cuda vs cpu greedy "
            f"tokens: "
            f"{'identical' if not flips else f'{flips} near-tie flips'}")
    for name, seq_len in (("hubert-xlarge", 256), ("phi-3-vision-4.2b",
                                                   576 + 64)):
        cfg = reduced(get(name))
        init = trainer.init_state(cfg, torch.Generator().manual_seed(0))
        states = {"cuda": bridge.to_device(init, dev), "cpu": init}
        losses = {}
        for where, state in states.items():
            lines = []
            trainer.run(cfg, _train_config(), DataIterator(
                cfg, PipelineConfig(seed=1, global_batch=2,
                                    seq_len=seq_len)), 2, state=state,
                log_every=1, log=lines.append,
                device=dev if where == "cuda" else "cpu")
            losses[where] = [float(ln.split("loss=")[1].split()[0])
                             for ln in lines]
        diff = max(abs(a - b) for a, b in zip(losses["cpu"],
                                              losses["cuda"]))
        log(f"cross-check: reduced {name} flash training ({seq_len} rows), "
            f"losses cpu {losses['cpu']} cuda {losses['cuda']}, max diff "
            f"{diff:.2e}")
        if diff > 1e-2:
            raise AssertionError(f"{name}: card and CPU losses disagree")
    cfg = reduced(get("h2o-danube-1.8b"))
    eng = Engine(cfg, device=dev, seed=0)
    res = {}
    for kv in ("full", "paged"):
        sess = eng.session(batch_slots=1, max_len=80, kv_cache=kv,
                           page_size=8)
        sess.submit(Request(prompt=[1, 2, 3], max_new=56, rid=0))
        res[kv] = (sess.run(), sess)
    (ring, rsess), (paged, psess) = res["full"], res["paged"]
    flips = _near_tie_flips(ring, rsess.margins, paged,
                            "h2o-danube ring vs paged")
    slots = rsess.state["layers"]["kv"].k.shape[3]
    log(f"cross-check: reduced h2o-danube-1.8b on the card, ring cache "
        f"({slots} slots) vs paged: greedy tokens "
        f"{'identical' if not flips else f'{flips} near-tie flips'}; pages "
        f"reclaimed {psess.stats['pages_reclaimed_swa']}, peak "
        f"{psess.stats['pages_peak']}")
    if slots != cfg.window or psess.stats["pages_reclaimed_swa"] == 0 or \
            psess.stats["pages_peak"] > cfg.window // 8 + 2 or \
            psess.alloc.in_use:
        raise AssertionError("h2o-danube: the ring cache or the SWA "
                             "reclamation is off")


# --------------------------------------------------------------- rwkv6
RWKV_PROMPT = 32      # positions compared between forward and decode
# forward vs token-by-token decode.  Both round to bf16 at the same places,
# but the forward's projections are [B * T, d] products and its WKV is K9,
# the decode's are [B, d] products and an einsum, so f32 sums run in other
# orders and bf16 activations land an ulp apart in places.  The randomly
# initialised rwkv6-7b amplifies such a difference about twofold a layer
# (on an H100 the forward at T = 32 against itself at T = 64 differs by
# 2.2e-2 at 1 layer, 0.43 at 4, 4.8 at 32, logits of std 1), so the two
# routes are compared one layer deep at full width, and at 32 layers only
# logged beside the forward's own gap between two sequence lengths.  The
# limits sit between the sound gap and the gaps of faults planted in the
# decode's WKV (_wkv_faults), as read on an H100 80GB HBM3 at 700 W:
# logits one layer deep, sound max 5.12e-2 mean 3.27e-3, bonus u dropped
# 6.44 / 9.28e-2, k and v swapped 7.91 / 1.04, so max 0.15 and mean 0.015.
# The decay applied before the output (5.12e-2 / 4.95e-3) stays inside
# the rounding there: at this init the decays are 0.982, so it moves the
# state by under 2 %.  Layer 0's time-mix output (mean |x| 0.37) sees it:
# sound 7.81e-3 / 4.58e-5, decay before the output 1.17e-2 / 7.18e-4, u
# dropped 1.14 / 2.73e-2, k and v swapped 2.99 / 0.506, so max 0.1 and
# mean 2e-4 there.  A fault must exceed the max or the mean limit.
RWKV_CHECK_LAYERS = 1
RWKV_LOGIT_TOL = (0.15, 0.015)
RWKV_MIX_TOL = (0.1, 2e-4)
RWKV_LOGITS_BLIND = ("decay before the output",)


def _rwkv6_decode_logits(cfg, params, tokens, dev):
    """Logits of decode_step fed ``tokens`` [B, P] one column at a time."""
    import torch
    from repro_torch.models import model as M
    state = M.init_decode_state(cfg, tokens.shape[0], 2 * tokens.shape[1],
                                device=dev)
    steps = []
    for i in range(tokens.shape[1]):
        state, lg = M.decode_step(cfg, params, state, tokens[:, i])
        steps.append(lg[:, :cfg.vocab])
    return torch.stack(steps, 1)


def _wkv_faults(tm):
    """Decode-side WKV faults, (name, time-mix params, decode step): the
    bonus u dropped; key and value swapped in the state update (S += v kᵀ,
    Dk = Dv); the decay applied to the state before the output reads
    it."""
    import torch
    from repro_torch.kernels import ops
    sound = ops.rwkv6_decode_step

    def kv_swapped(S, r, k, v, w, u):
        _, o = sound(S, r, k, v, w, u)
        return w[..., :, None] * S + v[..., :, None] * k[..., None, :], o

    def decay_first(S, r, k, v, w, u):
        return sound(w[..., :, None] * S, r, k, v, torch.ones_like(w), u)
    return [("bonus u dropped", dict(tm, u=torch.zeros_like(tm["u"])),
             sound),
            ("k and v swapped in the state", tm, kv_swapped),
            ("decay before the output", tm, decay_first)]


@contextlib.contextmanager
def _decode_step(fn):
    """ops.rwkv6_decode_step replaced by ``fn`` inside the block."""
    from repro_torch.kernels import ops
    sound, ops.rwkv6_decode_step = ops.rwkv6_decode_step, fn
    try:
        yield
    finally:
        ops.rwkv6_decode_step = sound


def _rwkv6_fault_gaps(cfg, params, tokens, dev, full):
    """{fault: (max, mean)} of the decode logits with each WKV fault
    planted against the forward's ``full``."""
    out = {}
    for name, tm, step in _wkv_faults(params["layers"]["tm"]):
        faulty = dict(params, layers=dict(params["layers"], tm=tm))
        with _decode_step(step):
            out[name] = _gap(_rwkv6_decode_logits(cfg, faulty, tokens, dev),
                             full)
    return out


def _time_mix_gaps(cfg, params, tokens):
    """Layer 0's time mix on the embedded ``tokens`` [B, P]: the sequence
    route (``ops.rwkv6``, K9 on the card) against the decode route fed one
    token at a time, sound and with each WKV fault planted.  Returns the
    output's mean magnitude and {"sound" or fault: (max, mean)} of the
    gaps."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed, rms_norm
    p0 = _layers(params["layers"], 0)
    tm0 = p0["tm"]
    x = rms_norm(embed(tokens, params["embed"]), p0["ln1"])
    b, t, d = x.shape
    dh = cfg.rwkv_head_dim
    seq, _ = ssm.rwkv6_time_mix(tm0, x, torch.zeros_like(x[:, 0]),
                                d_head=dh)
    seq = seq.float()

    def decoded(tm):
        st = {"prev": torch.zeros_like(x[:, 0]),
              "S": torch.zeros((b, d // dh, dh, dh), dtype=torch.float32,
                               device=x.device)}
        outs = []
        for i in range(t):
            st, o = ssm.rwkv6_time_mix_decode(tm, st, x[:, i:i + 1],
                                              d_head=dh)
            outs.append(o)
        return torch.cat(outs, 1).float()
    gaps = {"sound": _gap(decoded(tm0), seq)}
    for name, tm, step in _wkv_faults(tm0):
        with _decode_step(step):
            gaps[name] = _gap(decoded(tm), seq)
    return float(seq.abs().mean()), gaps


def _gap(a, b):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def rwkv6_forward_phase(dev):
    """rwkv6-7b at full width, all 32 layers, random weights from seed 0:
    ``forward`` over 2 x 2048 tokens under no_grad with every launch count
    set to 0 just before (one K9 launch per layer, nothing else), finite
    logits.  Then ``decode_step`` fed the first RWKV_PROMPT tokens one at a
    time against the forward's logits at those positions: at
    RWKV_CHECK_LAYERS layers within RWKV_LOGIT_TOL (max, mean) and the same
    greedy token wherever the top-2 margin exceeds the max; layer 0's time
    mix, sequence route against decode route, within RWKV_MIX_TOL; every
    planted WKV fault outside them (the decay fault outside the time-mix
    limit only); at 32 layers logged beside the forward's own gap between
    two sequence lengths.  Returns the engine (raw params) and K9's
    launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch import Engine, get
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get("rwkv6-7b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev, seed=0)
    params = eng.params
    torch.cuda.synchronize(dev)
    log(f"rwkv6-7b: init {time.perf_counter() - t0:.2f} s, "
        f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B params")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 2048)), device=dev)
    prompt = tokens[:, :RWKV_PROMPT]
    fns = _launch_counters()
    with torch.no_grad():
        M.forward(cfg, params, {"tokens": tokens[:, :64]})   # warm-up
        for f in fns.values():
            f.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = M.forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize(dev)
        t_fwd = time.perf_counter() - t0
        counts = {k: f.launches for k, f in fns.items()}
        finite = bool(torch.isfinite(logits).all())
        head = logits[:, :RWKV_PROMPT, :cfg.vocab].clone()
        del logits
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        deep = _gap(_rwkv6_decode_logits(cfg, params, prompt, dev), head)
        short = M.forward(cfg, params, {"tokens": prompt})[0][..., :cfg.vocab]
        self_gap = _gap(short, head)
        cut = dataclasses.replace(cfg, n_layers=RWKV_CHECK_LAYERS)
        p_cut = dict(params, layers=_layers(params["layers"],
                                            slice(RWKV_CHECK_LAYERS)))
        full = M.forward(cut, p_cut, {"tokens": tokens})[0]
        full = full[:, :RWKV_PROMPT, :cfg.vocab]
        dec = _rwkv6_decode_logits(cut, p_cut, prompt, dev)
        controls = _rwkv6_fault_gaps(cut, p_cut, prompt, dev, full)
        scale, tm_gaps = _time_mix_gaps(cfg, params, prompt)
    log(f"rwkv6 forward d_model {cfg.d_model}, {cfg.n_layers} layers, B=2 "
        f"T=2048: {t_fwd * 1e3:.2f} ms, peak {peak:.2f} GiB, logits "
        f"{'finite' if finite else 'NOT finite'}")
    want = dict.fromkeys(fns, 0)
    want["rwkv6_scan"] = cfg.n_layers
    log(f"rwkv6 forward: launches {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    if counts != want:
        raise AssertionError("the rwkv6 forward did not launch K9 once per "
                             "layer")
    if not finite:
        raise AssertionError("rwkv6 forward: non-finite logits")
    log(f"rwkv6 at {cfg.n_layers} layers over {RWKV_PROMPT} positions: "
        f"decode vs forward max {deep[0]:.4e} mean {deep[1]:.4e}; the "
        f"forward at T={RWKV_PROMPT} vs T=2048 max {self_gap[0]:.4e} mean "
        f"{self_gap[1]:.4e} (rounding amplified by depth)")
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > RWKV_LOGIT_TOL[0]
    agree = torch.equal(dec.argmax(-1)[clear], full.argmax(-1)[clear])
    gap = _gap(dec, full)
    log(f"rwkv6 at {RWKV_CHECK_LAYERS} layer(s), full width, over "
        f"{RWKV_PROMPT} positions: decode vs forward max {gap[0]:.4e} mean "
        f"{gap[1]:.4e} (limits {RWKV_LOGIT_TOL[0]:g}, mean "
        f"{RWKV_LOGIT_TOL[1]:g}); greedy tokens "
        f"{'equal' if agree else 'DIFFER'} at the {int(clear.sum())} of "
        f"{clear.numel()} positions with a top-2 margin above "
        f"{RWKV_LOGIT_TOL[0]:g}")
    for name, g in controls.items():
        log(f"rwkv6 control, decode with the {name}: vs forward max "
            f"{g[0]:.4e} mean {g[1]:.4e}")
    log(f"rwkv6 layer 0 time mix, full width, over {RWKV_PROMPT} positions "
        f"(output mean |x| {scale:.4e}), decode route vs sequence route "
        f"(limits {RWKV_MIX_TOL[0]:g}, mean {RWKV_MIX_TOL[1]:g}): "
        + "; ".join(f"{name} max {g[0]:.4e} mean {g[1]:.4e}"
                    for name, g in tm_gaps.items()))

    def within(g, lim):
        return g[0] <= lim[0] and g[1] <= lim[1]
    if not within(gap, RWKV_LOGIT_TOL):
        raise AssertionError("rwkv6 forward and decode disagree")
    if not agree:
        raise AssertionError("rwkv6 forward and decode pick other tokens")
    if not within(tm_gaps.pop("sound"), RWKV_MIX_TOL):
        raise AssertionError("rwkv6 time mix: sequence and decode routes "
                             "disagree")
    missed = [name for name, g in controls.items()
              if name not in RWKV_LOGITS_BLIND and within(g, RWKV_LOGIT_TOL)]
    missed += [f"{name} (time mix)" for name, g in tm_gaps.items()
               if within(g, RWKV_MIX_TOL)]
    if missed:
        raise AssertionError("the forward-vs-decode limits let a planted "
                             f"WKV fault pass: {missed}")
    return eng, counts["rwkv6_scan"]


def _layers(tree, key):
    """Every leaf of a stacked param tree indexed by ``key`` (a layer or a
    slice of layers), as views."""
    if isinstance(tree, dict):
        return {k: _layers(v, key) for k, v in tree.items()}
    return tree[key]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def rwkv6_serve_phase(dev, eng):
    """The rwkv6 aida serve at full width, 32 layers:
    ``eng.compress(aida 0.25).serve`` of the four requests (prompts fed
    token by token, no pages), every launch count set to 0 just before:
    8 K1 launches per layer and step and nothing else.  Returns K1's
    launches."""
    import torch
    from repro_torch import CompressionSpec, Request
    t0 = time.perf_counter()
    eng.compress(CompressionSpec(mode="aida", density=0.25))
    torch.cuda.synchronize(dev)
    log(f"serve rwkv6 aida: compress {time.perf_counter() - t0:.2f} s, "
        f"ratio {eng.stats['ratio']:.3f} vs bf16, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    warm = eng.session(batch_slots=4, max_len=256)
    warm.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
    warm.run()
    sess = eng.session(batch_slots=4, max_len=256)
    for r in _requests(eng.cfg):
        sess.submit(r)
    fns = _launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    steps = sess.stats["steps"]
    n_tok = sum(len(r.tokens) for r in res)
    log(f"serve rwkv6 aida: {len(res)}/4 requests, {n_tok} tokens, {steps} "
        f"steps, {dt * 1e3 / steps:.2f} ms/step, {n_tok / dt:.2f} tok/s, "
        f"K1 {counts['acsr_spmv_gather'] / steps:.0f} launches/step, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB while "
        "serving")
    want = dict.fromkeys(fns, 0)
    want["acsr_spmv_gather"] = 8 * eng.cfg.n_layers * steps
    log(f"serve rwkv6 aida: launches {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    log("serve rwkv6 aida: tokens "
        + json.dumps({r.rid: r.tokens for r in res}))
    if len(res) != 4 or any(len(r.tokens) != 16 for r in res):
        raise AssertionError("the rwkv6 serve did not finish 4/4 requests")
    if counts != want:
        raise AssertionError("the rwkv6 serve did not go through K1 on every "
                             "projection and layer")
    if sess.stats["nonfinite_logit_rows"]:
        raise AssertionError("rwkv6 serve: non-finite logits were emitted")
    # one request: a decode step computes all four slots all the same, and
    # the profiler's events of a longer serve take long to collect
    trace_serve(eng, 1, n_req=1)
    return counts["acsr_spmv_gather"]


def rwkv6_cross_check(dev):
    """A reduced rwkv6-7b (two WKV heads of 64) served in aida on the card
    and on the CPU from the same weights gives the same greedy tokens, or
    differs only at a near-tie; its forward runs K9 on the card and the
    plain version on the CPU."""
    import numpy as np
    import torch
    from repro_torch import CompressionSpec, Engine, Request, bridge, get
    from repro_torch import reduced
    from repro_torch.models import model as M
    cfg = reduced(get("rwkv6-7b"))
    cpu = Engine(cfg, device="cpu", seed=0)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)))
    with torch.no_grad():
        want, _ = M.forward(cfg, cpu.params, {"tokens": tokens})
        got, _ = M.forward(cfg, bridge.to_device(cpu.params, dev),
                           {"tokens": tokens.to(dev)})
    diff = float((got.cpu() - want).abs().max())
    log(f"cross-check: reduced rwkv6-7b forward, cuda vs cpu logits max abs "
        f"diff {diff:.3e} (tolerance 5e-2, as the CPU port against the "
        "reference: bf16 activations an ulp apart where f32 sums differ)")
    if diff > 5e-2:
        raise AssertionError("rwkv6 forward: card and CPU logits disagree")
    cpu.compress(CompressionSpec(mode="aida", density=0.25))
    gpu = Engine(cfg, params=bridge.to_device(cpu.params, dev), device=dev)
    out = {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        sess = eng.session(batch_slots=4, max_len=256)
        for i, n in enumerate((5, 9, 16, 23)):
            sess.submit(Request(prompt=[(7 * i + 3 * j) % cfg.vocab
                                        for j in range(n)],
                                max_new=16, rid=i))
        out[name] = (sess.run(), sess.margins)
    (ref, margins), (res, _) = out["cpu"], out["cuda"]
    flips = _near_tie_flips(ref, margins, res, "cross-check rwkv6 aida")
    log("cross-check: reduced rwkv6-7b aida, cuda vs cpu greedy tokens: "
        + ("identical" if not flips else f"{flips} near-tie flips"))


# ---------------------------------------------------------------- mesh
MESH_TP = (2, 4)
MESH_LAYERS = 4       # the two-rank serve: llama3-8b at full width
MESH_ONE_LAYERS = 2   # the nccl mesh of one
MESH_CONTEXTS = (37, 2048)


def _band_bias(bias, n, tp, r):
    """Rank ``r``'s slice of ``bias`` padded to ``n * tp`` rows."""
    import torch
    if bias is None:
        return None
    return torch.nn.functional.pad(bias, (0, n * tp - bias.shape[0]))[
        r * n:(r + 1) * n]


def mesh_band_phase(dev, flush):
    """The shard layer's band launches in one process: llama3-8b's seven
    projections in aida (K1 gather at 4 columns, K1 wide at 32) and int8 /
    codebook4 (K4 / K5 at 4 and 32 rows), cut into tp = 2 and 4 row bands
    (`shard.partition.local_view`), each band launched with the whole's
    split (``split``), the bands concatenated: bit for bit the whole
    launch, bias on wq and silu on gate included; then K2 / K3 on head
    groups (Hkv 8, contexts 37 and 2048, bf16 pages) against the whole.
    Logs a layer's whole ms beside one band's (rank 0's) per kernel, rows
    and tp.  These launches compare; they are not the main path's."""
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kvstore.paged_attention import (paged_attention,
                                                     paged_attention_chunk)
    from repro_torch.kvstore.pool import PagedKV
    from repro_torch.shard import partition
    gen = torch.Generator(device=dev).manual_seed(26)
    unequal, times = [], {}
    for name, n_out, n_in in PROJECTIONS:
        w = torch.randn((n_out, n_in), generator=gen, device=dev) * \
            n_in ** -0.5
        act = "silu" if name == "gate" else None
        bias = torch.randn((n_out,), generator=gen, device=dev) \
            if name == "wq" else None
        for mode in ("aida", "int8", "codebook4"):
            leaf = sfc.compress(w, mode=mode, density=0.25)
            split = partition.row_axis_len(leaf)
            for rows in (4, 32):
                x = torch.randn((rows, n_in), generator=gen, device=dev)
                kern = _k1_variant(rows) if mode == "aida" else \
                    {"int8": "int8_matmul", "codebook4": "lut_matmul"}[mode]
                whole = sfc.apply_fc(leaf, x, bias=bias, activation=act)
                t_whole, _ = median_ms(lambda: sfc.apply_fc(
                    leaf, x, bias=bias, activation=act), flush=flush)
                for tp in MESH_TP:
                    bands = [partition.local_view(leaf, tp, r)
                             for r in range(tp)]
                    n = sfc.stored_rows(bands[0])
                    outs = [sfc.apply_fc(b, x, bias=_band_bias(
                        bias, n, tp, r), activation=act, split=split)
                        for r, b in enumerate(bands)]
                    got = torch.cat(outs, dim=1)[:, :n_out]
                    if not torch.equal(got, whole):
                        unequal.append(f"{kern} {name} rows {rows} tp {tp}")
                    b0 = _band_bias(bias, n, tp, 0)
                    t_band, _ = median_ms(lambda: sfc.apply_fc(
                        bands[0], x, bias=b0, activation=act, split=split),
                        flush=flush)
                    key = (kern, rows, tp)
                    whole_ms, band_ms = times.get(key, (0.0, 0.0))
                    times[key] = (whole_ms + t_whole, band_ms + t_band)
                    del bands, outs
            del leaf
        del w
    for (kern, rows, tp), (t_whole, t_band) in sorted(times.items()):
        log(f"mesh band {kern} one layer (7 projections) rows={rows} "
            f"tp={tp}: whole_ms={t_whole:.4f} band_ms={t_band:.4f} "
            f"(x{t_whole / t_band:.2f})")
    for ctx in MESH_CONTEXTS:
        q1, pool, table, cur = _k2_inputs(dev, gen, ctx, "bf16")
        q8, _, _, q_pos = _k3_inputs(dev, gen, ctx, "bf16", 8)
        scale = 128 ** -0.5
        hkv, g = pool.k_pages.shape[1], q1.shape[1] // pool.k_pages.shape[1]
        for kern, fn, q, pos in (
                ("paged_attention_decode", paged_attention, q1, cur),
                ("paged_attention_chunk", paged_attention_chunk, q8,
                 q_pos)):
            whole = fn(q, pool, table, pos, -1, scale=scale)
            t_whole, _ = median_ms(lambda: fn(q, pool, table, pos, -1,
                                              scale=scale), flush=flush)
            for tp in MESH_TP:
                hl = hkv // tp
                parts = []
                for r in range(tp):
                    band = PagedKV(*(a[:, r * hl:(r + 1) * hl].contiguous()
                                     for a in pool[:2]))
                    qb = q[:, r * hl * g:(r + 1) * hl * g].contiguous()
                    parts.append((qb, band))
                got = torch.cat([fn(qb, band, table, pos, -1, scale=scale)
                                 for qb, band in parts], dim=1)
                if not torch.equal(got, whole):
                    unequal.append(f"{kern} ctx {ctx} tp {tp}")
                qb, band = parts[0]
                t_band, _ = median_ms(lambda: fn(qb, band, table, pos, -1,
                                                 scale=scale), flush=flush)
                log(f"mesh band {kern} ctx={ctx} tp={tp} (Hkv {hkv}, "
                    f"{hl} a rank): whole_ms={t_whole:.4f} "
                    f"band_ms={t_band:.4f}")
    log("mesh bands with the whole's split, concatenated vs the whole "
        "launch: " + ("all bit-identical" if not unequal
                      else "; ".join(unequal)))
    if unequal:
        raise AssertionError("mesh: bands differ from the whole launch: "
                             + "; ".join(unequal))


def _mesh_serve(eng, mesh, chunk=8):
    """Serve `_requests` on ``eng`` (over ``mesh`` when given): (results,
    session, the logits row each token was drawn from, by rid)."""
    import torch
    sess = eng.session(batch_slots=4, max_len=256, mesh=mesh,
                       scheduler={"chunk": chunk})
    rows = {}
    emit = sess._emit

    def keep(i, logits_i, now):
        rows.setdefault(sess.slot_entry[i].req.rid, []).append(
            torch.from_numpy(logits_i.copy()))
        emit(i, logits_i, now)
    sess._emit = keep
    for r in _requests(eng.cfg):
        sess.submit(r)
    res = sess.run()
    return res, sess, {k: torch.stack(v) for k, v in rows.items()}


def _same_serve(a, b):
    """Tokens and every logits row bit for bit."""
    import torch
    return [r.tokens for r in a[0]] == [r.tokens for r in b[0]] and \
        a[2].keys() == b[2].keys() and \
        all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def _mesh_one_rank(rank, layers):
    """A mesh of one rank over nccl: its collectives, and its serve against
    the plain session's on the same engine."""
    import torch
    _log_pretune()
    from repro_torch import CompressionSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.shard import comm
    mesh = make_host_mesh(1, backend="nccl")
    x = torch.arange(12., device=mesh.device).reshape(3, 4)
    collectives = torch.equal(comm.all_gather_cat(x, None), x) and \
        torch.equal(comm.all_reduce_sum(x, None), x) and \
        comm.all_equal(x)
    eng = _compressed_engine(mesh.device, _llama(layers),
                             CompressionSpec(mode="aida", density=0.25),
                             "mesh of one")
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    got = _mesh_serve(eng, mesh)
    counts = {k: f.launches for k, f in fns.items()}
    plain = _mesh_serve(eng, None)
    return {"collectives": collectives, "equal": _same_serve(got, plain),
            "launches": counts, "backend": mesh.backend,
            "device": str(mesh.device)}


def _mesh_pair_rank(rank, layers):
    """One of two ranks sharing the card over gloo: the full-width serve
    (counted, then again with the gathers timed), and on rank 0 the plain
    session's serve on the same engine to hold it against."""
    import torch
    _log_pretune()
    from repro_torch import CompressionSpec, Request
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.shard import comm, partition
    mesh = make_host_mesh(2, backend="gloo", device="cuda:0")
    dev = mesh.device
    eng = _compressed_engine(dev, _llama(layers), CompressionSpec(
        mode="aida", density=0.25), f"mesh rank {rank}")
    warm = eng.session(batch_slots=4, max_len=256, mesh=mesh,
                       scheduler={"chunk": 8})
    warm.submit(Request(prompt=[1, 2, 3], max_new=2, rid=0))
    warm.run()
    band = warm.params["layers"]["mlp"]["up"]
    share = (partition.band_bytes(band),
             partition.band_bytes(eng.params["layers"]["mlp"]["up"]))
    del warm
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    comm.reset_stats()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = _mesh_serve(eng, mesh)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    gathers = comm.STATS["gathers"]
    comm.reset_stats(timed=True)
    timed = _mesh_serve(eng, mesh)
    gather_s = comm.STATS["seconds"]
    comm.reset_stats()
    out = {"steps": got[1].stats["steps"],
           "prefill_steps": got[1].stats["prefill_steps"], "seconds": dt,
           "launches": counts, "gathers": gathers, "gather_s": gather_s,
           "tokens": [r.tokens for r in got[0]],
           "repeat": _same_serve(got, timed), "band_bytes": share,
           "nonfinite": got[1].stats["nonfinite_logit_rows"],
           "leaked": got[1].alloc.in_use}
    if rank == 0:
        out["equal"] = _same_serve(got, _mesh_serve(eng, None))
    return out


def mesh_serve_phase(dev):
    """Tensor-parallel serving on the card, each rank its own process
    (`shard.comm.spawn`, loading the libraries the build made): a mesh of
    one over nccl, its serve bit for bit the plain session's; then two
    ranks sharing the card over gloo, llama3-8b at full width cut to
    MESH_LAYERS layers, aida 0.25, chunk 8: rank 0's tokens and every
    logits row bit for bit the single-device serve's, both ranks the same
    tokens, every rank's launch counts as the layers and steps say, no
    page leaked.  Returns the launches of both serves (every rank's)."""
    import torch
    from repro_torch.shard import comm
    torch.cuda.empty_cache()
    one = comm.spawn(1, _mesh_one_rank, (MESH_ONE_LAYERS,),
                     backend="nccl", timeout=300)[0]
    log(f"mesh of one over {one['backend']} on {one['device']}: "
        f"collectives {'exact' if one['collectives'] else 'WRONG'}, serve "
        f"{'bit-identical to' if one['equal'] else 'DIFFERS from'} the "
        f"plain session's")
    if not (one["collectives"] and one["equal"]):
        raise AssertionError("mesh of one: its collectives or its serve "
                             "differ")
    pair = comm.spawn(2, _mesh_pair_rank, (MESH_LAYERS,), backend="gloo",
                      timeout=600)
    r0 = pair[0]
    steps, pre = r0["steps"], r0["prefill_steps"]
    per = {k: sum(r["launches"][k] for r in pair) / steps
           for k in r0["launches"] if r0["launches"][k]}
    band, whole = r0["band_bytes"]
    log(f"mesh 2 ranks on one card over gloo: llama3-8b {MESH_LAYERS} "
        f"layers aida chunk 8: {steps} steps ({pre} chunked), "
        f"{r0['seconds'] * 1e3 / steps:.2f} ms/step, "
        f"{sum(per.values()):.1f} K1-K3 launches/step over both ranks "
        f"({json.dumps({k: round(v, 2) for k, v in per.items()})}), "
        f"{r0['gathers'] / steps:.1f} gathers/step, gather "
        f"{r0['gather_s'] * 1e3 / steps:.2f} ms/step (host clock, the card "
        f"synchronised around each gather, in a second serve), a rank's "
        f"mlp.up band {band / whole:.3f} of the whole's bytes")
    agree = pair[1]["tokens"] == r0["tokens"]
    log(f"mesh 2 ranks: rank 0 vs the single-device serve: "
        f"{'tokens and logits bit-identical' if r0['equal'] else 'DIFFER'};"
        f" ranks' tokens {'equal' if agree else 'DIFFER'}; tokens "
        f"{json.dumps(r0['tokens'])}")
    n_fc = 7 * MESH_LAYERS
    want = {"acsr_spmv_gather": n_fc * (steps - pre),
            "acsr_spmv_wide": n_fc * pre,
            "paged_attention_decode": MESH_LAYERS * (steps - pre),
            "paged_attention_chunk": MESH_LAYERS * pre}
    bad = [r for r in pair if {k: v for k, v in r["launches"].items()
                               if v} != want]
    if not r0["equal"] or not agree or bad or \
            not all(r["repeat"] for r in pair) or \
            any(r["nonfinite"] or r["leaked"] for r in pair):
        raise AssertionError(f"mesh 2 ranks: the serve differs from the "
                             f"single device's, between ranks or runs, "
                             f"leaked, or its launches {r0['launches']} "
                             f"are not {want}")
    return {k: one["launches"][k] + sum(r["launches"][k] for r in pair)
            for k in one["launches"]}


# ---------------------------------------------------- engine benchmarks
BENCH_MODES = ("dense", "int8", "codebook4", "acsr", "aida")
#: llama3-8b at full width, cut to this depth as the mesh phase cuts it
BENCH_LAYERS = 4
#: summarize()'s fields counted in requests, tokens, steps and ticks
BENCH_STEP_FIELDS = ("requests", "completed", "tokens", "steps",
                     "ttft_sched", "queue_wait_sched", "first_token_calls",
                     "preemptions", "prefix_pages_reused", "outcomes")


@contextlib.contextmanager
def _served_streams():
    """Every session run inside the block (plain and disaggregated), in
    order: its results and, where nothing was preempted, each request's
    top-2 margins of this run (a preempted request emits again what it
    had emitted, so its margins would not line up with its tokens)."""
    from repro_torch.api.session import Session
    from repro_torch.disagg.session import DisaggSession
    runs, saved = [], {}

    def preempted(sess):
        if isinstance(sess, DisaggSession):
            return sess.pre.stats["preemptions"] + \
                sess.dec.stats["preemptions"]
        return sess.stats["preemptions"]

    for cls in (Session, DisaggSession):
        saved[cls] = cls.run_workload

        def wrapped(self, arrivals, *a, _inner=saved[cls], **kw):
            before = {rid: len(m) for rid, m in self.margins.items()}
            res = _inner(self, arrivals, *a, **kw)
            margins = None if preempted(self) else {
                rid: m[before.get(rid, 0):]
                for rid, m in self.margins.items()}
            runs.append((list(res), margins))
            return res
        cls.run_workload = wrapped
    try:
        yield runs
    finally:
        for cls, fn in saved.items():
            cls.run_workload = fn


def _bench_facts(out):
    """The deterministic facts of an `Engine.benchmark` dict: token, step,
    tick, page, handoff and counter facts, compression ratios, the
    capacity section whole and the cost-model backends."""
    facts = {"backends": out["backends"],
             "modes": {m: {k: r[k] for k in ("backend", "tokens",
                                             "compression_ratio")}
                       for m, r in out["modes"].items()}}
    kv = out["kv"]
    facts["kv"] = {"kv_bytes_per_token": kv["kv_bytes_per_token"],
                   "full_tokens": kv["full"]["tokens"],
                   **{k: kv["paged"][k] for k in ("tokens", "pages_peak",
                                                  "page_allocs")}}
    sv = out["serving"]
    facts["serving"] = {
        "prefill": {k: (v["first_token_calls"] if isinstance(v, dict)
                        else v) for k, v in sv["prefill"].items()},
        "throughput": {k: sv["throughput"][k] for k in BENCH_STEP_FIELDS},
        "prefix": sv["prefix"], "preemption": sv["preemption"]}
    dg = out["disagg"]
    facts["disagg"] = {
        "token_parity": dg["token_parity"],
        "roles": dg["disagg"]["roles"],
        "handoff": {k: dg["disagg"]["handoff"][k]
                    for k in ("count", "latency_ticks", "migrated_pages",
                              "migrated_bytes")},
        **{label: {k: dg[label][k]
                   for k in BENCH_STEP_FIELDS + ("pages_leaked",)}
           for label in ("colocated", "disagg")}}
    rs = out["resil"]
    facts["resil"] = {
        "clean": {k: rs["clean"][k] for k in ("completed", "pages_leaked")},
        **{p: {k: v for k, v in r.items() if k != "goodput_vs_clean"}
           for p, r in rs["presets"].items()}}
    facts["capacity"] = out["capacity"]
    return facts


def _first_difference(a, b, path=""):
    """The key path of the first place two JSON-like values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}/{k}"
            d = _first_difference(a[k], b[k], f"{path}/{k}")
            if d is not None:
                return d
        return None
    return None if a == b else path or "/"


class _Tallied:
    """A kernel wrapper standing in for itself: each call goes to the
    wrapper, and the launches it adds to the wrapper's count (read around
    the call, outside the tuner's ``counted_apart``) are tallied by the
    shape ``key`` gives the call's arguments.  ``launches`` is the
    wrapper's own count, so the tuner's bookkeeping reads it through."""

    def __init__(self, fn, key, tally, apart):
        self.fn, self.key, self.tally, self.apart = fn, key, tally, apart

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *a, **kw):
        n = self.fn.launches
        out = self.fn(*a, **kw)
        if self.fn.launches > n and not self.apart[0]:
            k = self.key(*a, **kw)
            self.tally[k] = self.tally.get(k, 0) + self.fn.launches - n
        return out


@contextlib.contextmanager
def _launch_shapes():
    """K1-K5's launches inside the block by the shape each got, as the
    kernels line lists shapes: K1's variants by x's columns, K4 / K5 by
    x's rows, K2 by (page size, table width in keys, KV dtype), K3 by
    (page size, table width, chunk, KV dtype); the tuner's own launches
    are left out, as the launch counts leave them out."""
    import torch
    from repro_torch import kvstore as kvs
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import tune

    def pages(pool, table, *chunk):
        ps = pool.k_pages.shape[2]
        kind = "int8" if pool.k_pages.dtype == torch.int8 else "bf16"
        return (ps, table.shape[1] * ps, *chunk, kind)
    apart, tally = [0], {}
    sites = {  # (module, attribute, kernels line name, shape of a call)
        "acsr_spmv_gather": (sp, "spmv_gather", lambda b, x, *a, **k:
                             x.shape[1]),
        "acsr_spmv_wide": (sp, "spmv_wide", lambda b, x, *a, **k:
                           x.shape[1]),
        "int8_matmul": (i8, "int8_matmul", lambda x, *a, **k: x.shape[0]),
        "lut_matmul": (lm, "lut_matmul", lambda x, *a, **k: x.shape[0]),
        "paged_attention_decode": (kvs, "paged_attention",
                                   lambda q, pool, table, *a, **k:
                                   pages(pool, table)),
        "paged_attention_chunk": (kvs, "paged_attention_chunk",
                                  lambda q, pool, table, *a, **k:
                                  pages(pool, table, q.shape[2]))}
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in sites.items()}
    apart_fn = tune.counted_apart

    @contextlib.contextmanager
    def counted_apart():
        apart[0] += 1
        try:
            with apart_fn():
                yield
        finally:
            apart[0] -= 1
    for name, (mod, attr, key) in sites.items():
        setattr(mod, attr, _Tallied(saved[name], key,
                                    tally.setdefault(name, {}), apart))
    tune.counted_apart = counted_apart
    try:
        yield tally
    finally:
        tune.counted_apart = apart_fn
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, saved[name])


@contextlib.contextmanager
def _inner_footprints(dev):
    """Every `Engine._inner` inside the block (a mode's or a section's
    compressed engine) measured on the card: the bytes it leaves
    allocated (its copy of the weights) and the peak above them while it
    is made (the compressor's scratch).  Yields a dict of ``copies`` and
    ``scratch`` (bytes, one an engine) and ``peak`` (the block's peak
    allocation, read as it ends)."""
    import torch
    from repro_torch.api.engine import Engine
    made = Engine._inner
    seen = {"copies": [], "scratch": [], "peak": 0}

    def inner(self, *a, **kw):
        torch.cuda.synchronize(dev)
        seen["peak"] = max(seen["peak"],
                           torch.cuda.max_memory_allocated(dev))
        m0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        eng = made(self, *a, **kw)
        torch.cuda.synchronize(dev)
        m1 = torch.cuda.memory_allocated(dev)
        seen["copies"].append(m1 - m0)
        seen["scratch"].append(torch.cuda.max_memory_allocated(dev) - m1)
        return eng
    Engine._inner = inner
    try:
        yield seen
    finally:
        Engine._inner = made
        torch.cuda.synchronize(dev)
        seen["peak"] = max(seen["peak"],
                           torch.cuda.max_memory_allocated(dev))


def _bench_counted(dev, eng, label, by_shape=False):
    """``eng.benchmark(modes=BENCH_MODES)``, every launch count set to 0
    just before and read just after, and every session's results and
    margins recorded.  Returns (the benchmark dict, the launches, the
    runs, seconds, and with ``by_shape`` K1-K5's launches by shape,
    which must add up to the launches)."""
    import torch
    fns = _launch_counters()
    for f in fns.values():
        f.launches = 0
    with _served_streams() as runs, (
            _launch_shapes() if by_shape else contextlib.nullcontext()) \
            as shapes:
        t0 = time.perf_counter()
        out = eng.benchmark(modes=BENCH_MODES)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    log(f"{label}: Engine.benchmark in {dt:.1f} s, {len(runs)} session "
        f"runs, launches {json.dumps({k: v for k, v in counts.items() if v})}")
    if by_shape:
        log(f"{label}: launches by shape " + json.dumps(
            {k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}))
        off = {k: (sum(v.values()), counts[k]) for k, v in shapes.items()
               if sum(v.values()) != counts[k]}
        if off:
            raise AssertionError(f"{label}: launches by shape do not add up "
                                 f"to the launch counts: {off}")
    return out, counts, runs, dt, shapes


def _log_bench(out, label):
    """The numbers of one benchmark dict, on a few lines."""
    for mode, r in out["modes"].items():
        log(f"{label} mode {mode} [{r['backend']}]: {r['tokens']} tokens, "
            f"{r['tok_per_s']:.2f} tok/s, ratio {r['compression_ratio']}, "
            f"new winners {len(r['tiles'])}")
    kv = out["kv"]
    sh = kv["attn_time_share"]
    log(f"{label} kv: full {kv['full']['tok_per_s']:.2f} vs paged "
        f"{kv['paged']['tok_per_s']:.2f} tok/s (x{kv['paged_over_full']}), "
        f"pages peak {kv['paged']['pages_peak']}, allocs "
        f"{kv['paged']['page_allocs']}, new winners "
        f"{len(kv['paged']['tiles'])}; bytes/token "
        f"{json.dumps(kv['kv_bytes_per_token'])}; attention "
        f"{sh['attn_us_full']} us full / {sh['attn_us_paged']} us paged, "
        f"FC {sh['fc_us']} us, share full {sh['full']} / paged "
        f"{sh['paged']}")
    sv = out["serving"]
    pf, th = sv["prefill"], sv["throughput"]
    log(f"{label} serving: prefill {pf['prompt_len']} tokens in "
        f"{pf['chunked']['first_token_calls']} calls (bound "
        f"{pf['bound_calls']}, one token at a time "
        f"{pf['one_token']['first_token_calls']}), TTFT "
        f"{pf['chunked']['ttft_s']} vs {pf['one_token']['ttft_s']} s; "
        f"heterogeneous {th['tok_per_s']} tok/s, {th['steps']} steps, TTFT "
        f"p50 / p99 {_ms(th['ttft_s'])} ms, TPOT {_ms(th['tpot_s'])} ms; "
        f"prefix hits {sv['prefix']['page_hits']}, preemptions "
        f"{sv['preemption']['preemptions']}, new winners {len(sv['tiles'])}")
    dg = out["disagg"]
    for side in ("colocated", "disagg"):
        s = dg[side]
        log(f"{label} disagg {side}: {s['tok_per_s']} tok/s, {s['steps']} "
            f"steps, TTFT p50 / p99 {_ms(s['ttft_s'])} ms, TPOT "
            f"{_ms(s['tpot_s'])} ms")
    log(f"{label} disagg: token parity {dg['token_parity']}, handoffs "
        f"{dg['disagg']['handoff']['count']}, "
        f"{dg['disagg']['handoff']['migrated_bytes']} bytes migrated")
    rs = out["resil"]
    log(f"{label} resil: clean {rs['clean']['tok_per_s']} tok/s; " + "; ".join(
        f"{p} goodput x{r['goodput_vs_clean']} deterministic "
        f"{r['deterministic']} faults {json.dumps(r['counters']['faults'])}"
        for p, r in rs["presets"].items()))
    cap = out["capacity"]
    log(f"{label} capacity: chosen {cap['chosen']}, replay "
        f"{cap['deterministic_replay']}, " + "; ".join(
            f"{e['label']} pass {e['slo_pass']} span {e['span_ticks']} "
            f"ticks" for e in cap["sweep"]))
    log(f"{label} backends: {json.dumps(out['backends'])}")


def _bench_checks(out, cfg, label):
    """Every mode serves all its tokens; token parity and determinism hold;
    no page leaks anywhere; the capacity replay is byte for byte; the KV
    bytes / token are the closed form; the attention shares lie in (0,
    1)."""
    want = 4 * 8                      # benchmark()'s requests x max_new
    bad = []
    for mode, r in out["modes"].items():
        if r["tokens"] != want:
            bad.append(f"mode {mode} served {r['tokens']} of {want} tokens")
    if not out["disagg"]["token_parity"]:
        bad.append("disagg token parity")
    leaks = {"prefix": out["serving"]["prefix"]["pages_leaked"],
             "prefix_after_clear":
                 out["serving"]["prefix"]["pages_leaked_after_clear"],
             "preemption": out["serving"]["preemption"]["pages_leaked"],
             "colocated": out["disagg"]["colocated"]["pages_leaked"],
             "disagg": out["disagg"]["disagg"]["pages_leaked"],
             "resil clean": out["resil"]["clean"]["pages_leaked"]}
    for p, r in out["resil"]["presets"].items():
        leaks[f"resil {p}"] = r["pages_leaked"]
        if not r["deterministic"]:
            bad.append(f"resil {p} not deterministic")
        if r["completed"] != out["resil"]["requests"] or r["failed"]:
            bad.append(f"resil {p} completed {r['completed']}")
    bad += [f"{k} leaked {v} pages" for k, v in leaks.items() if v]
    if out["capacity"]["deterministic_replay"] is not True:
        bad.append("capacity replay")
    n, dh, L, ps = cfg.n_kv, cfg.head_dim, cfg.n_layers, 16
    paged, dense = (2 * n * dh + 2 * n * 4 / ps) * L, 2 * n * dh * 2 * L
    closed = {"paged_int8": round(paged, 1), "dense_bf16": round(dense, 1),
              "ratio": round(paged / dense, 4)}
    if out["kv"]["kv_bytes_per_token"] != closed:
        bad.append(f"kv bytes/token {out['kv']['kv_bytes_per_token']} vs "
                   f"{closed}")
    sh = out["kv"]["attn_time_share"]
    if not (0 < sh["full"] < 1 and 0 < sh["paged"] < 1):
        bad.append(f"attention shares {sh}")
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))


def bench_phase(dev):
    """The Engine's benchmark surface (`Engine.benchmark` over the five
    modes, with its kv, serving, disagg, resil and capacity sections and
    the cost-model backends).  (a) A reduced llama3-8b on the card and on
    the CPU from the same seed-0 weights: every deterministic fact equal,
    tokens equal up to near-tie flips, session by session.  (b) llama3-8b
    at full width, cut to BENCH_LAYERS layers, on the card: every mode
    serves all its tokens, token parity and determinism hold, nothing
    leaks, the capacity choice equals the CPU's in (a), the engine's raw
    weights come out unchanged, every mode's and section's engine is gone
    once it is done, and the peak allocation stays within the raw weights
    (and their clone for the check), one compressed copy and a step's
    scratch (or the compressor's).  Returns (b)'s launches, by kernel and
    by shape, and K2's and K3's times at (b)'s shapes ((a)'s launches are
    logged, not counted: its widths are not the model's)."""
    import dataclasses
    import gc

    import torch
    from repro_torch import Engine, Request, bridge, get, reduced
    cfg = reduced(get("llama3-8b"))
    cpu = Engine(cfg, device="cpu", seed=0)
    card = Engine(cfg, params=bridge.to_device(cpu.params, dev), device=dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # small CPU ops: more threads only contend
    try:
            ref, _, ref_runs, _, _ = _bench_counted(dev, cpu,
                                                "bench reduced cpu")
    finally:
        torch.set_num_threads(threads)
    got, small, got_runs, _, _ = _bench_counted(dev, card,
                                                "bench reduced cuda")
    del cpu, card
    _log_bench(got, "bench reduced cuda")
    diff = _first_difference(_bench_facts(ref), _bench_facts(got))
    if diff is not None:
        raise AssertionError(f"bench reduced: the card's facts differ from "
                             f"the CPU's at {diff}")
    if len(ref_runs) != len(got_runs):
        raise AssertionError(f"bench reduced: {len(got_runs)} session runs "
                             f"on the card, {len(ref_runs)} on the CPU")
    flips = compared = 0
    for i, ((r, margins), (g, _)) in enumerate(zip(ref_runs, got_runs)):
        if [x.rid for x in r] != [x.rid for x in g] or \
                [len(x.tokens) for x in r] != [len(x.tokens) for x in g]:
            raise AssertionError(f"bench reduced: run {i} served other "
                                 "requests on the card")
        if margins is not None:
            compared += 1
            flips += _near_tie_flips(r, margins, g, f"bench reduced run {i}")
    log(f"bench reduced: card facts equal the CPU's; tokens of {compared} "
        f"of {len(ref_runs)} session runs compared "
        f"({'identical' if not flips else f'{flips} near-tie flips'})")
    _bench_checks(got, cfg, "bench reduced cuda")
    full = dataclasses.replace(get("llama3-8b"), n_layers=BENCH_LAYERS)
    log(f"bench: llama3-8b at full width, depth cut: {BENCH_LAYERS} of 32 "
        "layers")
    torch.cuda.empty_cache()
    eng = Engine(full, device=dev, seed=0)
    raw = [t.clone() for t in _leaves(eng.params)]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)   # the raw weights, twice
    torch.cuda.reset_peak_memory_stats(dev)
    eng.serve([Request(prompt=[1, 2, 3], max_new=2)], batch_slots=2)
    torch.cuda.synchronize(dev)
    step = torch.cuda.max_memory_allocated(dev) - base
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    with _inner_footprints(dev) as foot:
        out, counts, _, _, shapes = _bench_counted(dev, eng,
                                                   "bench llama3-8b",
                                                   by_shape=True)
    gc.collect()
    torch.cuda.synchronize(dev)
    left = torch.cuda.memory_allocated(dev) - base
    room = max(max(c + step for c in foot["copies"]),
               max(c + x for c, x in zip(foot["copies"], foot["scratch"])))
    gib = 2 ** 30
    log(f"bench llama3-8b: peak {foot['peak'] / gib:.2f} GiB over "
        f"{base / gib:.2f} GiB of raw weights and their clone ("
        f"{sum(t.numel() * t.element_size() for t in raw) / gib:.2f} GiB "
        f"each); a serve's scratch on them {step / gib:.2f} GiB; the inner "
        "engines' copies " + ", ".join(f"{c / gib:.2f}" for c in
                                       foot["copies"])
        + " GiB, their compressors' scratch up to "
        f"{max(foot['scratch']) / gib:.2f} GiB; allowed above the raw "
        f"weights {room / gib:.2f} + 0.25 GiB; {left / 2 ** 20:.1f} MiB "
        "left allocated after the sections")
    if foot["peak"] - base > room + gib // 4:
        raise AssertionError(f"bench llama3-8b: peak {foot['peak'] / gib:.2f}"
                             f" GiB holds more than one compressed copy at a "
                             "time")
    if left > gib // 4:
        raise AssertionError(f"bench llama3-8b: {left / 2 ** 20:.1f} MiB "
                             "still allocated after the sections: an inner "
                             "engine or session outlived its section")
    if not all(torch.equal(a, b) for a, b in zip(raw, _leaves(eng.params))):
        raise AssertionError("bench llama3-8b: the engine's raw weights "
                             "changed under its sections")
    del eng, raw
    _log_bench(out, "bench llama3-8b")
    _bench_checks(out, full, "bench llama3-8b")
    if out["capacity"]["chosen"] != ref["capacity"]["chosen"]:
        raise AssertionError(f"bench llama3-8b: capacity chose "
                             f"{out['capacity']['chosen']}, the CPU "
                             f"{ref['capacity']['chosen']}")
    for name in ("acsr_spmv_gather", "acsr_spmv_wide",
                 "paged_attention_decode", "paged_attention_chunk",
                 "int8_matmul", "lut_matmul"):
        if not counts[name] or not small[name]:
            raise AssertionError(f"bench: {name} was not launched")
    json.dumps(out)
    # K2 and K3 timed at (b)'s shapes: a context of 37 (or a full table,
    # if narrower) in a table as wide as the sessions'
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    paged = {"paged_attention_decode": {
        (ps, width, kv): _time_k2(dev, gen, flush, min(37, width), width,
                                  f" bench ps={ps}", kv_dtype=kv, ps=ps)
        for ps, width, kv in shapes["paged_attention_decode"]}}
    paged["paged_attention_chunk"] = {}
    for ps, width, c, kv in shapes["paged_attention_chunk"]:
        if kv != "bf16":
            raise AssertionError("bench: K3 ran over int8 pages, which its "
                                 "timing does not cover")
        paged["paged_attention_chunk"][(ps, width, c, kv)] = _time_k3(
            dev, gen, flush, min(37, width), width, f" bench ps={ps}",
            chunk=c, ps=ps)
    del flush
    return counts, shapes, paged


def _by_shape(times, launches, key="rows"):
    """A kernel's numbers for the kernels line at each shape the main path
    gives it (an FC kernel's rows, per layer of seven projections; K7 /
    K8's head dims), beside that shape's launches, and at the top level
    their launch-weighted mean, so the shape that takes most of the
    kernel's time weighs most."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    shapes = [{key: m, "launches": launches.get(m, 0), **times[m]}
              for m in sorted(times)]
    n = sum(s["launches"] for s in shapes)
    top = {k: sum(s["launches"] * s[k] for s in shapes) / n for k in keys}
    top["bound_by"] = max(shapes, key=lambda s: s["launches"] *
                          s["bound_ms"])["bound_by"]
    return {**top, "shapes": shapes}


def _by_context(times, launches):
    """K2's or K3's numbers for the kernels line: at each timed context
    (``shapes``), and at the top level the serve's context (37), where the
    main path's launches all fall."""
    shapes = [{"ctx": ctx, "launches": launches if ctx == 37 else 0,
               **times[ctx]} for ctx in sorted(times)]
    return {**times[37], "shapes": shapes}


def _timed(name, fn, *args):
    """fn(*args), logging its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the served llama3-8b to this many layers")
    ap.add_argument("--time-gather", action="store_true",
                    help="only time K1's gather variant at 1, 4 and 8 "
                    "columns (no checks, no result line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_build = build.build_all()
    log(f"kernel build: {t_build:.2f} s ({len(build.SOURCES)} libraries)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    if args.time_gather:
        time_gather(dev, flush)
        log(smi)
        return 0
    errs, times = {}, {}
    k1_errs, k1_times, k1_models = _timed("K1", k1_phase, dev, flush)
    errs.update(k1_errs)
    times.update(k1_times)
    _timed("K6 kernels a call", k6_kernels_a_call, dev)
    model_times = {}
    for name, label, phase in (("paged_attention_decode", "K2", k2_phase),
                               ("paged_attention_chunk", "K3", k3_phase)):
        errs[name], times[name], model_times[name] = _timed(label, phase,
                                                            dev, flush)
    fc_errs, fc_times = _timed("K4/K5", fc_phase, dev, flush)
    _timed("tune", tune_phase, dev, flush)
    _timed("mesh bands", mesh_band_phase, dev, flush)
    for mode, name in (("int8", "int8_matmul"), ("codebook4", "lut_matmul")):
        errs[name] = fc_errs[mode]
        times[name] = {m: fc_times[(mode, m)] for m in FC_ROWS}
    flash_errs, flash_rows = _timed("K7/K8", flash_phase, dev, flush)
    times.update(flash_rows)
    errs["flash_attention_fwd"] = max(flash_errs["o"], flash_errs["lse"])
    errs["flash_attention_dq"] = flash_errs["dq"]
    errs["flash_attention_dkv"] = max(flash_errs["dk"], flash_errs["dv"])
    errs["rwkv6_scan"], times["rwkv6_scan"] = _timed("K9", k9_phase, dev,
                                                     flush)
    errs["lut_product_matmul"], times["lut_product_matmul"], k6_launches = \
        _timed("K6", k6_phase, dev, flush)
    del flush
    _timed("ap emulator", ap_emulator_phase, dev)
    layers = args.layers or 32
    _log_pretune()
    launches, by_rows, eng, paged1 = _timed("serve aida", serve_phase, dev,
                                            layers)
    slice_serves = [_timed("serve full cache", full_cache_phase, dev, eng,
                           paged1)]
    del paged1
    _timed("serve traffic", traffic_phase, dev, eng)
    disagg, wide = _timed("serve disagg", disagg_phase, dev, eng)
    from repro_torch.kernels import tune
    log("tune snapshot after phase 9: " + json.dumps(tune.snapshot()))
    slice_serves.append(disagg)   # its wide K1 runs at its own columns
    by_rows["acsr_spmv_wide"][wide] = disagg["acsr_spmv_wide"]
    del eng
    # the mesh's serves: K1 on row bands, K2 / K3 on head groups
    slice_serves.append(_timed("mesh serve", mesh_serve_phase, dev))
    by_rows.update(_timed("serve int8 / codebook4", fc_mode_serves, dev,
                          min(layers, FC_MODE_LAYERS)))
    launches["int8_matmul"] = sum(by_rows["int8_matmul"].values())
    launches["lut_matmul"] = sum(by_rows["lut_matmul"].values())
    family = _timed("serve families", serve_families_phase, dev)
    hymba = _timed("serve hymba", hymba_serve_phase, dev)
    # K1-K3 launches: phase 9's chunk-8 serve and this slice's serves (the
    # full cache, hymba paged and full, phi-3-vision at chunk 1 and 8)
    slice_serves += [hymba["paged"], hymba["full"],
                     *family["phi-3-vision-4.2b"].values()]
    k1_models["hymba-1.5b"]["launches"] = sum(
        hymba[kv]["acsr_spmv_gather"] for kv in hymba)
    phase9 = dict(launches)
    for name in ("acsr_spmv_gather", "acsr_spmv_wide",
                 "paged_attention_decode", "paged_attention_chunk"):
        launches[name] += sum(c[name] for c in slice_serves)
    model_launches = {
        ("paged_attention_decode", "hymba-1.5b"):
            hymba["paged"]["paged_attention_decode"],
        ("paged_attention_decode", "phi-3-vision-4.2b"): sum(
            c["paged_attention_decode"]
            for c in family["phi-3-vision-4.2b"].values()),
        ("paged_attention_chunk", "phi-3-vision-4.2b"):
            family["phi-3-vision-4.2b"][8]["paged_attention_chunk"]}
    train_counts = _timed("train", train_phase, dev, TRAIN_LAYERS)
    flash_launches = _timed("train families", train_families_phase, dev)
    flash_launches["flash_attention_fwd"]["hubert-xlarge"] += _timed(
        "hubert forward", hubert_forward_phase, dev)
    for name in FLASH:
        flash_launches[name]["llama3-8b"] = train_counts[name]
    # checkpoint / restart and data-parallel training: K7 / K8 again
    _timed("launcher restart", launcher_restart_phase, dev)
    for phase in (_timed("checkpoint restart", ckpt_restart_phase, dev),
                  _timed("dp train", dp_train_phase, dev)):
        for model, counts in phase.items():
            for name in FLASH:
                flash_launches[name][model] = \
                    flash_launches[name].get(model, 0) + counts[name]
    for name in FLASH:
        launches[name] = sum(flash_launches[name].values())
    _timed("cross-check", cross_check, dev)
    _timed("train cross-check", train_cross_check, dev)
    _timed("families cross-check", families_cross_check, dev)
    _timed("zoo cross-check", zoo_cross_check, dev)
    eng, launches["rwkv6_scan"] = _timed("rwkv6 forward",
                                         rwkv6_forward_phase, dev)
    k1_models["rwkv6-7b"]["launches"] = _timed(
        "rwkv6 serve", rwkv6_serve_phase, dev, eng)
    del eng
    _timed("rwkv6 cross-check", rwkv6_cross_check, dev)
    launches["lut_product_matmul"] = sum(k6_launches.values())
    # the Engine's benchmark surface: K1-K5 again, at full width
    bench, bench_shapes, bench_paged = _timed("engine benchmarks",
                                              bench_phase, dev)
    for name, n in bench.items():
        launches[name] += n
    for name in ("acsr_spmv_gather", "acsr_spmv_wide", "int8_matmul",
                 "lut_matmul"):
        for rows, n in bench_shapes[name].items():
            if rows not in times[name]:
                raise AssertionError(f"engine benchmarks: {name} ran at "
                                     f"{rows} columns or rows, which its "
                                     "timing does not cover")
            by_rows[name][rows] = by_rows[name].get(rows, 0) + n
    by_rows["lut_product_matmul"] = k6_launches
    kernels = []
    for name, source, replaces in KERNELS:
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{source}",
               "replaces": replaces, "launches": launches[name],
               "tune_launches": tune.launches.get(name, 0),
               "max_abs_err": errs[name]}
        if name in by_rows:   # FC kernels: per layer, at the main path's rows
            row.update(_by_shape(times[name], by_rows[name]))
        elif name.startswith("paged_"):   # K2, K3: by context
            row.update(_by_context(times[name], phase9[name]))
            row["shapes"] += [
                {"model": m, "ctx": ctx,
                 "launches": model_launches.get((name, m), 0)
                 if ctx == 37 else 0, **t}
                for (m, ctx), t in sorted(model_times[name].items())]
            row["shapes"] += [   # the engine benchmarks' pages and chunks
                {"model": "llama3-8b", "phase": "engine benchmarks",
                 "ps": key[0], "table_keys": key[1], "kv": key[-1],
                 **({"chunk": key[2]} if len(key) == 4 else {}),
                 "ctx": min(37, key[1]),
                 "launches": bench_shapes[name][key], **t}
                for key, t in sorted(bench_paged[name].items())]
        elif name in FLASH:               # K7, K8: by model
            row.update(_by_shape(times[name], flash_launches[name],
                                 "model"))
        else:
            row.update(times[name])
        if name == "acsr_spmv_gather":   # and per rwkv6-7b and hymba-1.5b
            for s in row["shapes"]:       # layer, 4 columns
                s["model"] = "llama3-8b"
            row["shapes"] += [{"rows": 4, "model": m, **t}
                              for m, t in k1_models.items()]
        kernels.append(row)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)                  # the card again, beside the numbers
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
