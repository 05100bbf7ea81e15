#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--layers N]

Phases, each of which exits non-zero when it fails:

1. build both CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   in parallel) and print the card (nvidia-smi name, power limit);
2. K1 (blocked-ACSR SpMV) against its plain version on the card at the
   seven llama3-8b projection geometries, batch 4, density 0.25;
3. K2 (paged-attention decode) against its plain version at B=4, H=32,
   Hkv=8, Dh=128, page 16, contexts 37 and 2048, bf16 and int8 pages,
   window -1 / 64, softcap none / 30, with -1 holes and an empty row;
4. kernel, plain-version and library times (CUDA events, median, L2
   flushed) beside the least time the card needs for the same bytes;
5. the main path: llama3-8b at full width, ``Engine.compress(aida 0.25)``
   then four requests served, with every launch counted;
6. a reduced llama3-8b served on the card and on the CPU gives the same
   greedy tokens (or differs only at a near-tie).

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA card; imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, f32 outside the tensor cores
PROJECTIONS = [                    # llama3-8b: (name, n_out, n_in)
    ("wq", 4096, 4096), ("wk", 1024, 4096), ("wv", 1024, 4096),
    ("wo", 4096, 4096), ("gate", 14336, 4096), ("up", 14336, 4096),
    ("down", 4096, 14336)]


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


def bound(bytes_, flops):
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_close(name, out, ref, rtol, atol):
    import torch
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=rtol, atol=atol) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    return err


# ------------------------------------------------------------------ K1
def k1_phase(dev, flush):
    import torch
    from repro_torch.core import sparse_fc as sfc
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(0)
    batch, max_err = 4, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "bound_by": "bytes"}
    cases = [(n, o, i, "aida") for n, o, i in PROJECTIONS] + \
        [("wo-acsr-f32", 4096, 4096, "acsr")]
    for name, n_out, n_in, mode in cases:
        w = torch.randn((n_out, n_in), generator=gen, device=dev) * \
            n_in ** -0.5
        layer = sfc.compress(w, mode=mode, density=0.25)
        b = layer.blocked
        if name == "wq":           # compression repeats bit for bit
            again = sfc.compress(w, mode=mode, density=0.25).blocked
            if not all(torch.equal(getattr(b, f), getattr(again, f)) for f
                       in ("values", "col_idx", "row_nnz", "centroids")):
                raise AssertionError("compressing the same matrix twice on "
                                     "the card gave different containers")
            del again
        x = torch.randn((n_in, batch), generator=gen, device=dev)
        act = "silu" if name == "gate" else None
        bias = torch.randn((n_out,), generator=gen, device=dev) \
            if name == "wq" else None
        out = sp.acsr_spmv(b, x, bias=bias, activation=act)
        rows = b.nblocks * b.block_rows
        pb = None if bias is None else \
            torch.nn.functional.pad(bias, (0, rows - n_out))
        plain = ref.blocked_acsr_spmv_ref(b.values, b.col_idx, b.row_nnz,
                                          x, b.centroids, pb, act)[:n_out]
        torch.cuda.synchronize()
        err = check_close(f"acsr_spmv {name}", out, plain, 1e-4, 1e-4)
        max_err = max(max_err, err)
        nnz = int(b.row_nnz.sum())
        vbytes = b.values.element_size()
        moved = nnz * (vbytes + b.col_idx.element_size()) + \
            b.row_nnz.numel() * 4 + x.numel() * 4 + n_out * batch * 4 + \
            (64 if b.centroids is not None else 0) + \
            (n_out * 4 if bias is not None else 0)
        bms, by = bound(moved, 2 * nnz * batch)
        w_lib = sfc.dense_equivalent(layer).T.contiguous().to(torch.bfloat16)
        x_lib = x.T.contiguous().to(torch.bfloat16)
        t_k, host = median_ms(lambda: sp.acsr_spmv(b, x, bias=bias,
                                                   activation=act),
                              flush=flush)
        t_p, _ = median_ms(lambda: ref.blocked_acsr_spmv_ref(
            b.values, b.col_idx, b.row_nnz, x, b.centroids, pb, act),
            iters=5, flush=flush)
        t_l, _ = median_ms(lambda: torch.matmul(x_lib, w_lib), flush=flush)
        log(f"K1 {name:12s} {n_out}x{n_in} rmax={b.rmax} nnz={nnz} "
            f"err={err:.2e} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={bms:.4f} ({by}) "
            f"host_enqueue_ms={host:.4f}")
        if mode == "aida":         # one layer's seven projections
            totals["ms"] += t_k
            totals["plain_ms"] += t_p
            totals["bound_ms"] += bms
            totals["library_ms"] += t_l
            totals["bound_by"] = by
        del w, layer, b, w_lib
    log(f"K1 one layer (7 projections, B=4): kernel_ms={totals['ms']:.4f} "
        f"plain_ms={totals['plain_ms']:.4f} "
        f"library_ms={totals['library_ms']:.4f} "
        f"bound_ms={totals['bound_ms']:.4f}")
    return max_err, totals


# ------------------------------------------------------------------ K2
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


def k2_phase(dev, flush):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kvstore.paged_attention import paged_attention
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err, scale = 0.0, 128 ** -0.5
    for ctx in (37, 2048):
        for kv_dtype in ("bf16", "int8"):
            q, pool, table, cur = _k2_inputs(dev, gen, ctx, kv_dtype)
            for window in (-1, 64):
                for cap in (None, 30.0):
                    out = paged_attention(q, pool, table, cur, window,
                                          scale=scale, cap=cap)
                    plain = ref.paged_attention_ref(q, *pool, table, cur,
                                                    window, scale, cap)
                    torch.cuda.synchronize()
                    err = check_close(
                        f"paged_attention ctx={ctx} {kv_dtype} "
                        f"window={window} cap={cap}", out, plain, 0, 1e-4)
                    max_err = max(max_err, err)
    log(f"K2 {2 * 2 * 2 * 2} cases agree, max abs err {max_err:.2e}")
    rows = {}
    for ctx, max_len in ((37, 256), (2048, 2048)):
        q, pool, table, cur = _k2_inputs(dev, gen, ctx, "bf16",
                                         max_len=max_len)
        _, hkv, ps, dh = pool.k_pages.shape
        b, h = q.shape[:2]
        live_pages = int(((table >= 0) & (
            torch.arange(table.shape[1], device=dev)[None, :]
            <= (cur[:, None] // ps))).sum())
        moved = 2 * live_pages * hkv * ps * dh * 2 + q.numel() * 2 + \
            b * h * dh * 4 + table.numel() * 4 + b * 4
        flops = 4 * (live_pages * ps) * (h // hkv) * hkv * dh
        bms, by = bound(moved, flops)
        t_k, host = median_ms(lambda: paged_attention(
            q, pool, table, cur, -1, scale=scale), flush=flush)
        t_p, _ = median_ms(lambda: ref.paged_attention_ref(
            q, *pool, table, cur, -1, scale, None), iters=5, flush=flush)
        safe = table.long().clamp(min=0)[:, : -(-ctx // ps)]
        kk = pool.k_pages[safe].permute(0, 2, 1, 3, 4).reshape(
            b, hkv, -1, dh)[:, :, :ctx].contiguous()
        vv = pool.v_pages[safe].permute(0, 2, 1, 3, 4).reshape(
            b, hkv, -1, dh)[:, :, :ctx].contiguous()
        qq = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        t_l, _ = median_ms(lambda: sdpa(qq, kk, vv, scale=scale,
                                        enable_gqa=True), flush=flush)
        log(f"K2 ctx={ctx} npp={table.shape[1]} live_pages={live_pages} "
            f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
            f"bound_ms={bms:.5f} ({by}) host_enqueue_ms={host:.4f}")
        rows[ctx] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bms,
                     "bound_by": by, "library_ms": t_l}
    return max_err, rows[37]


# --------------------------------------------------------------- serve
def serve_phase(dev, layers):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import CompressionSpec, Engine, Request, get
    from repro_torch.kernels.acsr_spmv import acsr_spmv
    from repro_torch.kvstore.paged_attention import paged_attention
    cfg = get("llama3-8b")
    if layers != cfg.n_layers:
        log(f"depth cut: {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev, seed=0)
    eng.params                                        # random init
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.compress(CompressionSpec(mode="aida", density=0.25))
    torch.cuda.synchronize(dev)
    t_comp = time.perf_counter() - t0
    peak_compress = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"serve: init {t_init:.2f} s, compress {t_comp:.2f} s, ratio "
        f"{eng.stats['ratio']:.3f} vs bf16, peak {peak_compress:.2f} GiB")
    warm = eng.session(batch_slots=4, max_len=256)   # cuBLAS, library load
    warm.submit(Request(prompt=[1, 2], max_new=2, rid=0))
    warm.run()
    rng = np.random.default_rng(0)
    lens = (5, 9, 16, 23)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_new=16, rid=i) for i, n in enumerate(lens)]
    sess = eng.session(batch_slots=4, max_len=256)
    for r in reqs:
        sess.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    acsr_spmv.launches = 0
    paged_attention.launches = 0
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    k1, k2 = acsr_spmv.launches, paged_attention.launches
    steps = sess.stats["steps"]
    n_tok = sum(len(r.tokens) for r in res)
    log(f"serve: {len(res)}/4 requests, {n_tok} tokens, {steps} steps, "
        f"{dt * 1e3 / steps:.2f} ms/step, {n_tok / dt:.2f} tok/s, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB "
        f"while serving")
    log(f"serve: launches acsr_spmv={k1} (7x{cfg.n_layers}x{steps}="
        f"{7 * cfg.n_layers * steps}), paged_attention={k2} "
        f"({cfg.n_layers}x{steps}={cfg.n_layers * steps})")
    log("serve: tokens " + json.dumps({r.rid: r.tokens for r in res}))
    if len(res) != 4 or any(len(r.tokens) != 16 for r in res):
        raise AssertionError("serve did not finish 4/4 requests")
    if k1 != 7 * cfg.n_layers * steps or k2 != cfg.n_layers * steps:
        raise AssertionError("the main path did not go through the kernels "
                             "on every projection and layer")
    if sess.stats["nonfinite_logit_rows"]:
        raise AssertionError("non-finite logits were emitted")
    if sess.alloc.in_use:
        raise AssertionError(f"{sess.alloc.in_use} pages leaked")
    trace_decode(eng, reqs)
    return k1, k2


def trace_decode(eng, reqs):
    """Device busy share and kernel time by family over a short serve of
    the same requests (4 new tokens each), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import Request
    sess = eng.session(batch_slots=4, max_len=256)
    for r in reqs:
        sess.submit(Request(prompt=list(r.prompt), max_new=4, rid=r.rid))
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
    fam = {"acsr_spmv": 0.0, "paged_attention": 0.0, "other": 0.0}
    for e in kernels:
        key = "acsr_spmv" if "spmv" in e.name else \
            "paged_attention" if "paged_" in e.name else "other"
        fam[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(fam.values())
    steps = sess.stats["steps"]
    log(f"trace: {steps} steps, wall {wall * 1e3 / steps:.2f} ms/step, "
        f"device busy {busy / steps:.3f} ms/step "
        f"({100 * busy / (wall * 1e3):.1f}% of wall), kernels "
        f"{len(kernels) / steps:.0f}/step; ms/step by family: " +
        ", ".join(f"{k} {v / steps:.3f}" for k, v in fam.items()))


def cross_check(dev):
    from repro_torch import CompressionSpec, Engine, Request, bridge, get
    from repro_torch import reduced
    cfg = reduced(get("llama3-8b"))
    cpu = Engine(cfg, device="cpu", seed=0).compress(
        CompressionSpec(mode="aida", density=0.25))
    gpu = Engine(cfg, params=bridge.to_device(cpu.params, dev), device=dev)
    out = {}
    for name, eng in (("cpu", cpu), ("cuda", gpu)):
        sess = eng.session(batch_slots=4, max_len=256)
        for i, n in enumerate((5, 9, 16, 23)):
            sess.submit(Request(prompt=[(7 * i + 3 * j) % cfg.vocab
                                        for j in range(n)],
                                max_new=16, rid=i))
        out[name] = (sess.run(), sess.margins)
    (ref, margins), (got, _) = out["cpu"], out["cuda"]
    flips = 0
    for r, g in zip(ref, got):
        for j, (a, b) in enumerate(zip(r.tokens, g.tokens)):
            if a != b:
                if margins[r.rid][j] >= 1e-2:
                    raise AssertionError(
                        f"cross-check: rid {r.rid} token {j} differs at "
                        f"top-2 margin {margins[r.rid][j]:.3g}")
                flips += 1
                break
    log(f"cross-check: reduced llama3-8b, cuda vs cpu greedy tokens: "
        f"{'identical' if not flips else f'{flips} near-tie flips'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the served llama3-8b to this many layers")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.acsr_spmv import acsr_spmv
    from repro_torch.kvstore.paged_attention import paged_attention
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
    log(f"kernel build: {t_build:.2f} s")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    k1_err, k1_t = k1_phase(dev, flush)
    k2_err, k2_t = k2_phase(dev, flush)
    del flush
    layers = args.layers or 32
    k1_n, k2_n = serve_phase(dev, layers)
    cross_check(dev)
    kernels = [
        {"name": "acsr_spmv", "route": "cuda",
         "source": "src/repro_torch/csrc/acsr_spmv.cu",
         "replaces": "src/repro/kernels/acsr_spmv.py:160",
         "launches": k1_n, "max_abs_err": k1_err, "ms": k1_t["ms"],
         "plain_ms": k1_t["plain_ms"], "bound_ms": k1_t["bound_ms"],
         "bound_by": k1_t["bound_by"], "library_ms": k1_t["library_ms"]},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kvstore/paged_attention.py:150",
         "launches": k2_n, "max_abs_err": k2_err, "ms": k2_t["ms"],
         "plain_ms": k2_t["plain_ms"], "bound_ms": k2_t["bound_ms"],
         "bound_by": k2_t["bound_by"], "library_ms": k2_t["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
