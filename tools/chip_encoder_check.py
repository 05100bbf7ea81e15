#!/usr/bin/env python3
"""Card checks of the encoder's and rms_norm's exact arithmetic.

    python3 tools/chip_encoder_check.py

1. ``compress_params`` against the encoder's earlier arithmetic, kept
   here as the reference: pruning by ``torch.kthvalue``, cluster counts
   by ``torch.bincount`` and nearest-centroid codes by a distance to every
   centroid.  For llama3-8b (aida, 4 layers; codebook4, 2 layers),
   rwkv6-7b (aida, 2 layers), hymba-1.5b (aida, 4 layers) and
   qwen1.5-0.5b (aida, 2 layers) at full width, random weights from seed
   0, every leaf of the two results must be ``torch.equal``; each side's
   seconds are printed.
2. ``models.layers._mean_square`` (rms_norm's sum of squares on the card)
   against torch's one-pass mean: each row's value at row counts 1-256
   against the same rows in a 512-row call, at six widths; the port's
   order must give every row the same bits at every count.

Exits non-zero on any difference.  Needs a CUDA card.
"""
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

CASES = (("llama3-8b", 4, "aida"), ("llama3-8b", 2, "codebook4"),
         ("rwkv6-7b", 2, "aida"), ("hymba-1.5b", 4, "aida"),
         ("qwen1.5-0.5b", 2, "aida"))
WIDTHS = (896, 1600, 2048, 2304, 3072, 4096)
ROWS = (1, 2, 3, 4, 5, 8, 12, 16, 24, 32, 48, 64, 128, 256)


def old_prune(dense, density):
    import torch
    k = max(1, int(round(density * dense.numel())))
    mag = dense.abs()
    thresh = torch.kthvalue(mag.reshape(-1), dense.numel() - k + 1).values
    return dense * (mag >= thresh)


def old_assign(x, centroids):
    import torch
    from repro_torch.core import codebook as cb
    flat = x.reshape(-1).float()
    cents = centroids.float()
    codes = torch.empty(flat.shape, dtype=torch.uint8, device=flat.device)
    for i in range(0, flat.numel(), cb.ASSIGN_CHUNK):
        part = flat[i:i + cb.ASSIGN_CHUNK]
        codes[i:i + cb.ASSIGN_CHUNK] = (part[:, None] - cents[None, :]) \
            .abs().argmin(dim=1).to(torch.uint8)
    return codes.reshape(x.shape)


def old_kmeans(x, k=16, iters=25):
    import torch
    xs = torch.sort(x.reshape(-1).float()).values
    prefix = torch.cat([xs.new_zeros(1, dtype=torch.float64),
                        torch.cumsum(xs.double(), 0)])
    lo, hi = xs[0], xs[-1]
    cents = lo + (hi - lo) * (torch.arange(k, dtype=torch.float32,
                                           device=xs.device) + 0.5) / k
    for _ in range(iters):
        cnts = torch.bincount(old_assign(xs, cents).long(), minlength=k)
        ends = torch.cumsum(cnts, 0)
        sums = prefix[ends] - prefix[ends - cnts]
        cents = torch.where(cnts > 0, (sums / torch.clamp(cnts, min=1))
                            .float(), cents)
    return torch.sort(cents).values


def _same(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def check_compress(dev) -> bool:
    import torch
    from repro_torch import get
    from repro_torch.api import compress as cm
    from repro_torch.api.spec import CompressionSpec
    from repro_torch.core import acsr as acsr_mod
    from repro_torch.core import codebook as cb
    from repro_torch.kernels import acsr_spmv as sp
    from repro_torch.models import transformer as tfm
    new = (acsr_mod.prune_topk, cb.kmeans_1d, cb.assign)

    def use(old):
        acsr_mod.prune_topk = old_prune if old else new[0]
        cb.kmeans_1d = old_kmeans if old else new[1]
        cb.assign = sp.assign = old_assign if old else new[2]
    ok = True
    for arch, layers, mode in CASES:
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = {"layers": tfm.stack_init(cfg, gen)}
        out, secs = {}, {}
        for old in (True, False):
            use(old)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                out[old] = dict(_leaves(cm.compress_params(
                    params, CompressionSpec(mode=mode, density=0.25),
                    verbose=None)[0]))
            torch.cuda.synchronize(dev)
            secs[old] = time.perf_counter() - t0
        use(False)
        bad = [p for p in out[True] if not _same(out[True][p],
                                                 out[False][p])]
        ok = ok and not bad
        print(f"compress {arch} {layers} layers {mode}: earlier arithmetic "
              f"{secs[True]:.2f} s, now {secs[False]:.2f} s; "
              f"{len(out[True])} leaves "
              + ("all torch.equal" if not bad else f"DIFFER at {bad}"),
              flush=True)
    return ok


def check_norm(dev) -> bool:
    import torch
    from repro_torch.models.layers import _mean_square
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for d in WIDTHS:
        x = torch.randn((512, d), generator=gen, device=dev).to(
            torch.bfloat16).float() * 3
        for name, f in (("torch mean", lambda t: (t * t).mean(
                dim=-1, keepdim=True)), ("_mean_square", _mean_square)):
            ref = f(x)
            bad = {n: int((f(x[:n].contiguous()) != ref[:n]).sum())
                   for n in ROWS}
            bad = {n: m for n, m in bad.items() if m}
            if name == "_mean_square":
                ok = ok and not bad
            print(f"D={d} {name}: rows whose bits differ from the 512-row "
                  f"call, by row count: {bad}", flush=True)
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_encoder_check: no CUDA device is visible",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    ok = check_norm(dev)
    ok = check_compress(dev) and ok
    print("chip_encoder_check: " + ("every check passed" if ok else
                                    "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
