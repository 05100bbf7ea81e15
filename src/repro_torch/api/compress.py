"""Model-level Deep-Compression: every eligible stacked projection in
``params["layers"]`` becomes a stacked CompressedFC (prune -> share ->
pack), with one slot depth across layers so a layer view of the stack is
a plain index.  MoE expert stacks ([L, E, d, f]) stay uncompressed, as in
the JAX package; they are kept as their bf16 serving copy."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.api.spec import CompressionSpec
from repro_torch.core import quant as q
from repro_torch.core import sparse_fc as sfc
from repro_torch.kernels import acsr_spmv as sp
from repro_torch.models import moe

# projection leaves eligible for compression (2D per layer, stacked to 3D)
TARGET_SUFFIXES = ("wq", "wk", "wv", "wo", "up", "down", "gate",
                   "wr", "wg", "in_proj", "out_proj")
SKIP_SUBSTR = ("ln", "mu", "bq", "bk", "bv", "conv", "A_log", "dt",
               "router", "x_db", "w_A", "w_B", "embed")


def _stack_compressed(per_layer: List[sfc.CompressedFC]) -> sfc.CompressedFC:
    """Stack per-layer CompressedFC into one [L, ...] container: int8 gives
    q [L, N, K] and scale [L, N, 1], codebook4 codes_packed [L, N, K/2]
    and centroids [L, 16]."""
    mode = per_layer[0].mode
    if mode in ("acsr", "aida"):
        # uniform slot depth across layers (padding slots are masked by
        # row_nnz, so values/cols just zero-pad); per-layer nnz may
        # differ, so the stack records nnz=-1
        rmax = max(c.blocked.rmax for c in per_layer)
        bs = [c.blocked for c in per_layer]

        def stk(arrs, pad_slots=True):
            if pad_slots:
                arrs = [torch.nn.functional.pad(
                    a, (0, 0, 0, rmax - a.shape[1])) for a in arrs]
            return torch.stack(arrs)

        b0 = bs[0]
        blocked = sp.BlockedACSR(
            values=stk([b.values for b in bs]),
            col_idx=stk([b.col_idx for b in bs]),
            row_nnz=stk([b.row_nnz for b in bs], pad_slots=False),
            shape=b0.shape, block_rows=b0.block_rows, nnz=-1,
            centroids=(None if b0.centroids is None
                       else torch.stack([b.centroids for b in bs])),
            chunk_off=stk([b.chunk_off for b in bs], pad_slots=False))
        return sfc.CompressedFC(mode=mode, shape=per_layer[0].shape,
                                blocked=blocked)

    def stk(name):
        arrs = [getattr(c, name) for c in per_layer]
        return None if arrs[0] is None else torch.stack(arrs)

    qts = [c.qt for c in per_layer]
    return sfc.CompressedFC(
        mode=mode, shape=per_layer[0].shape, dense=stk("dense"),
        qt=None if qts[0] is None else q.QTensor(
            torch.stack([t.q for t in qts]),
            torch.stack([t.scale for t in qts])),
        codes_packed=stk("codes_packed"), centroids=stk("centroids"))


def _leaf_bytes(c: sfc.CompressedFC) -> int:
    arrs = [c.dense, c.codes_packed, c.centroids]
    if c.qt is not None:
        arrs += [c.qt.q, c.qt.scale]
    if c.blocked is not None:
        arrs += [c.blocked.values, c.blocked.col_idx, c.blocked.row_nnz,
                 c.blocked.centroids]
    return sum(a.numel() * a.element_size() for a in arrs if a is not None)


def compress_params(params: Dict, spec: CompressionSpec = None, *,
                    verbose=print) -> Tuple[Dict, Dict]:
    """Replace every eligible stacked projection in params['layers'] with a
    stacked CompressedFC per ``spec`` (a CompressionSpec, a mode string or
    None).  Returns (new_params, stats)."""
    spec = CompressionSpec.coerce(spec)
    stats = {"n_compressed": 0, "bytes_dense": 0, "bytes_compressed": 0,
             "modes": {}, "spec": spec}

    def transform(path: Tuple[str, ...], leaf):
        name, pstr = path[-1], "/".join(path)
        if not isinstance(leaf, torch.Tensor) or leaf.ndim != 3 \
                or not name.endswith(TARGET_SUFFIXES):
            return leaf
        if any(s in pstr for s in SKIP_SUBSTR):
            return leaf
        leaf_mode = spec.mode_for(pstr)
        if leaf_mode == "skip":
            return leaf
        per = [sfc.compress(leaf[i].T, mode=leaf_mode,
                            density=spec.density, k=spec.k,
                            block_rows=spec.block_rows,
                            kmeans_iters=spec.kmeans_iters, dtype=spec.dtype)
               for i in range(leaf.shape[0])]
        out = _stack_compressed(per)
        if spec.shards > 1:
            # shard-aware stacking: pad the partition axis now, so a plan
            # with tp == shards bands it as it is (padded rows are inert)
            from repro_torch.shard.partition import pad_leaf
            out = pad_leaf(out, spec.shards)
        n_layers = leaf.shape[0]
        stats["n_compressed"] += n_layers
        stats["modes"][leaf_mode] = stats["modes"].get(leaf_mode, 0) \
            + n_layers
        stats["bytes_dense"] += leaf.numel() * 2  # bf16-serving baseline
        stats["bytes_compressed"] += _leaf_bytes(out)
        if verbose:
            verbose(f"  compressed {pstr} {tuple(leaf.shape)} [{leaf_mode}]")
        return out

    def walk(tree, path):
        if path[-1:] == ("moe",):
            return moe.serving_copy(tree)
        if isinstance(tree, dict):
            return {kk: walk(v, path + (kk,)) for kk, v in tree.items()}
        return transform(path, tree)

    out = dict(params)
    out["layers"] = walk(params["layers"], ())
    stats["ratio"] = (stats["bytes_dense"]
                      / max(stats["bytes_compressed"], 1))
    return out, stats
