"""Production FC layer in its serving-compressed form.

The five modes of the JAX package: dense, int8 (symmetric per-channel,
K4), codebook4 (16 shared values, 4-bit codes, K5), acsr (unstructured
sparsity, K1) and aida (sparse + 4-bit codebook, the paper's full
configuration, K1 coded).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import acsr as acsr_mod
from repro_torch.core import codebook as cb
from repro_torch.core import quant as q
from repro_torch.kernels import acsr_spmv as sp
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import ref

MODES = ("dense", "int8", "codebook4", "acsr", "aida")


@dataclasses.dataclass
class CompressedFC:
    """One FC layer, y = x @ W.T, in a serving-compressed representation.

    ``dense`` is [n_out, n_in]; ``qt`` the int8 codes [n_out, n_in] and
    scales [n_out, 1]; ``codes_packed`` [n_out, n_in/2] uint8 with
    ``centroids`` [16]; ``blocked`` a BlockedACSR.  A stack over layers
    puts [L] in front of every array."""
    mode: str
    shape: tuple                      # (n_out, n_in)
    dense: Optional[torch.Tensor] = None
    qt: Optional[q.QTensor] = None
    codes_packed: Optional[torch.Tensor] = None
    centroids: Optional[torch.Tensor] = None
    blocked: Optional[sp.BlockedACSR] = None

    def layer(self, i: int) -> "CompressedFC":
        """View of layer ``i`` of a stacked container (no copy)."""
        def pick(a):
            return None if a is None else a[i]
        return dataclasses.replace(
            self, dense=pick(self.dense),
            qt=None if self.qt is None else q.QTensor(
                self.qt.q[i], self.qt.scale[i]),
            codes_packed=pick(self.codes_packed),
            centroids=pick(self.centroids),
            blocked=None if self.blocked is None else self.blocked.layer(i))


def compress(w: torch.Tensor, mode: str = "aida", density: float = 0.10,
             k: int = 16, block_rows: int = 128, kmeans_iters: int = 25,
             dtype: str = "f32") -> CompressedFC:
    """Offline Deep-Compression-style pipeline (prune -> share -> pack) of
    one [n_out, n_in] matrix, on its device.  ``dtype="bf16"`` stores acsr
    values in bfloat16."""
    w = w.float().contiguous()
    n_out, n_in = w.shape
    if mode == "dense":
        return CompressedFC("dense", (n_out, n_in), dense=w)
    if mode == "int8":
        return CompressedFC("int8", (n_out, n_in),
                            qt=q.quantize_int(w))
    if mode == "codebook4":
        cents, packed = cb.quantize(w, k=k, iters=kmeans_iters)
        return CompressedFC("codebook4", (n_out, n_in),
                            codes_packed=packed, centroids=cents)
    if mode == "acsr":
        pruned = acsr_mod.prune_topk(w, density)
        return CompressedFC("acsr", (n_out, n_in),
                            blocked=sp.block_encode(pruned, block_rows,
                                                    value_dtype=dtype))
    if mode == "aida":
        pruned = acsr_mod.prune_topk(w, density)
        nz = pruned[pruned != 0]
        cents = cb.kmeans_1d(nz, k=k - 1, iters=kmeans_iters)
        cents = torch.cat([cents.new_zeros(1), cents])
        return CompressedFC("aida", (n_out, n_in),
                            blocked=sp.block_encode_coded(pruned, cents,
                                                          block_rows))
    raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")


def apply_fc(layer: CompressedFC, x: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W.T + bias) for x [B, n_in] (or [n_in]); bias and
    activation ride in the kernel epilogue on the compressed paths.
    Returns f32 [B, layer.shape[0]]."""
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    if layer.mode == "dense":
        y = torch.matmul(x2, layer.dense.T)
        if bias is not None:
            y = y + bias.float()
        y = ref.apply_activation(activation, y)
    elif layer.mode == "int8":
        y = i8.int8_matmul(x2, layer.qt.q, layer.qt.scale, bias=bias,
                           activation=activation)
    elif layer.mode == "codebook4":
        y = lm.lut_matmul(x2, layer.codes_packed, layer.centroids,
                          bias=bias, activation=activation)
    elif layer.mode in ("acsr", "aida"):
        y = sp.acsr_spmv(layer.blocked, x2.T, bias=bias,
                         activation=activation).T
    else:
        raise ValueError(layer.mode)
    y = y[:, : layer.shape[0]]
    return y[0] if squeeze else y


def dense_equivalent(layer: CompressedFC) -> torch.Tensor:
    """Materialise the effective dense [n_out, n_in] f32 weights."""
    if layer.mode == "dense":
        return layer.dense.float()
    if layer.mode == "int8":
        return q.dequantize_int(layer.qt)
    if layer.mode == "codebook4":
        return layer.centroids.float()[cb.unpack4(layer.codes_packed).long()]
    if layer.mode in ("acsr", "aida"):
        b = layer.blocked
        vals = b.values.float()
        if b.centroids is not None:
            vals = b.centroids[b.values.long()]
        out = torch.zeros(layer.shape, dtype=torch.float32,
                          device=vals.device)
        live = (torch.arange(b.rmax, device=vals.device)[None, :, None]
                < b.row_nnz[:, None, :])
        blk, slot, lane = torch.nonzero(live, as_tuple=True)
        rows = blk * b.block_rows + lane
        inb = rows < layer.shape[0]
        cols = b.col_idx[blk, slot, lane].long()
        out[rows[inb], cols[inb]] = vals[blk, slot, lane][inb]
        return out
    raise ValueError(layer.mode)
