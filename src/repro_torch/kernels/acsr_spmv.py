"""Blocked-ACSR sparse matvec/matmul: format, encoder and kernel wrapper.

The paper's per-nonzero stream is rescheduled at encode time into a
row-balanced slot layout: each block owns ``block_rows`` consecutive
matrix rows (one per lane), and slot ``s`` holds the ``s``-th nonzero of
every row in the block::

    values:  [nblocks, rmax, block_rows]   (slot-major; lane = matrix row)
    col_idx: [nblocks, rmax, block_rows]
    row_nnz: [nblocks, block_rows]         slot >= row_nnz is padding

:func:`acsr_spmv` computes ``act(W @ x + bias)`` through the hand-written
CUDA kernel ``csrc/acsr_spmv.cu`` for tensors on the card, and through its
plain version (``kernels.ref.blocked_acsr_spmv_ref``) for tensors on the
CPU.  The encoder runs in torch on whatever device holds the weights.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.codebook import assign
from repro_torch.kernels import build
from repro_torch.kernels import ref

_VALUE_KINDS = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
_COL_KINDS = {torch.int16: 0, torch.int32: 1}
_MAX_BATCH_CHUNK = 8          # batch columns per kernel pass (MAXB in .cu)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclasses.dataclass
class BlockedACSR:
    """Row-blocked ACSR in the balanced slot schedule.

    values:  [nblocks, rmax, block_rows] f32 / bf16, or uint8 codes when
             ``centroids`` ([16] f32) is set
    col_idx: [nblocks, rmax, block_rows] int16 (n_cols < 2**15) or int32
    row_nnz: [nblocks, block_rows] int32
    A stack over layers puts [L] in front of every array (and [L, 16]
    centroids) and records ``nnz = -1``."""
    values: torch.Tensor
    col_idx: torch.Tensor
    row_nnz: torch.Tensor
    shape: Tuple[int, int]
    block_rows: int
    nnz: int
    centroids: Optional[torch.Tensor] = None

    @property
    def nblocks(self) -> int:
        return int(self.values.shape[-3])

    @property
    def rmax(self) -> int:
        """Padded slot count (max nonzeros of any row)."""
        return int(self.values.shape[-2])

    def layer(self, i: int) -> "BlockedACSR":
        """View of layer ``i`` of a stacked container (no copy)."""
        return dataclasses.replace(
            self, values=self.values[i], col_idx=self.col_idx[i],
            row_nnz=self.row_nnz[i],
            centroids=None if self.centroids is None else self.centroids[i])


def block_encode(dense: torch.Tensor, block_rows: int = 128,
                 slot_pad: int = 8, value_dtype: str = "f32") -> BlockedACSR:
    """Pack a dense [n_rows, n_cols] matrix's nonzeros into the slot
    schedule, vectorised (bincount + cumsum), on the matrix's device."""
    if dense.ndim != 2:
        raise ValueError("BlockedACSR encodes 2-D matrices")
    if value_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown value_dtype {value_dtype!r}")
    dense = dense.float()
    dev = dense.device
    n_rows, n_cols = dense.shape
    nblocks = max(1, cdiv(n_rows, block_rows))
    rows, cols = torch.nonzero(dense, as_tuple=True)   # row-major order
    nnz = int(rows.numel())
    counts = torch.bincount(rows, minlength=nblocks * block_rows)
    rmax = int(counts.max()) if nnz else 0
    rmax = max(slot_pad, cdiv(rmax, slot_pad) * slot_pad)
    starts = torch.cumsum(counts, 0) - counts          # exclusive cumsum
    slot = torch.arange(nnz, device=dev) - starts[rows]
    blk, lane = rows // block_rows, rows % block_rows
    col_t = torch.int16 if n_cols < 2 ** 15 else torch.int32
    vals = torch.zeros((nblocks, rmax, block_rows), dtype=torch.float32,
                       device=dev)
    cidx = torch.zeros((nblocks, rmax, block_rows), dtype=col_t, device=dev)
    vals[blk, slot, lane] = dense[rows, cols]
    cidx[blk, slot, lane] = cols.to(col_t)
    row_nnz = counts.reshape(nblocks, block_rows).to(torch.int32)
    if value_dtype == "bf16":
        vals = vals.to(torch.bfloat16)
    return BlockedACSR(values=vals, col_idx=cidx, row_nnz=row_nnz,
                       shape=(n_rows, n_cols), block_rows=block_rows,
                       nnz=nnz)


def block_encode_coded(dense: torch.Tensor, centroids: torch.Tensor,
                       block_rows: int = 128,
                       slot_pad: int = 8) -> BlockedACSR:
    """Sparse + codebook: store each nonzero's nearest-centroid code (the
    first on ties); padding slots hold code 0 (masked by row_nnz)."""
    b = block_encode(dense, block_rows, slot_pad)
    cents = centroids.to(device=b.values.device, dtype=torch.float32)
    live = b.values != 0.0
    codes = torch.zeros(b.values.shape, dtype=torch.uint8,
                        device=b.values.device)
    nz = b.values[live]
    codes[live] = assign(nz, cents)
    return dataclasses.replace(b, values=codes, centroids=cents)


# --------------------------------------------------------------- kernel
def _launch(b: BlockedACSR, x2d: torch.Tensor, bias: Optional[torch.Tensor],
            activation: Optional[str]) -> torch.Tensor:
    vals, cols, nnz = b.values, b.col_idx, b.row_nnz
    nb, rmax, br = vals.shape
    k, bsz = x2d.shape
    dev = x2d.device
    if vals.dtype not in _VALUE_KINDS or cols.dtype not in _COL_KINDS:
        raise TypeError(f"acsr_spmv takes uint8/f32/bf16 values and "
                        f"int16/int32 col_idx, got {vals.dtype}, "
                        f"{cols.dtype}")
    coded = b.centroids is not None
    if coded != (vals.dtype == torch.uint8):
        raise TypeError("uint8 values need centroids and vice versa")
    if br % 32 or br > 512:
        raise ValueError(f"block_rows {br} must be a multiple of 32, <= 512")
    if activation not in ref.ACT_CODES:
        raise ValueError(f"unknown fused activation {activation!r}")
    if x2d.dtype != torch.float32:
        raise TypeError(f"x must be f32, got {x2d.dtype}")
    if k != b.shape[1]:
        raise ValueError(f"x has {k} rows for a matrix of {b.shape[1]} cols")
    tensors = [vals, cols, nnz, x2d] + ([b.centroids] if coded else []) + \
        ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("acsr_spmv operands must be contiguous and on "
                             "one device")
    if nnz.dtype != torch.int32 or nnz.shape != (nb, br):
        raise TypeError("row_nnz must be int32 [nblocks, block_rows]")
    if coded and (b.centroids.dtype != torch.float32
                  or b.centroids.numel() != 16):
        raise TypeError("centroids must be f32 [16]")
    sy = max(1, 512 // br)
    # split the slot axis across blocks until the card has ~2 blocks per SM
    # (few row blocks otherwise leave most SMs idle), keeping >= 4 slots
    # per thread
    nsplit = max(1, min(cdiv(2 * build.sm_count(dev), nb),
                        cdiv(rmax, 4 * sy)))
    per_split = cdiv(rmax, nsplit)
    nsplit = cdiv(rmax, per_split)
    out = torch.empty((nb * br, bsz), dtype=torch.float32, device=dev)
    part = torch.empty((nsplit * nb * br * min(bsz, _MAX_BATCH_CHUNK)
                        if nsplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    fn = build.library("acsr_spmv").acsr_spmv_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 10 + [ptr]
        fn.restype = ctypes.c_int
    status = fn(vals.data_ptr(), cols.data_ptr(), nnz.data_ptr(),
                b.centroids.data_ptr() if coded else None,
                x2d.data_ptr(), bias.data_ptr() if bias is not None else None,
                out.data_ptr(), part.data_ptr(),
                _VALUE_KINDS[vals.dtype], _COL_KINDS[cols.dtype],
                nb, rmax, br, sy, bsz, nsplit, per_split,
                ref.ACT_CODES[activation],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "acsr_spmv")
    acsr_spmv.launches += 1
    return out


def acsr_spmv(b: BlockedACSR, x: torch.Tensor, *,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None) -> torch.Tensor:
    """Fused sparse (optionally coded) pipeline: act(W @ x + bias).

    x: [K] or [K, B] f32; bias: [n_rows] (or padded to nblocks*block_rows)
    broadcast over B.  Returns [n_rows] / [n_rows, B] f32.  A CUDA tensor
    launches the CUDA kernel (or raises); a CPU tensor takes the plain
    version."""
    squeeze = x.ndim == 1
    x2d = x[:, None] if squeeze else x
    rows = b.nblocks * b.block_rows
    if bias is not None and bias.shape[0] != rows:
        bias = torch.nn.functional.pad(bias.float(),
                                       (0, rows - bias.shape[0]))
    if x2d.device.type == "cpu":
        out = ref.blocked_acsr_spmv_ref(b.values, b.col_idx, b.row_nnz, x2d,
                                        b.centroids, bias, activation)
    else:
        out = _launch(b, x2d.float().contiguous(),
                      None if bias is None else bias.float().contiguous(),
                      activation)
    out = out[: b.shape[0]]
    return out[:, 0] if squeeze else out


acsr_spmv.launches = 0
