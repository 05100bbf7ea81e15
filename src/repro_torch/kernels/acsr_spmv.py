"""Blocked-ACSR sparse matvec/matmul: format, encoder and kernel wrapper.

The paper's per-nonzero stream is rescheduled at encode time into a
row-balanced slot layout: each block owns ``block_rows`` consecutive
matrix rows (one per lane), and slot ``s`` holds the ``s``-th nonzero of
every row in the block::

    values:  [nblocks, rmax, block_rows]   (slot-major; lane = matrix row)
    col_idx: [nblocks, rmax, block_rows]
    row_nnz: [nblocks, block_rows]         slot >= row_nnz is padding

A row's live slots hold its columns in ascending order: both encoders take
the nonzeros in row-major ``nonzero`` order.  So a row's slots of one K
tile of ``CHUNK_COLS`` columns are one run, and ``chunk_off`` (derived from
col_idx and row_nnz whenever a container is made) records where each run
starts: the wide kernel walks a row through x's tiles from it.

:func:`acsr_spmv` computes ``act(W @ x + bias)`` through one of the two
hand-written CUDA kernels of ``csrc/acsr_spmv.cu`` for tensors on the card
(a gather kernel for x of at most 8 columns, a wide kernel for wider x,
both summing each column in one order that :func:`split_plan` fixes),
and through their plain version
(``kernels.ref.blocked_acsr_spmv_ref``) for tensors on the CPU.  The
encoder runs in torch on whatever device holds the weights.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.codebook import assign
from repro_torch.kernels import build
from repro_torch.kernels import ref

_VALUE_KINDS = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
_COL_KINDS = {torch.int16: 0, torch.int32: 1}
CHUNK_COLS = 64       # columns per chunk_off step (CHUNK in .cu)
_GROUP = 32           # x columns per pass of the wide variant (GROUP in .cu)
GATHER_COLS = 8       # x columns up to which the gather variant runs (MAXB)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def chunk_offsets(col_idx: torch.Tensor, row_nnz: torch.Tensor,
                  n_cols: int) -> torch.Tensor:
    """[..., nblocks, nck + 1, block_rows] int32, nck = ceil(n_cols /
    CHUNK_COLS): entry c is the number of a row's live slots whose column
    is below c * CHUNK_COLS, which (columns ascending) is the first slot at
    or past that column; entry nck is row_nnz.  Works on stacked
    containers and on any device."""
    rmax = col_idx.shape[-2]
    nck = max(1, cdiv(n_cols, CHUNK_COLS))
    slot = torch.arange(rmax, device=col_idx.device)[:, None]
    live = slot < row_nnz.unsqueeze(-2)
    chunk = torch.where(live, (col_idx.long() // CHUNK_COLS).clamp(0, nck - 1),
                        nck)
    counts = torch.zeros((*col_idx.shape[:-2], nck + 1, col_idx.shape[-1]),
                         dtype=torch.int32, device=col_idx.device)
    counts.scatter_add_(-2, chunk, torch.ones_like(chunk, dtype=torch.int32))
    return (torch.cumsum(counts, dim=-2, dtype=torch.int32)
            - counts).contiguous()


@dataclasses.dataclass
class BlockedACSR:
    """Row-blocked ACSR in the balanced slot schedule.

    values:  [nblocks, rmax, block_rows] f32 / bf16, or uint8 codes when
             ``centroids`` ([16] f32) is set
    col_idx: [nblocks, rmax, block_rows] int16 (n_cols < 2**15) or int32
    row_nnz: [nblocks, block_rows] int32
    chunk_off: [nblocks, nck + 1, block_rows] int32 (:func:`chunk_offsets`,
             derived from col_idx and row_nnz when not given)
    A stack over layers puts [L] in front of every array (and [L, 16]
    centroids) and records ``nnz = -1``."""
    values: torch.Tensor
    col_idx: torch.Tensor
    row_nnz: torch.Tensor
    shape: Tuple[int, int]
    block_rows: int
    nnz: int
    centroids: Optional[torch.Tensor] = None
    chunk_off: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.chunk_off is None:
            self.chunk_off = chunk_offsets(self.col_idx, self.row_nnz,
                                           self.shape[1])

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
            row_nnz=self.row_nnz[i], chunk_off=self.chunk_off[i],
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
@functools.lru_cache(maxsize=None)
def split_plan(nb: int, rmax: int, br: int, sms: int) -> Tuple[int, int, int]:
    """(sy, nsplit, per_split): the one split of the slot axis that both
    K1 variants follow, so a column's sum order never depends on x's
    width.  nsplit ranges of per_split slots (across blocks, partials added
    in range order), each cut into sy interleaved parts (threads of a row,
    added in part order).  Ranges are added until the card has ~2 blocks
    of br * sy threads per SM (few row blocks otherwise leave most SMs
    idle), keeping >= 4 slots per thread."""
    sy = max(1, 512 // br)
    nsplit = max(1, min(cdiv(2 * sms, nb), cdiv(rmax, 4 * sy)))
    per = max(1, cdiv(rmax, nsplit))
    return sy, max(1, cdiv(rmax, per)), per


def _check(b: BlockedACSR, x2d: torch.Tensor, bias: Optional[torch.Tensor],
           activation: Optional[str]) -> None:
    """What the CUDA kernels take; raises on anything else."""
    vals, cols, nnz, off = b.values, b.col_idx, b.row_nnz, b.chunk_off
    nb, rmax, br = vals.shape
    k = x2d.shape[0]
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
    tensors = [vals, cols, nnz, off, x2d] + \
        ([b.centroids] if coded else []) + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError("acsr_spmv operands must be contiguous and on "
                             "one device")
    if vals.data_ptr() % 16 or cols.data_ptr() % 16:
        raise ValueError("acsr_spmv copies the slot stream in 16-byte "
                         "pieces: values and col_idx must be 16-byte "
                         "aligned")
    if nnz.dtype != torch.int32 or nnz.shape != (nb, br):
        raise TypeError("row_nnz must be int32 [nblocks, block_rows]")
    nck = max(1, cdiv(k, CHUNK_COLS))
    if off.dtype != torch.int32 or off.shape != (nb, nck + 1, br):
        raise TypeError(f"chunk_off must be int32 [nblocks, {nck + 1}, "
                        f"block_rows]")
    if coded and (b.centroids.dtype != torch.float32
                  or b.centroids.numel() != 16):
        raise TypeError("centroids must be f32 [16]")


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.library("acsr_spmv"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptrs(b: BlockedACSR, x2d, bias, out, part, with_off: bool):
    return ([b.values.data_ptr(), b.col_idx.data_ptr(), b.row_nnz.data_ptr()]
            + ([b.chunk_off.data_ptr()] if with_off else [])
            + [None if b.centroids is None else b.centroids.data_ptr(),
               x2d.data_ptr(), None if bias is None else bias.data_ptr(),
               out.data_ptr(), part.data_ptr()])


def launch_plan(b: BlockedACSR, sms: int,
                split_nb: Optional[int] = None) -> Tuple[int, int, int]:
    """The split a launch runs: the container's own, or that of the whole
    matrix of ``split_nb`` row blocks a row band was cut from (a band
    keeps the whole's rmax, so its rows sum in the whole's order, bit for
    bit)."""
    nb, rmax, br = b.values.shape
    if split_nb is not None and split_nb < nb:
        raise ValueError(f"split_nb {split_nb} is below the band's {nb} "
                         "row blocks")
    return split_plan(split_nb or nb, rmax, br, sms)


def spmv_gather(b: BlockedACSR, x2d: torch.Tensor,
                bias: Optional[torch.Tensor], activation: Optional[str],
                split_nb: Optional[int] = None) -> torch.Tensor:
    """The variant for x of at most GATHER_COLS columns (a decode step):
    one thread a row part gathers x from L1 / L2 per slot; the ranges are
    added by the row block's last block, in one launch.  Returns [nblocks *
    block_rows, B] f32."""
    nb, rmax, br = b.values.shape
    bsz = x2d.shape[1]
    dev = x2d.device
    if x2d.data_ptr() % 16:          # the kernel reads x rows 16 bytes at
        x2d = x2d.clone()            # a time
    sy, nsplit, per = launch_plan(b, build.sm_count(dev), split_nb)
    out = torch.empty((nb * br, bsz), dtype=torch.float32, device=dev)
    part = torch.empty((nsplit * nb * br * bsz if nsplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cnt = build.counters(dev, stream, nb)
    status = _fn("acsr_spmv_gather_launch", 9, 10)(
        *_ptrs(b, x2d, bias, out, part, with_off=False), cnt.data_ptr(),
        _VALUE_KINDS[b.values.dtype], _COL_KINDS[b.col_idx.dtype], nb, rmax,
        br, sy, bsz, nsplit, per, ref.ACT_CODES[activation], stream)
    build.check(status, "acsr_spmv_gather")
    spmv_gather.launches += 1
    return out


def spmv_wide(b: BlockedACSR, x2d: torch.Tensor,
              bias: Optional[torch.Tensor], activation: Optional[str],
              split_nb: Optional[int] = None) -> torch.Tensor:
    """The variant for wider x (a chunked step): x staged in shared memory
    tile by tile, up to 32 columns a pass over the weights, each column
    summed as the gather variant sums it.  Returns [nblocks * block_rows,
    B] f32."""
    nb, rmax, br = b.values.shape
    k, bsz = x2d.shape
    dev = x2d.device
    nck = max(1, cdiv(k, CHUNK_COLS))
    sy, nsplit, per = launch_plan(b, build.sm_count(dev), split_nb)
    out = torch.empty((nb * br, bsz), dtype=torch.float32, device=dev)
    part = torch.empty((nsplit * nb * br * min(bsz, _GROUP)
                        if nsplit > 1 else 1,),
                       dtype=torch.float32, device=dev)
    status = _fn("acsr_spmv_wide_launch", 9, 13)(
        *_ptrs(b, x2d, bias, out, part, with_off=True),
        _VALUE_KINDS[b.values.dtype], _COL_KINDS[b.col_idx.dtype], nb, rmax,
        br, sy, k, bsz, nck, CHUNK_COLS, nsplit, per,
        ref.ACT_CODES[activation], torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "acsr_spmv_wide")
    spmv_wide.launches += 1
    return out


def _launch(b: BlockedACSR, x2d: torch.Tensor, bias: Optional[torch.Tensor],
            activation: Optional[str],
            split_nb: Optional[int] = None) -> torch.Tensor:
    """Check the operands, then launch the variant for x's width."""
    _check(b, x2d, bias, activation)
    kern = spmv_gather if x2d.shape[1] <= GATHER_COLS else spmv_wide
    return kern(b, x2d, bias, activation, split_nb)


def acsr_spmv(b: BlockedACSR, x: torch.Tensor, *,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None,
              split_nb: Optional[int] = None) -> torch.Tensor:
    """Fused sparse (optionally coded) pipeline: act(W @ x + bias).

    x: [K] or [K, B] f32; bias: [n_rows] (or padded to nblocks*block_rows)
    broadcast over B.  Returns [n_rows] / [n_rows, B] f32.  A CUDA tensor
    launches the CUDA kernel (or raises); a CPU tensor takes the plain
    version: x of at most GATHER_COLS columns takes :func:`spmv_gather`,
    wider x :func:`spmv_wide`; both give each column the same bits.  The
    wide variant relies on each row's live slots holding ascending columns,
    as both encoders and the bridged reference containers do.
    ``split_nb``: on a row band of a larger matrix, the whole's row-block
    count, whose split the band's launch follows."""
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
                      activation, split_nb)
    out = out[: b.shape[0]]
    return out[:, 0] if squeeze else out


spmv_gather.launches = 0
spmv_wide.launches = 0
