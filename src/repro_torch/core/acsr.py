"""ACSR — Associative CSR, the paper's sparse format (§3, Fig. 2) — and
magnitude pruning for the ACSR / AIDA compressors.

Classic CSR keeps a per-row pointer array.  ACSR drops it: every nonzero
carries, alongside its value and column index, a 2-bit *row flag* marking
the first / last / only element of its matrix row, which makes each CAM
row (PU) self-describing (the soft reduction steers by it).

Flags (paper Fig. 3):
    FLAG_FIRST = 0b01   first element of a matrix row
    FLAG_LAST  = 0b10   last element of a matrix row
    FLAG_ONLY  = 0b11   row has a single element
    FLAG_MID   = 0b00   interior element (and padding)

The nnz stream is padded to a block multiple and every entry also carries
an explicit ``seg_id`` (its matrix-row index; padding uses ``n_rows`` as a
sentinel).  Encoding is host work (numpy); the stream's tensors land on
the device the caller names.

The AP emulator (`core.aida_fc`) uses `encode` and `max_row_nnz`.
`decode`, `seg_id_from_flags` and `spmv_ref` are the JAX package's
array-level oracles of the format, kept for parity with its module: the
tests hold the port's stream against the reference's through them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

FLAG_MID = 0b00
FLAG_FIRST = 0b01
FLAG_LAST = 0b10
FLAG_ONLY = 0b11


@dataclasses.dataclass
class ACSR:
    """ACSR matrix: per-nnz (value, col_idx, row_flag, seg_id), padded."""

    values: torch.Tensor    # [nnz_pad] float32 (or codebook codes as f32)
    col_idx: torch.Tensor   # [nnz_pad] int32
    row_flag: torch.Tensor  # [nnz_pad] uint8 (FLAG_*)
    seg_id: torch.Tensor    # [nnz_pad] int32; padding entries = n_rows
    shape: Tuple[int, int]  # (n_rows, n_cols) of the dense matrix
    nnz: int                # true (unpadded) number of nonzeros

    @property
    def nnz_pad(self) -> int:
        return int(self.values.shape[0])


def encode(dense, block: int = 128, device="cpu") -> ACSR:
    """Encode a dense matrix into ACSR, padding nnz to a multiple of
    ``block``.  Nonzeros are stored row-major (all elements of matrix row
    j are consecutive), exactly as the paper lays PUs out in the CAM."""
    dense = np.asarray(dense)
    if dense.ndim != 2:
        raise ValueError("ACSR encodes 2-D matrices")
    n_rows, n_cols = dense.shape
    rows, cols = np.nonzero(dense)
    order = np.lexsort((cols, rows))  # row-major
    rows, cols = rows[order], cols[order]
    vals = dense[rows, cols]
    nnz = vals.shape[0]

    flags = np.full((nnz,), FLAG_MID, dtype=np.uint8)
    if nnz:
        first = np.ones((nnz,), dtype=bool)
        first[1:] = rows[1:] != rows[:-1]
        last = np.ones((nnz,), dtype=bool)
        last[:-1] = rows[:-1] != rows[1:]
        flags[first & ~last] = FLAG_FIRST
        flags[last & ~first] = FLAG_LAST
        flags[first & last] = FLAG_ONLY

    nnz_pad = max(block, ((nnz + block - 1) // block) * block)
    pad = nnz_pad - nnz
    values = np.concatenate([vals.astype(np.float32),
                             np.zeros(pad, np.float32)])
    col_idx = np.concatenate([cols.astype(np.int32), np.zeros(pad, np.int32)])
    row_flag = np.concatenate([flags, np.full(pad, FLAG_MID, np.uint8)])
    seg_id = np.concatenate([rows.astype(np.int32),
                             np.full(pad, n_rows, np.int32)])
    dev = torch.device(device)
    return ACSR(values=torch.from_numpy(values).to(dev),
                col_idx=torch.from_numpy(col_idx).to(dev),
                row_flag=torch.from_numpy(row_flag).to(dev),
                seg_id=torch.from_numpy(seg_id).to(dev),
                shape=(n_rows, n_cols), nnz=int(nnz))


def max_row_nnz(dense) -> int:
    """Nonzeros in the fullest row of ``dense`` (at least 1): how many PUs
    the soft reduction folds into one.  The emulator sizes its fields by
    it and the closed-form model prices the reduction by it."""
    nz = (np.asarray(dense) != 0).sum(axis=1)
    return max(1, int(nz.max(initial=0)))


def decode(a: ACSR) -> torch.Tensor:
    """Inverse of :func:`encode` (drops padding): dense f32 on a's
    device."""
    out = torch.zeros(a.shape, dtype=torch.float32, device=a.values.device)
    segs = a.seg_id[: a.nnz].long()
    cols = a.col_idx[: a.nnz].long()
    out[segs, cols] = a.values[: a.nnz].float()
    return out


def seg_id_from_flags(row_flag: torch.Tensor, nnz: int,
                      n_rows: int) -> torch.Tensor:
    """Recover seg_ids from row flags alone (prefix count of FIRST|ONLY):
    the 2-bit flag stream determines row membership, which is all the soft
    reduction needs.  With empty matrix rows the count numbers populated
    rows only, as in the JAX package."""
    is_first = (row_flag & FLAG_FIRST) != 0
    seg = torch.cumsum(is_first.long(), 0) - 1
    seg[nnz:] = n_rows
    return seg.to(torch.int32)


def prune_topk(dense: torch.Tensor, density: float) -> torch.Tensor:
    """Magnitude pruning to a target density (Deep-Compression style):
    keep every entry with |w| >= the k-th largest |w|, k = round(density
    * size).  The threshold is entry n - k of the ascending sort, the
    value ``torch.kthvalue(|w|, n - k + 1)`` gives: on the card one sort of
    a whole matrix takes milliseconds where kthvalue's select over a
    single slice of tens of millions of entries takes hundreds."""
    k = max(1, int(round(density * dense.numel())))
    mag = dense.abs()
    thresh = torch.sort(mag.reshape(-1)).values[dense.numel() - k]
    return dense * (mag >= thresh)


def spmv_ref(a: ACSR, b: torch.Tensor) -> torch.Tensor:
    """Array-level oracle for ACSR matvec, stage for stage the paper's
    algorithm: activation broadcast = gather b[col_idx]; multiplication =
    elementwise product in every PU; soft reduction = a segment sum over
    seg_id (``index_add_``)."""
    n_rows = a.shape[0]
    gathered = b.index_select(0, a.col_idx.long())   # activation broadcast
    prod = a.values * gathered                         # parallel multiply
    out = torch.zeros(n_rows + 1, dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, a.seg_id.long(), prod)[:n_rows]
