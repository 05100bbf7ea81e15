"""Carry the JAX package's parameters and decode state into the port.

The caller hands over the reference's trees with every array already
turned into a numpy array (``jax.tree.map(np.asarray, tree)`` keeps the
reference's containers and swaps their arrays); this module reads those
containers by their field names and never imports the reference.

Covered: raw param dicts, ``CompressedFC`` in the dense / acsr / aida
modes, stacked or single ``BlockedACSR`` (int16 or int32 col_idx, uint8
codes or f32 / bf16 values, [L, 16] centroids) and the paged decode state
(``PagedKV`` pools, ``pos``, ``page_table``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sparse_fc import CompressedFC
from repro_torch.kernels.acsr_spmv import BlockedACSR
from repro_torch.kvstore.pool import PagedKV


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _blocked(b, device) -> BlockedACSR:
    return BlockedACSR(
        values=tensor(b.values, device), col_idx=tensor(b.col_idx, device),
        row_nnz=tensor(b.row_nnz, device), shape=tuple(b.shape),
        block_rows=int(b.block_rows), nnz=int(b.nnz),
        centroids=None if b.centroids is None
        else tensor(b.centroids, device))


def _compressed(c, device) -> CompressedFC:
    if c.mode not in ("dense", "acsr", "aida"):
        raise NotImplementedError(
            f"mode {c.mode!r} is carried over with its kernels (K4, K5) in a "
            "later slice of the port")
    return CompressedFC(
        mode=c.mode, shape=tuple(c.shape),
        dense=None if c.dense is None else tensor(c.dense, device),
        blocked=None if c.blocked is None else _blocked(c.blocked, device))


def from_reference(tree: Any, device=None) -> Any:
    """Convert a numpy-leaved reference tree (params or paged decode
    state) into the port's containers on ``device``."""
    name = type(tree).__name__
    if name == "CompressedFC":
        return _compressed(tree, device)
    if name == "BlockedACSR":
        return _blocked(tree, device)
    if name == "PagedKV":
        return PagedKV(*(None if a is None else tensor(a, device)
                         for a in (tree.k_pages, tree.v_pages, tree.k_scale,
                                   tree.v_scale)))
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tensor(tree, device)


def to_device(tree: Any, device) -> Any:
    """Move a port param / state tree to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, CompressedFC):
        return CompressedFC(tree.mode, tree.shape,
                            dense=to_device(tree.dense, device),
                            blocked=to_device(tree.blocked, device))
    if isinstance(tree, BlockedACSR):
        return BlockedACSR(to_device(tree.values, device),
                           to_device(tree.col_idx, device),
                           to_device(tree.row_nnz, device), tree.shape,
                           tree.block_rows, tree.nnz,
                           to_device(tree.centroids, device))
    if isinstance(tree, PagedKV):
        return PagedKV(*(to_device(a, device) for a in tree))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree
