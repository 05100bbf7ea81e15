"""Projection-leaf dispatch: the table `models.layers.dense` consults for
a param leaf that is not a raw matrix.

It holds one entry, `core.sparse_fc.CompressedFC` -> `apply_fc` (the
dense / int8 / codebook4 / acsr / aida paths), which `core.sparse_fc`
registers when it is imported, so the entry is there before any such
leaf exists.  The table is kept for parity with the JAX package's
`api.dispatch`; it is keyed by the leaf's type.

Import-free on purpose: `models.layers` imports this at module scope, so
nothing here may import the model zoo.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_APPLIERS: Dict[type, Callable] = {}


def register_applier(leaf_type: type, fn: Callable) -> None:
    """Register ``fn(leaf, x2d, bias=None, activation=None) -> y2d`` for
    param leaves of ``leaf_type``.  ``bias`` / ``activation`` let the
    leaf's kernel fuse the FC epilogue."""
    _APPLIERS[leaf_type] = fn


def applier_for(leaf) -> Optional[Callable]:
    """The registered applier for this leaf, or None for raw matrices."""
    return _APPLIERS.get(type(leaf))
