"""Per-shard padding of compressed containers, and a rank's share of the
params.

Row-partitioning a compressed FC over ``tp`` ranks needs its row axis to
divide: a BlockedACSR splits on its row-*block* axis (each rank owns a
contiguous band of blocks, a band of output rows: the paper's per-IC
matrix partitioning), int8 / codebook4 / dense on their output channels.
:func:`pad_leaf` appends empty row blocks or zero rows until it divides:
padded rows have ``row_nnz == 0`` or zero codes and scales, compute
nothing real, and are sliced off after the bands are gathered
(``CompressedFC.shape`` keeps the true row count).  A band is a slice of
the block axis, so it keeps the whole's slot depth ``rmax``.

:func:`prepare_params` gives a rank its share of a params tree: every
projection the plan bands becomes a :class:`Band` (the rank's slice and
what the combine needs of the whole), the rest stays as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from repro_torch.core import quant as q
from repro_torch.core import sparse_fc as sfc
from repro_torch.kvstore.pool import PagedKV


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def row_axis_len(leaf: sfc.CompressedFC) -> int:
    """Length of the axis the plan partitions (row blocks for acsr / aida,
    output channels otherwise) on a stacked or single-layer leaf."""
    if leaf.mode in ("acsr", "aida"):
        return leaf.blocked.values.shape[-3]
    if leaf.mode == "int8":
        return leaf.qt.q.shape[-2]
    if leaf.mode == "codebook4":
        return leaf.codes_packed.shape[-2]
    return leaf.dense.shape[-2]


def shardable(leaf: sfc.CompressedFC, tp: int) -> bool:
    return tp > 1 and row_axis_len(leaf) % tp == 0


def _rows_op(leaf: sfc.CompressedFC, op) -> sfc.CompressedFC:
    """``leaf`` with ``op(tensor, axis)`` applied to each array along its
    partition axis (acsr / aida: the block axis of values, col_idx,
    row_nnz and chunk_off; int8: q and its scales; codebook4's codes;
    dense rows)."""
    if leaf.mode in ("acsr", "aida"):
        b = leaf.blocked
        return dataclasses.replace(leaf, blocked=dataclasses.replace(
            b, values=op(b.values, b.values.dim() - 3),
            col_idx=op(b.col_idx, b.col_idx.dim() - 3),
            row_nnz=op(b.row_nnz, b.row_nnz.dim() - 2),
            chunk_off=op(b.chunk_off, b.chunk_off.dim() - 3)))
    if leaf.mode == "int8":
        return dataclasses.replace(leaf, qt=q.QTensor(
            q=op(leaf.qt.q, leaf.qt.q.dim() - 2),
            scale=op(leaf.qt.scale, leaf.qt.scale.dim() - 2)))
    if leaf.mode == "codebook4":
        return dataclasses.replace(leaf, codes_packed=op(
            leaf.codes_packed, leaf.codes_packed.dim() - 2))
    return dataclasses.replace(leaf, dense=op(leaf.dense,
                                              leaf.dense.dim() - 2))


def pad_leaf(leaf: sfc.CompressedFC, tp: int) -> sfc.CompressedFC:
    """Pad the partition axis of one compressed leaf to a multiple of
    ``tp`` (the leaf itself when it already divides).  Works on stacked
    ([L, ...]) and single-layer leaves; ``shape`` keeps the true row
    count, so downstream slicing stays right."""
    n = row_axis_len(leaf)
    pad = _ceil_to(n, tp) - n
    if pad == 0:
        return leaf

    def pad_rows(x, axis):
        widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
        return torch.nn.functional.pad(x, widths)

    return _rows_op(leaf, pad_rows)


def pad_params_for_plan(plan, params: Dict) -> Dict:
    """Pad every compressed leaf's partition axis to a multiple of the
    plan's tp degree; raw tensors pass through."""
    def visit(tree):
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, sfc.CompressedFC) and plan.tp > 1:
            return pad_leaf(tree, plan.tp)
        return tree
    return visit(params)


def local_view(leaf: sfc.CompressedFC, tp: int,
               shard: int = 0) -> sfc.CompressedFC:
    """Shard ``shard``'s band of a (stacked or single-layer) compressed
    leaf, padded to ``tp`` first: a copy, with ``shape`` (and a
    BlockedACSR's) the band's own rows, the geometry the rank's kernel
    runs."""
    lay = pad_leaf(leaf, tp)
    n = row_axis_len(lay) // tp

    def rows(x, axis):
        return x.narrow(axis, shard * n, n).clone(
            memory_format=torch.contiguous_format)

    band = _rows_op(lay, rows)
    n_in = lay.shape[1]
    if lay.mode in ("acsr", "aida"):
        shape = (n * lay.blocked.block_rows, n_in)
        return dataclasses.replace(
            band, shape=shape,
            blocked=dataclasses.replace(band.blocked, shape=shape))
    return dataclasses.replace(band, shape=(n, n_in))


@dataclasses.dataclass
class Band:
    """A rank's share of one projection leaf.

    ``local``: the rank's band — a raw [..., d_in, d_out / tp] matrix, or
    a CompressedFC of the band's rows (:func:`local_view`); under int8's
    psum policy, q's column band with every row's scale.  ``n_out``: the
    whole's output width, the gathered result's.  ``split``: the whole's
    row geometry (row blocks for acsr / aida, output channels otherwise),
    whose kernel split the band's launches follow.  ``policy``: "gather"
    or "psum"."""
    local: Union[torch.Tensor, sfc.CompressedFC]
    n_out: int
    split: int
    policy: str = "gather"

    def layer(self, i: int) -> "Band":
        """Layer ``i`` of a stacked band (a view)."""
        return dataclasses.replace(
            self, local=self.local.layer(i)
            if isinstance(self.local, sfc.CompressedFC) else self.local[i])


def band_leaf(plan, leaf: sfc.CompressedFC) -> Band:
    """This rank's Band of a whole compressed leaf under ``plan``."""
    split = row_axis_len(leaf)
    if plan.policy_for(leaf.mode) == "psum" and leaf.mode == "int8" \
            and leaf.shape[1] % plan.tp == 0:
        cols = plan.band(leaf.shape[1])
        qband = leaf.qt.q[..., cols].clone(
            memory_format=torch.contiguous_format)
        local = dataclasses.replace(
            leaf, shape=(leaf.shape[0], cols.stop - cols.start),
            qt=q.QTensor(q=qband, scale=leaf.qt.scale))
        return Band(local, leaf.shape[0], split, "psum")
    return Band(local_view(leaf, plan.tp, plan.rank), leaf.shape[0], split)


def prepare_params(plan, cfg, params: Dict) -> Dict:
    """This rank's params under ``plan``: each projection the plan bands
    becomes a :class:`Band` (compressed leaves padded to tp first; a raw
    matrix whose output width tp does not divide stays whole), the rest is
    shared as it is.  A plan of one rank returns ``params``."""
    del cfg
    if plan.tp == 1:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if not plan.banded(path):
            return tree
        if isinstance(tree, sfc.CompressedFC):
            return band_leaf(plan, tree)
        spec = plan.param_spec(path, tree)
        if all(e is None for e in spec):
            return tree
        return Band(plan.local(tree, spec), tree.shape[-1], tree.shape[-1])

    return walk(params, ())


def place_state(plan, state: Dict, n_kv: int) -> Dict:
    """This rank's decode state under ``plan``: a paged pool keeps its
    band of the ``n_kv`` heads where they divide tp (``plan.state_spec``);
    everything else is the rank's own full copy."""
    kv = state.get("layers", {}).get("kv")
    if plan.tp == 1 or not isinstance(kv, PagedKV):
        return state
    pool = PagedKV(*(None if a is None else plan.local(
        a, plan.state_spec(("layers", "kv", name), a, n_kv))
        for name, a in zip(PagedKV._fields, kv)))
    return dict(state, layers=dict(state["layers"], kv=pool))


def tune_local_views(params: Dict, plan, batch: int, chunk: int = 1) -> int:
    """Autotune the launch plans of this rank's share of ``params`` under
    ``plan`` (`kernels.tune`), so a mesh session's launches find their
    winners.  A band launches with the whole's split, so each rank times
    its own band under each candidate of the whole geometry, the ranks
    take each candidate's MAX over the group, and every rank records the
    same winner under the whole's key: the mesh keeps its bit-identity to
    one device.  A compressed leaf the plan runs whole is timed whole,
    under the same agreement.  Returns the leaves visited (tuned or found
    in the cache)."""
    from repro_torch.kernels import tune
    from repro_torch.shard import comm
    if plan.tp == 1:
        return 0
    tuned = 0

    def walk(tree, path):
        nonlocal tuned
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        if not isinstance(tree, sfc.CompressedFC) or tree.mode == "dense":
            return
        whole = tune._layer0_view(tree)
        reduce = comm.max_over(plan.group, tune._weights(whole).device)
        if plan.banded(path):
            band = band_leaf(plan, whole)
            if band.policy == "psum":     # no kernel: a torch.matmul
                return
            tune.tune_layer(band.local, batch, chunk, split=band.split,
                            reduce=reduce)
        else:
            tune.tune_layer(whole, batch, chunk, reduce=reduce)
        tuned += 1

    walk(params, ())
    return tuned


def band_bytes(tree) -> int:
    """Bytes of the tensors a (prepared) params tree holds."""
    if isinstance(tree, dict):
        return sum(band_bytes(v) for v in tree.values())
    if isinstance(tree, Band):
        return band_bytes(tree.local)
    if isinstance(tree, sfc.CompressedFC):
        arrs = [tree.dense, tree.codes_packed, tree.centroids]
        if tree.qt is not None:
            arrs += [tree.qt.q, tree.qt.scale]
        if tree.blocked is not None:
            b = tree.blocked
            arrs += [b.values, b.col_idx, b.row_nnz, b.chunk_off,
                     b.centroids]
        return sum(band_bytes(a) for a in arrs)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
