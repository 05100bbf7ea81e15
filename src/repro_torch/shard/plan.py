"""ShardingPlan — one object that knows where every serving leaf lives.

A plan is built from a mesh and a model config (:func:`make_plan`) and
owns three decisions:

1. **Param placement** (:meth:`ShardingPlan.param_spec`): the projections
   the tensor-parallel path runs (attention's wq / wk / wv / wo, the
   MLP's up / gate / down) are banded by output rows over the model axis,
   compressed or raw: a BlockedACSR by row blocks (the paper's per-IC
   matrix partitioning), int8 / codebook4 / dense by output channels with
   their scales, a raw [d_in, d_out] matrix by its d_out columns.
   Everything else replicates: the embedding, norms, biases, routers,
   the MoE expert stacks, the recurrent families' own projections and
   the lm_head, whose f32 cuBLAS product on the card sums a vocab band in
   another order than the whole at 32 rows (a chunked step's), which
   would cost the mesh its bit-identity.
2. **State placement** (:meth:`ShardingPlan.state_spec`): a paged pool's
   KV heads (and their int8 scales) are banded where the heads divide the
   model axis, the same ranks owning a head's wk / wv rows and its pages;
   the page table, positions, dense caches and recurrent state replicate.
3. **Combine policy** (:meth:`ShardingPlan.policy_for`): per compressed
   mode, ``"gather"`` (row bands; every output element is computed wholly
   on one rank, so the mesh is bit-identical to one device) or ``"psum"``
   (int8 only: column bands of q and x, partial products all-reduced).

A spec is a tuple with one entry per axis of a leaf: ``"model"`` where
the axis is banded over the model axis, None where it is whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh

#: default combine policy per compressed mode ("gather" = row-partitioned
#: output bands; "psum" = input-partitioned partial sums)
DEFAULT_POLICY: Tuple[Tuple[str, str], ...] = (
    ("dense", "gather"), ("int8", "gather"), ("codebook4", "gather"),
    ("acsr", "gather"), ("aida", "gather"),
)
#: the projections the tensor-parallel path runs, by (block, leaf) name
BANDED = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("up", "gate", "down")}


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Mesh
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    policy: Tuple[Tuple[str, str], ...] = DEFAULT_POLICY

    # ------------------------------------------------------------ basics
    @property
    def tp(self) -> int:
        """Model-parallel degree."""
        return int(self.mesh.shape[self.mesh.axis_names.index(self.tp_axis)])

    @property
    def dp(self) -> int:
        out = 1
        for a in self.dp_axes:
            if a in self.mesh.axis_names:
                out *= int(self.mesh.shape[self.mesh.axis_names.index(a)])
        return out

    @property
    def rank(self) -> int:
        """This rank's index on the model axis (its band)."""
        return self.mesh.coords[1]

    @property
    def group(self):
        """The process group of this rank's model axis."""
        return self.mesh.group

    def policy_for(self, mode: str) -> str:
        return dict(self.policy).get(mode, "gather")

    def band(self, n: int) -> slice:
        """This rank's band of an axis of ``n`` (a multiple of tp)."""
        per = n // self.tp
        return slice(self.rank * per, (self.rank + 1) * per)

    # ----------------------------------------------------------- fitting
    def fit(self, spec: Optional[Sequence], shape: Sequence[int]) -> tuple:
        """Drop banded axes that the model axis does not divide: a leaf
        whose head / row count is no multiple of tp replicates instead of
        erroring (padding is partition.py's job for compressed leaves)."""
        if spec is None:
            return (None,) * len(shape)
        ents = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        return tuple(e if e is None or dim % self.tp == 0 else None
                     for dim, e in zip(shape, ents))

    def local(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """This rank's share of ``x`` under a fitted ``spec`` (a copy of
        the band, so the whole can be freed; ``x`` itself when whole)."""
        for axis, e in enumerate(spec):
            if e is not None:
                x = x.narrow(axis, self.band(x.shape[axis]).start,
                             x.shape[axis] // self.tp)
        return x if all(e is None for e in spec) \
            else x.clone(memory_format=torch.contiguous_format)

    # ------------------------------------------------------------ params
    def banded(self, path: Tuple[str, ...]) -> bool:
        """Whether the param at ``path`` (names from the params root) is
        one the tensor-parallel path runs in bands."""
        return len(path) >= 3 and path[0] == "layers" \
            and path[-1] in BANDED.get(path[-2], ())

    def param_spec(self, path: Tuple[str, ...], leaf) -> tuple:
        """Spec of a raw param leaf: a banded projection's output axis
        (its last) over the model axis, whole elsewhere."""
        nd = leaf.dim()
        if self.banded(path):
            return self.fit((None,) * (nd - 1) + (self.tp_axis,),
                            leaf.shape)
        return (None,) * nd

    # ------------------------------------------------------------- state
    def kv_banded(self, n_kv: int) -> bool:
        """Whether a paged pool of ``n_kv`` heads is banded by heads (a
        GQA group rides with its kv head)."""
        return self.tp > 1 and n_kv % self.tp == 0

    def state_spec(self, path: Tuple[str, ...], leaf,
                   n_kv: int) -> tuple:
        """Spec of a decode-state leaf: a paged pool's head axis ([L,
        n_pages, Hkv, ps, Dh] pages, [L, n_pages, Hkv] scales) over the
        model axis where the heads divide; the rest whole."""
        nd = leaf.dim()
        if path[:2] == ("layers", "kv") and path[-1].endswith(
                ("pages", "scale")) and self.kv_banded(n_kv):
            return (None, None, self.tp_axis) + (None,) * (nd - 3)
        return (None,) * nd


def make_plan(mesh: Mesh, cfg=None, policy=None) -> ShardingPlan:
    """A serving ShardingPlan from a mesh (it must carry a ``model`` axis;
    a ``data`` axis replicates for now).  ``policy``: {mode: "gather" |
    "psum"} over the defaults."""
    del cfg                           # placement reads leaves, not cfg
    if "model" not in mesh.axis_names:
        raise ValueError(
            f"serving mesh needs a 'model' axis; got {mesh.axis_names}")
    pol = DEFAULT_POLICY if policy is None else tuple(sorted(
        {**dict(DEFAULT_POLICY), **policy}.items()))
    for mode, how in pol:
        if how not in ("gather", "psum"):
            raise ValueError(f"combine policy {how!r} for {mode!r}: "
                             "'gather' or 'psum'")
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ShardingPlan(mesh=mesh, tp_axis="model", dp_axes=dp_axes,
                        policy=pol)
