"""Serving meshes over ``torch.distributed``: one process per rank.

A mesh is the ``(data, model)`` grid of the ranks of the default process
group, rank ``r`` at ``(r // n_model, r % n_model)``.  Each row of the
grid (the ranks that share a data index) is one model-axis group, which
tensor-parallel serving gathers over; a data row serves on its own (the
data axis replicates for now).  The caller starts the ranks and the
process group (`repro_torch.shard.comm.spawn` does both); a mesh of one
rank needs no group.  The collective backend is the group's own and is
never switched: ``nccl`` where every rank owns its card, ``gloo`` on the
CPU and for ranks that share one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, model)`` grid of ranks."""
    shape: Tuple[int, int]            # (n_data, n_model)
    rank: int
    device: torch.device
    backend: Optional[str] = None     # None: a mesh of one, no group
    group: object = None              # this rank's model-axis group
    axis_names: Tuple[str, str] = AXES

    @property
    def coords(self) -> Tuple[int, int]:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.shape[1])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def _world() -> Tuple[int, int, Optional[str]]:
    """(world size, rank, backend) of the default process group, or a
    single rank when none is up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def make_host_mesh(n_model: Optional[int] = None,
                   n_data: Optional[int] = None, *,
                   backend: Optional[str] = None, device=None) -> Mesh:
    """A (data, model) mesh over the ranks of the default process group.

    With both degrees given they must multiply to the world size; with
    one given the other is inferred; with neither, every rank goes on the
    model axis.  ``backend``, when given, must be the group's (``nccl`` or
    ``gloo``: no silent switch).  ``device`` is this rank's device (None:
    ``cuda:<rank>`` under nccl, else the first card; ``"cpu"`` for the
    plain versions), made the rank's current card.  Every rank must call
    this in the same order: it makes one process group per data row."""
    n, rank, group_backend = _world()
    for name, deg in (("n_model", n_model), ("n_data", n_data)):
        if deg is not None and deg < 1:
            raise ValueError(f"mesh degrees must be >= 1; got {name}={deg}")
    if n_model is None and n_data is None:
        n_model, n_data = n, 1
    elif n_model is None:
        if n % n_data:
            raise ValueError(
                f"n_data={n_data} does not divide device_count={n}")
        n_model = n // n_data
    elif n_data is None:
        if n % n_model:
            raise ValueError(
                f"n_model={n_model} does not divide device_count={n}")
        n_data = n // n_model
    if n_model * n_data != n:
        raise ValueError(
            f"mesh {n_data}x{n_model} (data x model) needs "
            f"{n_data * n_model} devices but the process group has {n} "
            "ranks; start one process per rank "
            "(repro_torch.shard.comm.spawn) before making the mesh")
    if backend is not None and group_backend is not None \
            and backend != group_backend:
        raise ValueError(f"mesh backend {backend!r} is not the process "
                         f"group's {group_backend!r}")
    if device is None:
        from repro_torch.core.device import resolve_device
        device = resolve_device(None)
        if group_backend == "nccl":
            device = torch.device("cuda", rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group_backend == "nccl" and device.type != "cuda":
        raise ValueError("an nccl mesh runs each rank on its card; "
                         f"got device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)      # the rank's current card
    group = None
    if group_backend is not None:
        import torch.distributed as dist
        # every rank makes every row's group, in the same order
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == rank // n_model:
                group = g
    return Mesh(shape=(n_data, n_model), rank=rank, device=device,
                backend=group_backend, group=group)


def same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is the current
    card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def mesh_shape_dict(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    d = mesh_shape_dict(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= d[a]
    return out
