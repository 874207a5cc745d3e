"""The mesh over ``torch.distributed`` and the collectives of the sharded
paths (each counted, as ``_cuda`` counts kernel launches)."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

COLLECTIVES = ("all_reduce", "all_gather", "all_to_all")
_COUNTS = dict.fromkeys(COLLECTIVES, 0)


def reset_collectives() -> None:
    for name in COLLECTIVES:
        _COUNTS[name] = 0


def collectives() -> dict[str, int]:
    """Collectives issued by this process since the last reset, by name."""
    return dict(_COUNTS)


def make_mesh(n_devices: int | None = None, axis: str = "x", device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first n_devices ranks (default: all) of the
    initialised default process group.  Every rank of the group calls it
    (a mesh over fewer ranks still creates its group on all of them).  On
    the card it makes ``cuda:LOCAL_RANK`` (else rank mod card count) the
    rank's current device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


class MeshGroup:
    """The process group of a mesh, its size D and this rank's shard
    index d, and the collectives the sharded paths use (each counted)."""

    def __init__(self, mesh: DeviceMesh):
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the mesh")
        if mesh.ndim > 1:
            if not mesh.mesh_dim_names:
                raise ValueError("a mesh of several dimensions needs mesh_dim_names")
            mesh = mesh._flatten()
        self.group = mesh.get_group()
        self.size = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a tensor over the mesh, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        _COUNTS["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's tensor, stacked in shard order: (D,) + t.shape."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        _COUNTS["all_gather"] += 1
        return torch.stack(parts)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block j of axis 0 of t goes to rank j; returns the blocks
        received, block s from rank s."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        _COUNTS["all_to_all"] += 1
        return out
