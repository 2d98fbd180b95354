"""The data mesh a sharded forward runs on: one process per rank.

The reference drives every device from one controller over a
``jax.sharding.Mesh``; the port runs SPMD, one process per rank under
``torch.distributed``.  :func:`make_data_mesh` lays the ranks of the
initialized default process group out as a
``torch.distributed.device_mesh.DeviceMesh`` with the axis ``("data",)``
or ``("data", "feature")``; its per-axis process groups carry the
collectives (``repro_torch.dist.collectives``).  The caller initializes
the group itself, with its own address, world size and rank (a
``FileStore`` or ``file://`` rendezvous needs no port).

A rank's device is ``cuda:{local_rank % device_count}`` unless the caller
asks for the CPU.  Two ranks may share one card: NCCL refuses that, a gloo
group does not (gloo takes CUDA tensors for all-reduce, reduce-scatter and
all-gather; ``chip_smoke.py`` phase 7 runs so).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.dist.topology import axis_sizes


def rank_device(
        device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: ``device`` when given, else the card
    ``local_rank % torch.cuda.device_count()`` (``LOCAL_RANK``, else the
    global rank)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a data mesh places its ranks on cards "
            "by default; pass device='cpu' to run the plain PyTorch path")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_data_mesh(n_data: int, *, feature: int = 1,
                   device: Optional[Union[str, torch.device]] = None):
    """``DeviceMesh`` of ``n_data`` (x ``feature``) ranks over the default
    process group, axes ``("data",)`` or ``("data", "feature")``: rank
    ``r`` sits at data index ``r // feature``, feature index
    ``r % feature``.  Every rank of the group calls it (SPMD); the group
    must hold exactly ``n_data * feature`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_data_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_data < 1 or feature < 1 or n_data * feature != world:
        raise ValueError(
            f"a {n_data} x {feature} mesh needs {n_data * feature} ranks; "
            f"the process group has {world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = (n_data,) if feature == 1 else (n_data, feature)
    names = ("data",) if feature == 1 else ("data", "feature")
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (pod folds into data parallelism)."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def axis_size(mesh, name) -> int:
    """Size of axis ``name`` (or the product over a tuple of names) of a
    ``DeviceMesh`` or an abstract mesh."""
    sizes = axis_sizes(mesh)
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= sizes[n]
        return out
    return sizes[name]
