"""The device mesh over ``torch.distributed`` (≙
``bigdl_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the chips one program
sees.  Here each rank is a process with one device, and a mesh is the
process group that joins them: :func:`init_distributed` starts the group
(NCCL for ``cuda``, gloo for ``device="cpu"``; from the arguments, or
from ``torchrun``'s environment), :func:`create_mesh` names its axis.
Only the ``dp`` axis is ported (the composed dp×fsdp×tp×sp×pp×ep meshes
are ROADMAP queue A, item 5), and ``virtual_devices`` has no counterpart:
the CPU tests run gloo ranks.  A batch's leading dim splits over ``dp``
as ``P("dp")`` splits it: rank r takes rows ``[r·b/n, (r+1)·b/n)``
(:func:`shard_batch`).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

KNOWN_AXES = ("dp", "fsdp", "sp", "tp", "pp", "ep")

_current_mesh: Optional["Mesh"] = None


class Mesh:
    """A named axis over the ranks of a process group: ``shape`` maps
    ``"dp"`` to the world size, ``rank`` is this process's index on it,
    ``device`` this process's device."""

    def __init__(self, axes: Dict[str, int], group, device: torch.device):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device},"
                f" backend={dist.get_backend(self.group)})")


def init_distributed(init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None, *,
                     device: DeviceLike = None) -> torch.device:
    """Start the process group of this rank and return its device.

    ``init_method`` (``"tcp://host:port"``, ``"file:///path"``),
    ``rank`` and ``world_size`` default to ``torchrun``'s environment
    (``env://``, ``RANK``, ``WORLD_SIZE``).  On ``cuda`` (the default)
    the backend is NCCL and the rank's device is ``LOCAL_RANK`` (or the
    rank) modulo the visible devices; ``device="cpu"`` uses gloo.  A
    group that is already started is kept, if its backend is the one the
    device needs."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_distributed: a {dist.get_backend()} "
                               f"group is running; {dev} needs {backend}")
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]) if rank is None else rank,
        world_size=int(os.environ["WORLD_SIZE"]) if world_size is None
        else world_size)
    return dev


def create_mesh(axes=None, devices=None, *, device: DeviceLike = None
                ) -> Mesh:
    """The mesh ``{"dp": n}`` over the started process group (``n`` the
    world size; -1 means the world size) and make it the current one.
    ``device`` is this rank's device (by default the current CUDA device
    under NCCL, the CPU under gloo).  ``devices`` is the reference's
    device list and is not taken: the group fixes the devices."""
    if devices is not None:
        raise NotImplementedError(
            "create_mesh: devices= has no counterpart; every rank of the "
            "process group brings its own device")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group is started; call "
                           "parallel.mesh.init_distributed first")
    world = dist.get_world_size()
    axes = dict(axes or {"dp": world})
    for name in axes:
        if name not in KNOWN_AXES:
            raise ValueError(f"unknown mesh axis {name!r} (known: "
                             f"{', '.join(KNOWN_AXES)})")
    if set(axes) != {"dp"}:
        raise NotImplementedError(
            f"create_mesh({axes}): only the dp axis is ported; composed "
            f"meshes are ROADMAP queue A, item 5")
    if axes["dp"] == -1:
        axes["dp"] = world
    if axes["dp"] != world:
        raise ValueError(f"mesh {axes} needs {axes['dp']} ranks, the "
                         f"process group has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = Mesh(axes, dist.group.WORLD, torch.device(device))
    set_mesh(mesh)
    return mesh


def get_mesh() -> Mesh:
    """The current mesh; a process group started without one gets
    ``{"dp": world size}``.  Without a process group it raises: it never
    starts one."""
    if _current_mesh is None:
        if not dist.is_initialized():
            raise RuntimeError("get_mesh: no process group is started; call "
                               "parallel.mesh.init_distributed first")
        return create_mesh()
    return _current_mesh


def axis_group(axis: str):
    """``(process group, size)`` of the current mesh's axis ``axis`` (a
    sync BN's ``sync_axis``).  Outside a mesh it raises: it never starts
    one."""
    if _current_mesh is None:
        raise RuntimeError(f"axis {axis!r}: no mesh is current; call "
                           f"parallel.mesh.create_mesh first")
    if axis not in _current_mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of {_current_mesh}")
    return _current_mesh.group, _current_mesh.shape[axis]


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def data_sharding(mesh: Mesh, batch_axes=("dp",)):
    """``(rank, n)``: the block of a batch's leading dim this rank holds."""
    if tuple(batch_axes) != ("dp",):
        raise NotImplementedError("data_sharding: only the dp axis is "
                                  "ported (ROADMAP queue A, item 5)")
    return mesh.rank, mesh.shape["dp"]


def shard_rows(a, rank: int, n: int):
    """Rows ``[rank·b/n, (rank+1)·b/n)`` of ``a`` (its leading dim ``b``
    a multiple of ``n``)."""
    b = a.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split over dp={n}")
    k = b // n
    return a[rank * k:(rank + 1) * k]


def shard_batch(mesh: Mesh, batch, batch_axes=("dp",)):
    """This rank's block of every array of ``batch`` (an array, or a
    tuple, list or dict of them; ``None`` kept), as ``P("dp")`` places
    a host batch on the mesh."""
    rank, n = data_sharding(mesh, batch_axes)
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return shard_rows(batch if isinstance(batch, torch.Tensor)
                      else np.asarray(batch), rank, n)
