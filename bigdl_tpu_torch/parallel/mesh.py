"""The device mesh over ``torch.distributed`` (≙
``bigdl_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the chips one program
sees.  Here each rank is a process with one device, and a mesh names the
axes of the process group that joins them: :func:`init_distributed`
starts the group (NCCL for ``cuda``, gloo for ``device="cpu"``; from the
arguments, or from ``torchrun``'s environment), :func:`create_mesh` lays
the ranks out over the axes.  ``virtual_devices`` has no counterpart: the
CPU tests run gloo ranks.

Axes (:data:`KNOWN_AXES`): ``dp`` data parallel, ``fsdp`` sharded data
parallel, ``sp`` sequence parallel (the ring), ``tp`` tensor parallel,
``pp`` pipeline (the stages of
:class:`~bigdl_tpu_torch.parallel.pipeline.PipelineLMTrainer`, which
sends activations to the next stage, :meth:`Mesh.pp_neighbours`) and
``ep`` expert parallel (an MoE layer's experts).  The layout is the
reference's: the ranks are
laid out row-major over the axes in the order given, ``dp`` outermost, so
rank ``r``'s coordinate on each axis is ``np.unravel_index(r, sizes)``.
Every rank makes a process group for each set of axes larger than 1 (the
ranks that differ only on those axes), so that a collective over ``tp``
or over ``dp × sp`` is one call (:meth:`Mesh.group_of`).

A batch splits as the reference's ``P(("dp", "fsdp"), "sp")`` splits it:
its leading dim over the data axes (row-major, ``dp`` outer), its
sequence dim over ``sp`` (:func:`data_sharding`, :func:`shard_batch`).
"""
from __future__ import annotations

import itertools
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

KNOWN_AXES = ("dp", "fsdp", "sp", "tp", "pp", "ep")
# data axes re-batch the same math; model axes re-partition tensors
DATA_AXES = ("dp", "fsdp")
MODEL_AXES = ("sp", "tp", "pp", "ep")

_TEMPLATE_RE = re.compile(r"([a-z]+)\s*[=:]?\s*(\d+)")

_current_mesh: Optional["Mesh"] = None


def parse_template(template) -> Dict[str, int]:
    """One composed-mesh spelling -> ordered ``{axis: size}``: a dict, or
    a string such as ``"dp2x tp2 x pp2"``, ``"dp2,tp2,pp2"``,
    ``"dp=2 tp=2 pp=2"`` or ``"dp2×tp2×pp2"``.  Axis names come from
    :data:`KNOWN_AXES`, sizes are >= 1, and every character is consumed
    (``"dpp2"`` raises)."""
    if isinstance(template, dict):
        pairs = [(str(k), int(v)) for k, v in template.items()]
    else:
        s = str(template).strip().lower()
        # an 'x' right after a size is a separator, not a name's start
        s = re.sub(r"(?<=\d)\s*[x×*,]+\s*", " ", s)
        pairs = [(n, int(v)) for n, v in _TEMPLATE_RE.findall(s)]
        leftover = _TEMPLATE_RE.sub("", s)
        if not pairs or leftover.strip(" ,x×*") != "":
            raise ValueError(
                f"unparseable mesh template {template!r} (expected "
                "e.g. 'dp2,tp2,pp2' or 'dp=2 x tp=2')")
    out: Dict[str, int] = {}
    for name, size in pairs:
        if name not in KNOWN_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} in template {template!r} "
                f"(known: {', '.join(KNOWN_AXES)})")
        if name in out:
            raise ValueError(f"duplicate axis {name!r} in {template!r}")
        if size < 1:
            raise ValueError(f"axis {name!r} has size {size}")
        out[name] = size
    return out


def _rows(sizes, names, subset):
    """The rank lists of the groups over the axes ``subset``: ranks that
    agree on every other axis, each list row-major over ``subset``."""
    world = int(np.prod(sizes, dtype=np.int64))
    arr = np.arange(world).reshape(sizes)
    other = [i for i, n in enumerate(names) if n not in subset]
    sub = [i for i, n in enumerate(names) if n in subset]
    n_sub = int(np.prod([sizes[i] for i in sub], dtype=np.int64))
    return arr.transpose(other + sub).reshape(-1, n_sub).tolist()


class Mesh:
    """Named axes over the ranks of a process group.

    ``shape`` maps each axis to its size, ``rank`` is this process's rank
    in ``group`` (the whole mesh), ``coords`` its coordinate on each axis,
    ``device`` its device.  :meth:`group_of` gives the process group over
    a set of axes."""

    def __init__(self, axes: Dict[str, int], group, device: torch.device):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        sizes = [self.shape[a] for a in self.axis_names]
        self.size = int(np.prod(sizes, dtype=np.int64))
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, sizes))))
        # one group for each set of axes larger than 1; every rank makes
        # every group in the same order, as new_group requires
        big = [a for a in self.axis_names if self.shape[a] > 1]
        self._groups = {}
        for n in range(1, len(big) + 1):
            for subset in itertools.combinations(big, n):
                rows = _rows(sizes, self.axis_names, subset)
                if len(rows) == 1:      # the whole mesh
                    self._groups[subset] = group
                    continue
                for row in rows:
                    g = dist.new_group(row)
                    if self.rank in row:
                        self._groups[subset] = g

    def group_labels(self) -> Dict[object, str]:
        """``{process group: label}`` for this rank's groups: the axes a
        group spans joined by ``×`` (``"dp"``, ``"dp×tp"``), ``"all"`` for
        the whole mesh over more than one axis (the reference's
        ``replica_group_label``)."""
        big = tuple(a for a in self.axis_names if self.shape[a] > 1)
        return {g: ("all" if axes == big and len(big) > 1
                    else "×".join(axes))
                for axes, g in self._groups.items()}

    def group_of(self, axes: Sequence[str]) -> Tuple[object, int, int]:
        """``(group, size, index)`` over ``axes`` (those of the mesh): the
        process group of the ranks that differ from this one only on those
        axes, its size, and this rank's index in it (row-major over the
        axes, in the mesh's order).  The group is None when the size is 1:
        there is nothing to communicate."""
        axes = tuple(a for a in self.axis_names
                     if a in tuple(axes) and self.shape[a] > 1)
        if not axes:
            return None, 1, 0
        size = int(np.prod([self.shape[a] for a in axes], dtype=np.int64))
        index = int(np.ravel_multi_index(
            [self.coords[a] for a in axes], [self.shape[a] for a in axes]))
        return self._groups[axes], size, index

    def pp_neighbours(self) -> Tuple[Optional[int], Optional[int]]:
        """The ranks (in the mesh's group) one step before and after this
        one on ``pp``, every other coordinate equal; None past either end
        (and both None without a ``pp`` axis)."""
        if "pp" not in self.shape:
            return None, None
        sizes = [self.shape[a] for a in self.axis_names]
        out = []
        for step in (-1, 1):
            c = dict(self.coords)
            c["pp"] += step
            out.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], sizes))
                if 0 <= c["pp"] < self.shape["pp"] else None)
        return out[0], out[1]

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
    """The mesh ``axes`` (``{axis: size}`` or a template string, see
    :func:`parse_template`; one size may be -1, the world size over the
    others; default ``{"dp": world}``) over the started process group,
    made the current one.  The sizes multiply to the world size.
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
    if isinstance(axes, str):
        axes = parse_template(axes)
    axes = dict(axes or {"dp": world})
    for name in axes:
        if name not in KNOWN_AXES:
            raise ValueError(f"unknown mesh axis {name!r} (known: "
                             f"{', '.join(KNOWN_AXES)})")
    wild = [a for a, n in axes.items() if n == -1]
    if len(wild) > 1:
        raise ValueError(f"mesh {axes}: at most one axis may be -1")
    known = int(np.prod([n for n in axes.values() if n != -1],
                        dtype=np.int64))
    if wild:
        axes[wild[0]] = world // max(known, 1)
    total = int(np.prod(list(axes.values()), dtype=np.int64))
    if total != world:
        raise ValueError(f"mesh {axes} needs {total} ranks, the process "
                         f"group has {world}")
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
    group, size, _ = _current_mesh.group_of((axis,))
    return group, size


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh


def data_sharding(mesh: Mesh, batch_axes=("dp",)):
    """``(index, n)``: the block of a batch's leading dim this rank holds,
    split over ``batch_axes`` (those of the mesh) row-major, as
    ``P(batch_axes)`` splits it."""
    _, n, index = mesh.group_of(batch_axes)
    return index, n


def shard_rows(a, rank: int, n: int, dim: int = 0):
    """Block ``rank`` of ``n`` of ``a`` along ``dim`` (a multiple of
    ``n``)."""
    b = a.shape[dim]
    if b % n:
        raise ValueError(f"dim {dim} of {b} does not split over {n} ranks")
    k = b // n
    index = [slice(None)] * dim + [slice(rank * k, (rank + 1) * k)]
    return a[tuple(index)]


def shard_batch(mesh: Mesh, batch, batch_axes=("dp",),
                seq_axis: Optional[str] = None):
    """This rank's block of every array of ``batch`` (an array, or a
    tuple, list or dict of them; ``None`` kept), as
    ``P(batch_axes, seq_axis)`` places a host batch on the mesh: the
    leading dim over ``batch_axes``, dim 1 over ``seq_axis`` when it is
    an axis of the mesh."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, batch_axes, seq_axis)
                for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v, batch_axes, seq_axis)
                           for v in batch)
    a = batch if isinstance(batch, torch.Tensor) else np.asarray(batch)
    index, n = data_sharding(mesh, batch_axes)
    a = shard_rows(a, index, n)
    if seq_axis is not None and seq_axis in mesh.shape:
        a = shard_rows(a, mesh.coords[seq_axis], mesh.shape[seq_axis], 1)
    return a
