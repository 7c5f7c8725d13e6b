"""The device mesh (port of deepinv_tpu/parallel/context.py).

The JAX package is single-controller: one program owns a ``jax.sharding.Mesh``
of named axes and ``shard_map`` places work on its devices. The port keeps
that program model. One process owns a mesh of torch devices, a numpy object
array of ``torch.device`` shaped like the mesh, with named axes, and the
parallel layer sends each shard to its mesh device with ``.to()``. There are
no process groups and no DTensor, so the CPU tests hold the port against the
JAX package's 8 virtual devices in one process, with a mesh over
``[cpu] * 8``. A mesh entry may repeat a device (``[cuda:0] * 2`` runs a
two-way split on one card); nothing assumes the entries differ.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["DistributedContext", "Placement", "replica"]


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh (the counterpart of ``NamedSharding``):
    ``spec[d]`` is the mesh axis that dim ``d`` is chunked over, or None; an
    empty spec is replicated."""

    ctx: "DistributedContext"
    spec: tuple

    def split(self, t: torch.Tensor) -> list:
        """``t`` as ``[(device, chunk), ...]``: chunked over the first sharded
        dim's mesh axis in order (``torch.tensor_split``: the leading chunks
        one longer where the size does not divide), each chunk on its device;
        a replicated placement gives one copy a device of the mesh's first
        axis."""
        dims = [(d, a) for d, a in enumerate(self.spec) if a is not None]
        if not dims:
            devs = self.ctx.axis_devices()
            return [(dev, t.to(dev, non_blocking=True)) for dev in devs]
        d, axis = dims[0]
        devs = self.ctx.axis_devices(axis)
        return [(dev, c.to(dev, non_blocking=True))
                for dev, c in zip(devs, torch.tensor_split(t, len(devs), dim=d))]


class DistributedContext:
    """A mesh of torch devices with named axes
    (deepinv_tpu/parallel/context.py:24).

    :param axis_names: mesh axis names, e.g. ``("op",)`` for operator
        parallelism, ``("dp", "sp")`` for data x spatial.
    :param shape: devices per axis (default: every device on the first axis).
    :param devices: the devices, in mesh order; default every CUDA device.
        Without CUDA it raises: pass ``devices=[torch.device("cpu")] * n``.
    """

    def __init__(self, axis_names: Sequence[str] = ("op",), shape: Optional[Sequence[int]] = None,
                 devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError('DistributedContext uses every CUDA device by default and '
                                   'none is available: pass devices=[torch.device("cpu")] * n')
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        axis_names = tuple(axis_names)
        if shape is None:
            shape = (len(devices),) + (1,) * (len(axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
        n = int(np.prod(shape))
        if n > len(devices):
            raise ValueError(f"a mesh of shape {shape} needs {n} devices, got {len(devices)}")
        mesh = np.empty(n, dtype=object)
        mesh[:] = devices[:n]
        self.devices = mesh.reshape(shape)
        self.axis_names = axis_names

    # -- the JAX package's API (context.py:60-86) -------------------------
    @property
    def world_size(self) -> int:
        return self.devices.size

    @property
    def rank(self) -> int:
        return 0  # single controller: one logical program

    def local_indices(self, n: int, axis: Optional[str] = None):
        """Round-robin index shards, one list a device of ``axis``
        (context.py:64)."""
        size = self.axis_size(axis)
        return [list(range(r, n, size)) for r in range(size)]

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.devices.shape[self._axis(axis)]

    def axis_devices(self, axis: Optional[str] = None) -> list:
        """The devices along ``axis`` (the first entry of every other axis):
        where a computation sharded over that axis alone runs."""
        a = self._axis(axis)
        return list(np.moveaxis(self.devices, a, 0).reshape(self.devices.shape[a], -1)[:, 0])

    def sharding(self, *spec) -> Placement:
        return Placement(self, tuple(spec))

    def replicated(self) -> Placement:
        return Placement(self, ())

    def _axis(self, axis: Optional[str]) -> int:
        axis = axis or self.axis_names[0]
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the mesh has {self.axis_names}")
        return self.axis_names.index(axis)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def replica(module, device):
    """``module`` on ``device``: the module itself where it is not an
    ``nn.Module`` or holds no tensor off ``device``, else a deep copy moved
    there (the caller keeps it: a copy does not follow later changes of the
    original's weights)."""
    if not isinstance(module, torch.nn.Module):
        return module
    device = torch.device(device)
    tensors = list(module.parameters()) + list(module.buffers())
    if all(_same_device(t.device, device) for t in tensors):
        return module
    return copy.deepcopy(module).to(device)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card where the current card is 0."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)
