"""Device meshes (counterpart of ``repro/launch/mesh.py``): local meshes for
sharded retrieval, and the production meshes of the dry-run.

The reference is single-controller: one process drives every local device
through ``shard_map``.  The port is too.  One process holds each shard's
tensors on that shard's device, launches each shard's kernels there, and
copies every shard's ``[b, k]`` candidates to the first device for the merge
(``repro_torch.dist``).  It is not ``torch.distributed`` with one rank per
GPU: the reference has no multi-host path, and NCCL refuses two ranks on one
GPU, so a design of one process per GPU could never be checked on one card.

A ``Mesh`` may name one device several times, each entry one shard: the
counterpart of XLA's ``--xla_force_host_platform_device_count``, which runs
several shards on one device (the CPU tests, and 4 or 7 shards on one card).
``make_production_mesh`` gives the reference's production meshes (16 x 16
over ``("data", "model")``, 2 x 16 x 16 with ``"pod"``) as a ``MeshShape``:
axis names and sizes and no devices, what the dry-run
(``launch/dryrun.py``) divides each leaf's dims by.  Functions, not module
constants: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Tuple

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards' devices, in shard order, on one data axis."""

    devices: Tuple[torch.device, ...]
    axis_names: ClassVar[Tuple[str, ...]] = ("data", "model")

    def __post_init__(self) -> None:
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @staticmethod
    def repeat(device: torch.device | str, count: int) -> "Mesh":
        """``count`` shards on one device."""
        return Mesh((resolve_device(device),) * int(count))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

    @property
    def groups(self) -> Tuple[Tuple[torch.device, Tuple[int, ...]], ...]:
        """(device, its shards) for each distinct device, in order of first
        appearance: the first device, which merges, comes first."""
        order = list(dict.fromkeys(self.devices))
        return tuple((d, tuple(s for s, e in enumerate(self.devices) if e == d))
                     for d in order)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh that holds a shape and no devices: its axes' names and sizes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(math.prod(self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The single-pod 16 x 16 (``data``, ``model``) mesh, or with ``multi_pod``
    the 2 x 16 x 16 (``pod``, ``data``, ``model``) one."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(device: torch.device | str = "cuda") -> Mesh:
    """One shard per local device: every CUDA device (no fallback: raises
    without CUDA), or the host alone for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,))
    return Mesh(tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())))


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axes_entry(axes):
    """A spec entry (``dist.sharding``) splitting a dim over ``axes``: one
    name stays a name."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def has_pod(mesh) -> bool:
    return "pod" in mesh.axis_names
