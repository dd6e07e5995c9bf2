"""Meshes: the production meshes, described, and real meshes over the
process group that exists.

``make_production_mesh`` is a function, never a module constant, and it
returns an :class:`AbstractMesh`: the axis names and sizes of the 16 x 16 =
256-card mesh ("data", "model") or the 2 x 16 x 16 = 512-card mesh ("pod",
"data", "model"), with no process group behind it (no process here holds
256 or 512 ranks; the JAX package's ``jax.sharding.AbstractMesh`` serves
the same purpose).  The "pod" axis carries only data parallelism (and,
optionally, the int8-compressed gradient reduction), since it rides the
slow links between pods; "data" (FSDP) and "model" (tensor and expert
parallelism) stay inside a pod.

``make_mesh`` and ``make_host_mesh`` build a real
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, whose ranks they lay out in row-major order.  Its device type is
given explicitly: "cuda" unless the caller names "cpu".  ``dp_axes`` and
``mesh_axis_sizes`` take either kind of mesh.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["AbstractMesh", "make_production_mesh", "make_mesh", "make_host_mesh",
           "axis_names", "dp_axes", "mesh_axis_sizes", "mesh_size"]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices or process group: what
    the sharding rules and the dry-run read of a mesh."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError("one size per axis name")

    @property
    def shape(self) -> Dict[str, int]:
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the default process
    group, in row-major order.  The group must exist and hold exactly
    ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {n}")
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_host_mesh(data: int = 1, model: int = 1, *, pod: Optional[int] = None,
                   device_type: str = "cuda"):
    """A small mesh over the ranks that exist (tests, one card), its sizes
    clamped as the JAX function clamps them: ``data`` at most the ranks,
    ``model`` at most what is left.  With ``pod`` the mesh is ("pod",
    "data", "model"), ``pod`` clamped first; else ("data", "model")."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if pod is not None:
        pod = max(min(pod, n), 1)
        n //= pod
    data = max(min(data, n), 1)
    model = max(min(model, n // data), 1)
    if pod is None:
        return make_mesh((data, model), ("data", "model"), device_type)
    return make_mesh((pod, data, model), ("pod", "data", "model"), device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the batch (data-parallel) dimension."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
