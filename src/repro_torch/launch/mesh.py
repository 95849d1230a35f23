"""Mesh construction: a ``DeviceMesh`` with named dims.

Counterpart of ``repro.launch.mesh``.  JAX's single controller lays a
mesh over however many devices it sees; torch runs one process per rank
(SPMD), so a mesh here spans the ranks of the default process group,
which the caller sets up first (``torch.distributed.init_process_group``
with its address, world size and rank: nothing on the machine announces
a cluster).  A FUNCTION, not a module-level constant, so importing this
module touches no device and no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .. import device as _device


def _make_mesh(shape: tuple, axes: tuple, device=None):
    """A mesh of ``shape`` named ``axes`` over every rank, on the card
    unless ``device`` is the CPU (:func:`repro_torch.device.resolve`).
    Raises when the world size is not the mesh's product, as JAX raises
    with too few devices."""
    dev = _device.resolve(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh {axes} spans the ranks of the default process "
            "group: call torch.distributed.init_process_group first (one "
            "process per rank)")
    world, n = dist.get_world_size(), math.prod(shape)
    if world != n:
        raise ValueError(f"a {shape} mesh {axes} needs {n} ranks; the "
                         f"process group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Production meshes: 16x16 = 256 ranks a pod; 2 pods = 512.

    Axes are roles (DESIGN.md §5): `data` = DP/FSDP/SP, `model` = TP/EP;
    `pod` is the outer DP (or pipeline) axis across the slower inter-pod
    links.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """Small (data, model) mesh — used by tests (gloo ranks on the CPU)
    and by the card's world-size-1 run."""
    return _make_mesh((data, model), ("data", "model"), device)
