"""Process groups of the port (counterpart of ``repro.launch.mesh``): the
``(data, model)`` device mesh, and the expert-parallel group.

A :class:`Mesh` owns the world: :func:`init_mesh` initializes it once and
builds a ``torch.distributed`` ``DeviceMesh`` named ``("data", "model")``
or ``("pod", "data", "model")``, ranks laid out row-major; ``close``
destroys the world and every group on it.  Each axis has its group
(``group(axis)``), which the FSDP collectives of ``parallel.fsdp`` use
directly.  ``mesh.ep_group()`` is the ``model`` axis as an
:class:`EPGroup` for ``moe_block_ep`` and ``core.overlap``; closing that
leaves the world up.

:func:`init_ep_group` is the expert-parallel group alone: the whole world
seen as the ``model`` axis, which it owns and destroys on ``close``.

On the card a world is NCCL, one GPU a rank (``torch.cuda.set_device``
first); on the CPU, which only the tests and ``--device cpu`` ask for, it
is gloo.  :func:`init_fake_mesh` is one rank's view of a world of any
size over torch's fake process group, whose collectives move nothing:
the dry-run's (``launch.dryrun``), with tensors on the meta device.  The caller gives the store: a ``HashStore`` at world size 1 (the
default, no network), a ``FileStore`` shared by spawned ranks, or
torchrun's environment (the ``*_from_env`` functions).  NCCL cannot put
two ranks on one GPU, so a world above 1 on the card needs as many cards.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

# The reference's production layouts (16 x 16 chips, or two such pods), as
# axis sizes for ``parallel.sharding.fit_*``; :func:`init_fake_mesh` builds
# them for the dry-run.
PRODUCTION_SHAPES = ({"data": 16, "model": 16},
                     {"pod": 2, "data": 16, "model": 16})


@dataclass
class EPGroup:
    """A process group seen as the expert-parallel axis.

    ``group`` is what ``moe_block_ep`` and ``core.overlap`` take.  When
    ``owns_world`` (:func:`init_ep_group`), ``close`` (or leaving a
    ``with`` block) destroys the default group and every group on it; a
    mesh's ``ep_group()`` does not own it."""
    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_world: bool = True

    def close(self) -> None:
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "EPGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _init_world(device, local_rank: int, **kwargs):
    """Initialize the default group; returns (device, backend)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, **kwargs)
    return dev, backend


def _store(store, rank: int, world_size: int, who: str):
    if store is not None:
        return store
    if world_size != 1:
        raise ValueError(f"{who}: world_size {world_size} needs a store the "
                         f"ranks share (FileStore or TCPStore)")
    return dist.HashStore()


def _ep(device, local_rank: int, **kwargs) -> EPGroup:
    dev, backend = _init_world(device, local_rank, **kwargs)
    return EPGroup(group=dist.group.WORLD, rank=dist.get_rank(),
                   size=dist.get_world_size(), device=dev, backend=backend)


def init_ep_group(device=None, *, store=None, rank: int = 0,
                  world_size: int = 1) -> EPGroup:
    """An EP group of ``world_size`` ranks on ``device`` (the card unless
    ``"cpu"``).  ``store=None`` means a ``HashStore``, which only a world of
    one rank can share.  On the card, rank ``r`` takes GPU ``r`` unless
    ``device`` names one."""
    return _ep(device, rank, rank=rank, world_size=world_size,
               store=_store(store, rank, world_size, "init_ep_group"))


def init_ep_group_from_env(device=None) -> EPGroup:
    """The EP group of a ``torchrun`` launch: rank, world size and the
    store's address from its environment, GPU ``LOCAL_RANK`` on the
    card."""
    return _ep(device, int(os.environ.get("LOCAL_RANK", 0)),
               init_method="env://")


class Mesh:
    """A device mesh that owns the world: axis sizes, groups, this rank's
    coordinates.  ``shape`` maps axis name to size, as the reference's
    ``mesh.shape`` does."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.mesh.shape))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.get_coordinate()))
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        # collectives issued by parallel.fsdp and parallel.tp, by kind,
        # and by axis ("world" for the whole mesh), then kind
        self.collectives: Dict[str, int] = {}
        self.axis_collectives: Dict[str, Dict[str, int]] = {}

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(axis)

    def reset_collectives(self) -> None:
        """Set both counts of collectives to 0."""
        self.collectives.clear()
        self.axis_collectives.clear()

    def ep_group(self) -> EPGroup:
        """The ``model`` axis as an expert-parallel group; its ``close``
        leaves the world up."""
        return EPGroup(group=self.group("model"), rank=self.coords["model"],
                       size=self.shape["model"], device=self.device,
                       backend=self.backend, owns_world=False)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend})")


def _axes(shape, multi_pod: bool) -> Tuple[str, ...]:
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not name the axes "
                         f"{axes}")
    return axes


def _mesh(dev, backend, shape, axes, mesh_device=None) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape) != world:
        dist.destroy_process_group()
        raise ValueError(f"mesh shape {tuple(shape)} needs {math.prod(shape)}"
                         f" ranks, the world has {world}")
    dm = init_device_mesh(mesh_device or dev.type, tuple(shape),
                          mesh_dim_names=axes)
    return Mesh(dm, dev, backend)


def init_mesh(device=None, *, shape=(1, 1), multi_pod: bool = False,
              store=None, rank: int = 0) -> Mesh:
    """Initialize the world once and build its mesh: ``shape`` is ``(data,
    model)``, or ``(pod, data, model)`` with ``multi_pod``, and the world
    size is its product.  NCCL on the card (rank ``r`` on GPU ``r``), gloo
    for ``"cpu"``; ``store=None`` means a ``HashStore`` (world size 1)."""
    axes = _axes(shape, multi_pod)
    world = math.prod(shape)
    dev, backend = _init_world(
        device, rank, rank=rank, world_size=world,
        store=_store(store, rank, world, "init_mesh"))
    return _mesh(dev, backend, shape, axes)


def init_fake_mesh(shape=(16, 16), *, multi_pod: bool = False,
                   rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a mesh of ``prod(shape)`` ranks over torch's
    fake process group (a ``FakeStore``, no network): every collective
    returns at once and moves nothing.  The mesh's device is ``meta``, for
    the step's tensors; its ``DeviceMesh`` is built on ``"cpu"``, which
    allocates nothing.  ``close`` destroys the world as ``init_mesh``'s
    does."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    axes = _axes(shape, multi_pod)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    return _mesh(torch.device("meta"), "fake", shape, axes,
                 mesh_device="cpu")


def init_mesh_from_env(device=None, *, shape=(1, 1),
                       multi_pod: bool = False) -> Mesh:
    """The mesh of a ``torchrun`` launch (rank, world size and store from
    its environment, GPU ``LOCAL_RANK`` on the card)."""
    axes = _axes(shape, multi_pod)
    dev, backend = _init_world(device, int(os.environ.get("LOCAL_RANK", 0)),
                               init_method="env://")
    return _mesh(dev, backend, shape, axes)


def make_local_mesh(model_axis: int = 1, device=None) -> Mesh:
    """The ranks of this launch as ``(data, model)`` with ``model_axis``
    ranks on ``model``: torchrun's world when its environment is set, else
    one rank (a ``HashStore``)."""
    if "WORLD_SIZE" not in os.environ:
        return init_mesh(device, shape=(1, model_axis))
    world = int(os.environ["WORLD_SIZE"])
    if world % model_axis:
        raise ValueError(f"make_local_mesh: {world} ranks do not split into "
                         f"a model axis of {model_axis}")
    return init_mesh_from_env(device, shape=(world // model_axis,
                                             model_axis))
