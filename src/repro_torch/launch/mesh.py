"""The expert-parallel process group (counterpart of
``repro.launch.mesh.make_local_mesh``).

The reference's ``model`` mesh axis becomes a ``torch.distributed`` group
of ``world_size`` ranks, one expert shard each.  On the card the group is
NCCL, one GPU a rank (``torch.cuda.set_device`` first); on the CPU, which
only the tests and ``--device cpu`` ask for, it is gloo.  The caller gives
the store: a ``HashStore`` at world size 1 (the default, no network), a
``FileStore`` shared by spawned ranks, or torchrun's environment
(:func:`init_ep_group_from_env`).  NCCL cannot put two ranks on one GPU, so
a world above 1 on the card needs as many cards.

The EP axis is the whole world: :class:`EPGroup` owns the default process
group, and closing it destroys that group and every group made on it.
There is no data axis beside it yet, as ``make_local_mesh``'s ``(data,
model)`` mesh has; sharding with FSDP needs the EP ranks as a
``dist.new_group`` under a mesh object that owns the world.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class EPGroup:
    """The default process group, seen as the expert-parallel axis.

    ``group`` is what ``moe_block_ep`` and ``core.overlap`` take; ``close``
    (or leaving a ``with`` block) destroys the default group, and with it
    any other group on the same world."""
    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "EPGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _init(device, local_rank: int, **kwargs) -> EPGroup:
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, **kwargs)
    return EPGroup(group=dist.group.WORLD, rank=dist.get_rank(),
                   size=dist.get_world_size(), device=dev, backend=backend)


def init_ep_group(device=None, *, store=None, rank: int = 0,
                  world_size: int = 1) -> EPGroup:
    """An EP group of ``world_size`` ranks on ``device`` (the card unless
    ``"cpu"``).  ``store=None`` means a ``HashStore``, which only a world of
    one rank can share.  On the card, rank ``r`` takes GPU ``r`` unless
    ``device`` names one."""
    if store is None:
        if world_size != 1:
            raise ValueError(f"init_ep_group: world_size {world_size} needs "
                             f"a store the ranks share (FileStore or "
                             f"TCPStore)")
        store = dist.HashStore()
    return _init(device, rank, store=store, rank=rank,
                 world_size=world_size)


def init_ep_group_from_env(device=None) -> EPGroup:
    """The EP group of a ``torchrun`` launch: rank, world size and the
    store's address from its environment, GPU ``LOCAL_RANK`` on the
    card."""
    return _init(device, int(os.environ.get("LOCAL_RANK", 0)),
                 init_method="env://")
