"""Process groups and the 1-D device mesh for multi-card rendering (the JAX
package's ``parallel/mesh.py``).

The reference's only parallelism is 8 pthreads over row blocks
(src/main.cpp:15, 38-39).  The JAX package drives every device from one
process through a ``tiles`` mesh axis; here each card has a process of its
own under ``torch.distributed``, and the mesh is a 1-D ``DeviceMesh`` named
``("tiles",)`` over the ranks.  Pixels are split on it by ``shard_bounds``;
the scene is replicated (each rank packs it); images are joined by an
all-gather and gradients by an all-reduce.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
Asking for ``cuda`` without a card or without NCCL raises; nothing falls
back to gloo or to the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

TILE_AXIS = "tiles"
# the rendezvous's and the process group's time limit
TIMEOUT = datetime.timedelta(seconds=60)


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU; raises when the
    device has no usable backend here."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL here; the card's "
                               "backend is NCCL (pass device='cpu' for gloo)")
        return "nccl"
    if dev.type == "cpu" and dist.is_gloo_available():
        return "gloo"
    raise RuntimeError(f"no torch.distributed backend for {dev}")


def initialize_distributed(backend: str | None = None, device=None,
                           **kwargs) -> bool:
    """Initialise the default process group unless one exists: from the
    environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), from ``kwargs`` (those of
    ``init_process_group``: ``init_method``, ``store``, ``rank``,
    ``world_size``, ...), or, when neither is given, as a group of one
    rank.  The backend is ``device``'s (default ``cuda``), and a
    ``backend`` that is not raises.  On ``cuda`` the process takes the card
    ``LOCAL_RANK``.  The counterpart of JAX ``mesh.py:36-40``.  Returns
    whether it made the group (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    want = backend_for(device)
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} for {resolve_device(device)}: "
                         f"the device's backend is {want!r}")
    if want == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs.setdefault("timeout", TIMEOUT)
    if "WORLD_SIZE" not in os.environ and not (
            {"init_method", "store"} & kwargs.keys()):
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group(want, **kwargs)
    return True


def make_device_mesh(n_devices: int | None = None, device=None):
    """The 1-D ``DeviceMesh`` named ``("tiles",)`` over every rank of the
    default process group; ``n_devices``, when given, must be the world
    size.  The group must exist (``initialize_distributed``, whose caller
    destroys it): a mesh made here never leaves a group behind.  The
    counterpart of JAX ``mesh.py:20-25``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first and destroy_process_group after, or run "
                           "under torchrun")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices {n_devices}: the process group has "
                         f"{world} ranks (one process per device)")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(TILE_AXIS,))


def mesh_ranks(mesh, device):
    """(process group, rank, world size) of a 1-D mesh; with ``mesh``
    None, of ``make_device_mesh`` over the default group, which must
    exist."""
    if mesh is None:
        mesh = make_device_mesh(device=device)
    return mesh.get_group(), mesh.get_local_rank(), mesh.size()


# all_gather_into_tensor, named all_gather_single from torch 2.13 on
_gather_single = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)


def all_gather(part: torch.Tensor, world: int, group) -> torch.Tensor:
    """Every rank's ``part`` (all of one shape) joined along dim 0, in rank
    order."""
    out = part.new_empty((world * part.shape[0], *part.shape[1:]))
    _gather_single(out, part.contiguous(), group=group)
    return out


def shard_bounds(total: int, world: int, rank: int,
                 multiple: int = 8) -> tuple[int, int]:
    """Rank ``rank``'s range ``[lo, hi)`` of a flat list of ``total``
    items split over ``world`` ranks: contiguous, every range of one
    length, a multiple of ``multiple``; the ranges cover ``total`` padded
    up to ``world * multiple`` items (JAX ``shard_render.py:76-80``).  The
    items past ``total`` are padding: a rank computes ``[lo, min(hi,
    total))`` and pads its part to ``hi - lo`` rows."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}")
    step = world * multiple
    per = -(-total // step) * multiple
    return rank * per, (rank + 1) * per
