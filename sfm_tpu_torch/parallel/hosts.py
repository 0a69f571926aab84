"""Process groups and the scan x map mesh over ``torch.distributed``.

One rank is one process with one device: a card under NCCL (which takes
one rank per card), or the CPU under gloo (``device="cpu"``).  Where the
JAX package has ``jax.distributed.initialize`` and a ``Mesh`` of devices,
this module has ``init_process_group`` and a 2D ``DeviceMesh`` of ranks
with the dimensions ("scan", "map"): scans are split over "scan", the
landmarks of a distributed BA problem over "map"."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..engine.state import resolve_device

__all__ = ["all_sum", "axis_shard", "initialize_hosts", "make_scan_map_mesh",
           "rank_device"]

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _backend_for(device) -> str:
    """The collective backend of ranks on ``device``: NCCL for a card,
    gloo for the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU for ``device="cpu"``; on the card
    (raises without one) ``cuda:{local % device_count}``, where ``local``
    is torchrun's ``LOCAL_RANK`` or, where that is unset (a cluster given
    explicitly), the rank in the world: ``rank``, else the initialised
    group's rank, else 0.  A host's ranks then take its cards in order."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif rank is not None:
        local = rank
    else:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", local % torch.cuda.device_count())


def axis_shard(mesh, axis: str):
    """(group, this rank's position on ``axis``, the axis size)."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def all_sum(group, *ts):
    """The sums over ``group`` of the tensors ``ts`` (one dtype), by one
    ``all_reduce`` of them packed into a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return tuple(out)


def initialize_hosts(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda") -> None:
    """Initialise the default process group: NCCL on the card (one rank
    per card), gloo for ``device="cpu"``.  On the card this rank's device
    is made current first (``rank_device``: torchrun's ``LOCAL_RANK``, or
    for an explicit cluster ``process_id``, modulo the host's cards).

    Explicit arguments join the cluster at ``tcp://{coordinator}`` as rank
    ``process_id`` of ``num_processes``.  Without them, torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (``env://``) are used when
    set; with no cluster in the environment a warning is logged and the
    process stays single-process.  A group that is already initialised is
    left as it is.  A configured cluster that fails to initialise raises
    ``RuntimeError``: running on alone would corrupt a distributed run."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = _backend_for(dev)
    explicit = not (coordinator is None and num_processes is None)
    try:
        if explicit:
            if coordinator is None or num_processes is None \
                    or process_id is None:
                raise ValueError("coordinator, num_processes and process_id "
                                 "are all needed for an explicit cluster")
            if not 0 <= process_id < num_processes:
                raise ValueError(f"process_id {process_id} is not a rank of "
                                 f"{num_processes} processes")
            if dev.type == "cuda":
                torch.cuda.set_device(rank_device(dev, process_id))
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id)
        elif all(k in os.environ for k in _TORCHRUN):
            if dev.type == "cuda":
                torch.cuda.set_device(rank_device(
                    dev, int(os.environ["RANK"])))
            dist.init_process_group(backend, init_method="env://")
        else:
            logging.getLogger(__name__).warning(
                "initialize_hosts: no cluster in the environment (torchrun's "
                "%s are not set); continuing single-process (pass "
                "coordinator / num_processes / process_id for a manual "
                "cluster)", "/".join(_TORCHRUN))
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"torch.distributed initialisation failed for a configured "
            f"cluster ({backend}): {e}") from e


def make_scan_map_mesh(n_scan: Optional[int] = None, *, device="cuda"):
    """A 2D ``DeviceMesh`` over every rank, dimensions ("scan", "map").

    ``n_scan`` defaults to the number of hosts, ``world_size //
    LOCAL_WORLD_SIZE`` (without that variable the local world is the
    card count, or the whole world on the CPU), so that a host's scans
    stay on the host and the map axis stays within it; it is stepped down
    until it divides the world size.  Without a process group (no
    ``initialize_hosts`` cluster) the mesh is a world of one on an
    in-process store.  Gloo ranks get a CPU-typed mesh whatever their
    device: gloo carries CUDA tensors through the host, and the mesh then
    makes no NCCL group."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    if not dist.is_initialized():
        dist.init_process_group(_backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    mesh_type = "cpu" if dist.get_backend() == "gloo" else dev.type
    n = dist.get_world_size()
    if n_scan is None:
        local = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            torch.cuda.device_count() if dev.type == "cuda" else n))
        n_scan = max(n // max(local, 1), 1)
    n_scan = max(n_scan, 1)
    while n % n_scan != 0:
        n_scan -= 1
    return init_device_mesh(mesh_type, (n_scan, n // n_scan),
                            mesh_dim_names=("scan", "map"))
