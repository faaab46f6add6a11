"""The mesh on ``torch.distributed``: a world of ranks, the placement of
arrays on it, and the two collectives.

The PyTorch counterpart of the mesh half of
``reconstructor_tpu.parallel.sharding``. The JAX package lays work on a
batch axis and shards it over a 1-D device mesh in one process; here the
mesh is a world of ranks, one process per device, joined by a process
group:

- NCCL when every rank has a card of its own;
- gloo on the CPU, and for several ranks that share one card (NCCL
  refuses two ranks on one device).

A process with no initialised group is the trivial world of one. Every
rank passes the same global host arrays; ``shard_batch`` takes this
rank's slice of the leading axis and ``replicate`` the whole array, both
on the rank's device.

Two collectives carry all the traffic: ``all_sum`` (one ``all_reduce``
over one or more tensors) and ``all_gather`` (rank slices concatenated in
rank order). Every rank must reach each of them the same number of times:
a rank whose slice holds only padding still runs it, and loop exits come
from reduced values. ``ALL_REDUCES`` and ``ALL_GATHERS`` count the calls
that reached a process group (``counts``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from reconstructor_tpu_torch.utils import device as devices, profiling

AXIS = "shard"
# seconds a collective (or the rendezvous) may wait before it raises
DEFAULT_TIMEOUT_S = 300.0

ALL_REDUCES = 0
ALL_GATHERS = 0
ALL_REDUCE_BYTES = 0
ALL_GATHER_BYTES = 0


def reset_counts() -> None:
    global ALL_REDUCES, ALL_GATHERS, ALL_REDUCE_BYTES, ALL_GATHER_BYTES
    ALL_REDUCES = 0
    ALL_GATHERS = 0
    ALL_REDUCE_BYTES = 0
    ALL_GATHER_BYTES = 0


def counts() -> dict:
    """The collective calls that reached a process group since
    ``reset_counts``, and the bytes this rank contributed to them."""
    return {"all_reduce": ALL_REDUCES, "all_gather": ALL_GATHERS,
            "all_reduce_bytes": ALL_REDUCE_BYTES, "all_gather_bytes": ALL_GATHER_BYTES}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, this rank, the world size, the
    backend (``"nccl"``, ``"gloo"``, or ``"none"`` for the world of one
    without a group) and this rank's device."""
    group: Optional[object]
    rank: int
    size: int
    backend: str
    device: torch.device


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """``cuda`` without an index means this rank's own card
    (``cuda:LOCAL_RANK``, the rank when unset); ``cuda:i`` is a card that
    ranks may share; ``cpu`` is the host."""
    dev = devices.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if local >= count:
            raise ValueError(f"rank {rank} needs cuda:{local} of its own but the machine has "
                             f"{count} card(s); pass a device with an index (cuda:0) and the "
                             f"gloo backend to share one")
        dev = torch.device("cuda", local)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, not {dev}")
    return dev


def world_of_one(device) -> Mesh:
    """The trivial mesh on ``device``: no group, whatever group the process
    has joined; its collectives return their input."""
    return Mesh(group=None, rank=0, size=1, backend="none", device=devices.resolve(device))


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the initialised process group, or the world of one
    when no group is initialised. ``num_devices`` must equal the world
    size when given (a subset would need a subgroup every rank creates):
    asking for more ranks than exist raises rather than shrinking the
    mesh. ``device``: see ``_rank_device``; ``None`` is this rank's card.
    On a card this calls ``torch.cuda.set_device``."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        group, rank, size, backend = None, 0, 1, "none"
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh: {num_devices} devices asked for, the world has "
                         f"{size} rank(s)")
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=rank, size=size, backend=backend, device=dev)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the process group and return the global mesh.

    ``coordinator_address``: an init method (``tcp://host:port``,
    ``file:///path``) or ``host:port``; ``None`` reads the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
    ``torchrun`` sets it. ``backend``: ``nccl`` on a card, ``gloo`` on
    the CPU unless given. Every collective, and the rendezvous itself,
    raises after ``timeout_s`` instead of hanging.
    """
    dev = devices.resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init = coordinator_address or "env://"
    if "://" not in init:
        init = "tcp://" + init
    dist.init_process_group(
        backend=backend, init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(device=device)


# ----------------------------------------------------------------------
# placement and the two collectives
# ----------------------------------------------------------------------

def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)


def shard_batch(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's contiguous slice of the leading axis of the global
    ``arr``, on the rank's device. The axis must divide by the world size
    (pad it first)."""
    n = arr.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return replicate(mesh, arr[mesh.rank * per:(mesh.rank + 1) * per])


def shard_rows(mesh: Mesh, full: torch.Tensor, n_padded: int) -> torch.Tensor:
    """This rank's rows of ``full`` after zero rows pad it to ``n_padded``."""
    pad = torch.zeros((n_padded - full.shape[0],) + tuple(full.shape[1:]),
                      dtype=full.dtype, device=full.device)
    return shard_batch(mesh, torch.cat([full, pad]))


def replicate(mesh: Mesh, arr) -> torch.Tensor:
    """The whole of ``arr`` on the rank's device."""
    if isinstance(arr, torch.Tensor):
        return arr.to(mesh.device)
    return torch.as_tensor(np.asarray(arr), device=mesh.device)


def put_global(mesh: Mesh, arr, spec: Optional[str] = None) -> torch.Tensor:
    """``spec=AXIS`` shards the leading axis, ``None`` replicates."""
    if spec == AXIS:
        return shard_batch(mesh, arr)
    if spec is not None:
        raise ValueError(f"unknown spec {spec!r} (AXIS or None)")
    return replicate(mesh, arr)


def all_sum(mesh: Mesh, *tensors: torch.Tensor):
    """Each tensor summed over the ranks, as a tuple, in one
    ``all_reduce`` (the tensors share a dtype and are flattened into one
    buffer). A world without a group returns them as they are."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    if mesh.group is None:
        return tensors
    with profiling.annotate("mesh.all_sum"):
        buf = torch.cat([t.reshape(-1) for t in tensors])
        ALL_REDUCES += 1
        ALL_REDUCE_BYTES += buf.numel() * buf.element_size()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    out, s = [], 0
    for t in tensors:
        out.append(buf[s:s + t.numel()].reshape(t.shape))
        s += t.numel()
    return tuple(out)


# NCCL has no int16 and gathers bool as bytes; gloo, the same
_WIRE = {torch.int16: torch.int32, torch.bool: torch.uint8}


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along the
    leading axis in rank order, on ``t``'s device. NCCL gathers on the
    card; gloo gathers CPU tensors only, so a card's tensor goes through
    host memory."""
    global ALL_GATHERS, ALL_GATHER_BYTES
    if mesh.group is None:
        return t
    with profiling.annotate("mesh.all_gather"):
        wire = t.to(_WIRE.get(t.dtype, t.dtype)).contiguous()
        ALL_GATHERS += 1
        ALL_GATHER_BYTES += wire.numel() * wire.element_size()
        if mesh.backend == "nccl":
            out = torch.empty((mesh.size * wire.shape[0],) + tuple(wire.shape[1:]),
                              dtype=wire.dtype, device=wire.device)
            dist.all_gather_into_tensor(out, wire, group=mesh.group)
        else:
            host = wire.cpu()
            parts = [torch.empty_like(host) for _ in range(mesh.size)]
            dist.all_gather(parts, host, group=mesh.group)
            out = torch.cat(parts).to(t.device)
        return out.to(t.dtype)
