"""One process per device: the port's mesh (counterpart of
starcop_tpu/parallel/mesh.py).

JAX runs one program over a device mesh under ``jit``; PyTorch's idiom for
data parallelism is ``torch.distributed`` with one process per device. A
``Mesh`` here is one rank's view of that world: its size, its rank, its
device and the process group (None for a single process that joined no
group). The code built on it keeps JAX's global semantics: a batch is the
global batch cut into contiguous equal shards (``shard_batch``), parameters
start from rank 0's (``replicate``), and every collective result is the
same on every rank.

Launching: ``torchrun --nproc-per-node N ...`` (``initialize_multihost``
reads its environment) or ``parallel.launch.run_world``. The backend is
explicit: NCCL (the default on the card) needs a device per rank, gloo runs
ranks that share a card, or CPU processes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from starcop_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a data-parallel world: ``size`` processes, this one
    ``rank``, computing on ``device``; ``group`` is the process group the
    collectives run over (None: one process, no collective)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def lead(self) -> bool:
        """True on rank 0, the rank that writes files."""
        return self.rank == 0


def _init_method(address: Optional[str]) -> str:
    """JAX's ``host:port`` coordinator as a torch init method; a ``tcp://``
    or ``file://`` URL passes as it is; None reads ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``)."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def rank_device(device: DeviceLike = None, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` as given, except that the card without
    an index (None or ``"cuda"``) is the local rank's card (``local_rank``,
    by default ``LOCAL_RANK`` or else the rank, modulo the cards on the
    host); raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def mesh_device(mesh: Mesh, device: DeviceLike = None) -> torch.device:
    """The mesh's device, for an entry point given both: a ``device`` that
    is not the mesh's raises."""
    if device is not None and rank_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Join this process to a ``torch.distributed`` world.

    Explicit arguments are validated as JAX's are (a multi-process world
    needs ``coordinator_address`` and ``process_id``, the rank in range);
    the address is ``host:port``, a ``tcp://`` or a ``file://`` URL. With no
    arguments the world is torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``); without that environment this is a no-op and the world
    is one process. A process already in a world stays there.

    ``backend`` defaults to ``"nccl"`` when the rank's device (``device``,
    as ``rank_device`` resolves it) is the card and ``"gloo"`` on the CPU.
    NCCL needs one card per rank: more local ranks than cards raise (pass
    ``backend="gloo"`` for ranks that share a card); nothing switches the
    backend for the caller.
    """
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if num_processes is not None and num_processes > 1:
            if coordinator_address is None:
                raise ValueError(
                    "multi-process initialization needs coordinator_address "
                    f"(got num_processes={num_processes})"
                )
            if process_id is None:
                raise ValueError(
                    "multi-process initialization needs process_id "
                    f"(got num_processes={num_processes})"
                )
            if not 0 <= process_id < num_processes:
                raise ValueError(
                    f"process_id {process_id} out of range for {num_processes} processes"
                )
    if dist.is_initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise ValueError(f"this process is already in a world of {dist.get_world_size()}, "
                             f"not {num_processes}")
        return
    env = os.environ
    if any(v is not None for v in explicit):
        world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
        rank = process_id if process_id is not None else int(env.get("RANK", 0))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    elif "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    else:
        return
    dev = rank_device(device, int(env.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend='nccl' needs the card, not {dev}")
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' needs one CUDA device per rank: {local_world} ranks on this "
                f"host, {torch.cuda.device_count()} device(s); pass backend='gloo' for ranks "
                "that share a card")
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank, **kw)


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """This rank's ``Mesh`` over the launched world (one process when none
    was launched). ``n_devices`` None means the world as launched; another
    size than the world's raises: one process runs one device, so N devices
    are N processes (``torchrun --nproc-per-node N``). ``device`` as in
    ``rank_device``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes, one per device, and "
            f"this world has {world}: launch with torchrun --nproc-per-node {n_devices} "
            "(or parallel.launch.run_world)")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        return Mesh(1, 0, dev, None)
    return Mesh(world, dist.get_rank(), dev, dist.group.WORLD)


def local_rows(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous rows of a global batch of ``n``; a batch that
    does not divide by the world size raises, as JAX's sharding does."""
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not divide over {mesh.size} devices")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """The rank's shard of a pytree of arrays or tensors (leading axis
    sharded): its contiguous rows, as tensors on the rank's device."""

    def place(x):
        if np.ndim(x) == 0:
            raise ValueError("shard_batch: a scalar has no batch axis to shard")
        return torch.as_tensor(x[local_rows(mesh, len(x))]).to(mesh.device)

    return pytree.tree_map(place, tree)


def _coalesced_(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on the concatenation of ``tensors`` (one
    call a dtype) and write the result back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            collective(flat)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def _broadcast_(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Overwrite ``tensors`` with rank 0's values."""
    _coalesced_(tensors, lambda flat: dist.broadcast(flat, src=0, group=mesh.group))


def average_(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place (nothing
    without a group)."""
    def mean_(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)

    if mesh.group is not None:
        _coalesced_(tensors, mean_)


def replicate(mesh: Mesh, obj):
    """Rank 0's copy on every rank: a module's parameters and buffers are
    moved to the rank's device and overwritten in place by rank 0's (the
    module is returned); a pytree of arrays or tensors comes back as tensors
    on the device holding rank 0's values."""
    if isinstance(obj, torch.nn.Module):
        obj.to(mesh.device)
        if mesh.group is not None:
            _broadcast_(mesh, list(obj.state_dict(keep_vars=True).values()))
        return obj
    out = pytree.tree_map(lambda x: torch.as_tensor(x).to(mesh.device, copy=True), obj)
    if mesh.group is not None:
        _broadcast_(mesh, pytree.tree_leaves(out))
    return out


def all_reduce_(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the world in place (nothing without a group)."""
    if mesh.group is not None:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (a picklable value) on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]
