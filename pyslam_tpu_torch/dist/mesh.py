"""The process group of the sharded solvers and their two collectives.

Counterpart of ``pyslam_tpu/dist/mesh.py`` (``make_mesh``,
``init_distributed``).  The reference is one controller over a
``jax.sharding.Mesh`` of devices; the port is multi-controller SPMD, as
PyTorch is: one process per device, every process calls the same entry
point with the whole graph, and the collectives run through
``torch.distributed``: NCCL on CUDA devices, gloo on the CPU.

``Mesh`` names the process group, this process's rank and device, the
backend and the axis name.  Its ``psum`` (``all_reduce``, in place) and
``all_gather`` are the only collectives of ``dist/``; both go through
``torch.distributed`` at every world size, 1 included, and both count
their calls in ``COLLECTIVES``.

Divergence from the reference: ``make_mesh`` spans the whole initialized
world; a JAX mesh may take a subset of the devices, and here an
``n_devices`` other than the world size raises.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from .._device import resolve_device

# Calls of each collective since the last ``reset_collectives()``.
COLLECTIVES = {"psum": 0, "all_gather": 0}


def reset_collectives():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of a 1-D mesh: ``size`` ranks, each on its own
    ``device`` (or sharing one, on gloo)."""

    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    backend: str  # "nccl" | "gloo"
    axis_name: str = "f"

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in place; returns ``t``."""
        COLLECTIVES["psum"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, sizes) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the first axis in rank order;
        ``sizes[r]`` is rank r's first-axis length, known to every rank.
        Only where the sizes differ is each part padded to the largest for
        the collective and cut again after it."""
        sizes = [int(s) for s in sizes]
        if t.shape[0] != sizes[self.rank]:
            raise ValueError(f"all_gather: rank {self.rank} holds {t.shape[0]} rows, the plan says {sizes[self.rank]}")
        COLLECTIVES["all_gather"] += 1
        n = max(sizes)
        send = t.contiguous()
        if t.shape[0] != n:
            send = t.new_zeros((n,) + t.shape[1:])
            send[: t.shape[0]] = t
        parts = [torch.empty_like(send) for _ in sizes]
        dist.all_gather(parts, send, group=self.group)
        if all(s == n for s in sizes):
            return torch.cat(parts)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    def barrier(self):
        dist.barrier(group=self.group)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator: str | None = None, world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, device=None, timeout_s: float = 600.0):
    """Join the process group: ``torch.distributed.init_process_group``
    with ``coordinator`` as its ``init_method`` (``"tcp://host:port"``,
    ``"file:///path"``; None reads the ``MASTER_ADDR`` / ``RANK`` /
    ``WORLD_SIZE`` environment that ``torchrun`` sets), always with a
    timeout, so that a dead peer ends the run instead of hanging it.
    ``backend`` None takes NCCL for a CUDA ``device`` and gloo for the CPU
    (``device`` None: the package's default, the CUDA card); on NCCL the
    device is passed as ``device_id``.  A no-op when the group is already
    initialized."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or _backend_for(device)
    kw = dict(backend=backend, init_method=coordinator, world_size=-1 if world_size is None else world_size,
              rank=-1 if rank is None else rank, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)


def make_mesh(n_devices: int | None = None, axis_name: str = "f", device=None) -> Mesh:
    """The mesh over the initialized world, with this process on ``device``
    (None: the package's default, the CUDA card, which raises where there
    is none).  The world's backend must take the device's tensors: NCCL
    takes CUDA tensors only; gloo takes both.  Raises ValueError for an
    ``n_devices`` other than None or the world size."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh: n_devices={n_devices}, but the world has {size} ranks; the port's mesh spans the whole "
            "world (a JAX mesh may take a subset of the devices)")
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: the world runs NCCL, which takes no {device.type} tensors")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=device, backend=backend,
                axis_name=axis_name)


__all__ = ["COLLECTIVES", "Mesh", "init_distributed", "make_mesh", "reset_collectives"]
