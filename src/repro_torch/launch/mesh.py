"""Meshes over a ``torch.distributed`` world (``repro.launch.mesh``).

``make_host_mesh`` lays the live world out as a ``("data", "model")``
``DeviceMesh``; nothing here builds a mesh or a process group at import.
The reference derives its mesh from the devices one process sees; here
every rank is a process of its own, so the world comes first:
``init_world`` joins one, and ``spawn`` starts one on this host.

The transport: ``nccl`` when every rank has a card of its own, else
``gloo`` (ranks sharing one card, or ranks on the CPU). NCCL refuses two
ranks on one device, and gloo's point-to-point calls take host tensors,
so on a gloo world ``distributed.collectives`` copies the wire tensors to
and from host memory; the packing and rebuilding still run on each
rank's card.

``make_production_mesh`` (16x16 and 2x16x16) waits for the dry run
(ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import datetime
import os
import socket

import torch

WORLD_TIMEOUT = datetime.timedelta(minutes=3)   # a hung rank fails, it does not stall


def backend_for(device: torch.device, world: int) -> str:
    """``nccl`` when each of ``world`` ranks gets a card of its own, else
    ``gloo``."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(rank: int, world: int, port: int, device: torch.device,
               timeout: datetime.timedelta = WORLD_TIMEOUT) -> str:
    """Join a ``world``-rank process group at ``tcp://127.0.0.1:port`` as
    ``rank``: a rank on the card selects card ``rank % device_count`` first.
    Returns the backend (see :func:`backend_for`)."""
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend_for(device, world)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timeout)
    return backend


def _rank_main(rank: int, fn, world: int, port: int, device: str, args: tuple) -> None:
    import torch.distributed as dist
    init_world(rank, world, port, torch.device(device))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, device="cuda") -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined into one
    process group on this host, and wait for them all. ``fn`` must be
    importable by name (a module-level function). A rank that raises makes
    this raise. Build or load the CUDA kernels before spawning, so the
    ranks do not compile the same library at once."""
    import torch.multiprocessing as mp
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    mp.start_processes(_rank_main, args=(fn, world, free_port(), str(device), args),
                       nprocs=world, join=True, start_method="spawn")


def make_host_mesh(data: int | None = None, model: int = 1, device=None):
    """A ``("data", "model")`` ``DeviceMesh`` over the live world: the
    elastic entry point, whose axis sizes come from the world size at
    (re)launch (``data`` defaults to ``world // model``). ``device``: the
    card unless the caller asks for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..utils import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: join a process group first (init_world)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the global batch (the pure-DP axes and the FSDP axis)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)
