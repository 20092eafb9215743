"""The distributed context (``repro.distributed.ctx``): which mesh, which
data-parallel and tensor-parallel axes, and which axis the layer exchanges
run over, declared once by the caller and read by model code, so no
signature carries a mesh. Outside a context every reader sees None and
every layer exchange is a no-op.

``comm_context`` is the port's counterpart of the reference's enclosing
``shard_map``: there the devices of an axis are the shards of one traced
program; here each rank is a process holding its own shard, so the
context carries the axis's process group, its size and this rank's index
in it (:class:`CommAxis`).

The reference's ``hint``/``hint_tokens`` (GSPMD sharding constraints) wait
for the tensor-parallel slice (ROADMAP.md, item 3); nothing in the port
calls them yet.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)
_DP = contextvars.ContextVar("repro_torch_dp_axes", default=None)
_TP = contextvars.ContextVar("repro_torch_tp_axis", default="model")
_COMM = contextvars.ContextVar("repro_torch_comm_axis", default=None)


class CommAxis(NamedTuple):
    """One mesh axis as the collectives see it: its ``name``, its ``size``,
    the ``group`` of this rank's shards along it (a
    ``torch.distributed`` process group; None for a bare declaration) and
    this rank's ``index`` in that group."""
    name: str
    size: int
    group: Any = None
    index: int = 0


def axis_of(mesh, axis: str | tuple[str, ...]) -> CommAxis:
    """This rank's view of a ``DeviceMesh`` axis, or of every axis of the
    mesh taken as one (a tuple of all its axis names: the group of all its
    ranks, made once a mesh; every rank must ask at the same point, as for
    any new group)."""
    import torch.distributed as dist
    if isinstance(axis, str):
        group = mesh.get_group(axis)
        return CommAxis(axis, dist.get_world_size(group), group, mesh.get_local_rank(axis))
    if set(axis) != set(mesh.mesh_dim_names):
        raise NotImplementedError(f"axes {axis} of a mesh of {mesh.mesh_dim_names}: "
                                  f"one axis or all of them")
    name = "+".join(axis)
    cache = mesh.__dict__.setdefault("_repro_flat_axes", {})
    if name not in cache:
        ranks = mesh.mesh.flatten().tolist()
        group = dist.new_group(ranks)
        cache[name] = CommAxis(name, len(ranks), group, ranks.index(dist.get_rank()))
    return cache[name]


@contextlib.contextmanager
def sharding_hints(mesh, dp: tuple | None = None, tp: str | None = "model"):
    """Declare the mesh. ``dp``: the axes carrying the batch (default:
    pod and data); ``tp``: the tensor-parallel axis, or None for pure DP.
    The data-parallel MoE (``models.lm.blocks._moe``) reads the mesh."""
    toks = (_MESH.set(mesh), _DP.set(dp), _TP.set(tp))
    try:
        yield
    finally:
        for var, tok in zip((_MESH, _DP, _TP), toks):
            var.reset(tok)


def active_mesh():
    """The mesh of the enclosing ``sharding_hints``, or None."""
    return _MESH.get()


@contextlib.contextmanager
def comm_context(axis: str, size: int | None = None, *, mesh=None):
    """Declare the axis layer exchanges run over. With ``mesh`` (the
    running form), the axis's process group, size and this rank's index
    come from it; with ``size`` alone it is a bare declaration, enough to
    resolve how an exchange would run (``collectives.resolve_comms``) and
    to run a size-1 axis. Inside it ``ffn_apply`` and ``gather_kv_shards``
    treat their token rows as this rank's sequence shard and return the
    gathered full sequence. No context (the default): every layer exchange
    is a no-op."""
    if mesh is not None:
        info = axis_of(mesh, axis)
        if size is not None and size != info.size:
            raise ValueError(f"comm_context: axis {axis!r} has {info.size} shards, "
                             f"not {size}")
    elif size is None:
        raise ValueError("comm_context: give the axis size or the mesh")
    else:
        info = CommAxis(axis, int(size))
    tok = _COMM.set(info)
    try:
        yield info
    finally:
        _COMM.reset(tok)


def comm_axis() -> CommAxis | None:
    """The active comm declaration, or None."""
    return _COMM.get()


def dp_axes() -> tuple[str, ...]:
    override = _DP.get()
    if override is not None:
        return tuple(override)
    mesh = _MESH.get()
    names = () if mesh is None else _axis_names(mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def tp_axis():
    """The active tensor-parallel axis name, or None under pure DP."""
    return _TP.get()


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)
