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

Tensor parallelism (:func:`tensor_parallel`): under ``sharding_hints``
with a tensor-parallel axis that does not carry the batch (the "tp"
profile), each rank holds its shards of a model cut by
``sharding.shard_state_dict`` and its rows of the batch. The reference
pins layouts with ``hint``/``hint_tokens`` and lets GSPMD insert the
collectives; the port has no partitioner, so its ``hint``/``hint_tokens``
sit where the reference's pins sit and take the tensor's local layout
over the tensor-parallel axis (``local``: replicated, a partial sum, or
this rank's slice of one dimension): a partial sum pinned replicated is
summed there, a layout that already is the pinned one moves nothing. The batch dimension is local on every rank and is never
moved. The other tensor-parallel collectives (the row-parallel sums, the
gathers a site or the vocabulary needs) are :func:`psum_model` and
:func:`gather_model` (:func:`row_parallel`: a row-parallel product rounded
once), and :func:`copy_model` marks where a replicated tensor enters a
column-parallel product.

Each collective is an autograd function, and its backward depends on the
layout of the result's consumer:

* :func:`psum_model` (the row-parallel sum) serves a consumer every
  model rank holds whole: the gradient passes through, since each rank's
  partial sum meets the whole gradient.
* :func:`gather_model` serves a consumer every model rank holds whole
  too: the backward keeps this rank's slice of the gradient.
* :func:`copy_model` (the identity forward) serves a consumer split over
  the model axis (a column-parallel product): each rank's gradient covers
  only its columns, so the backward sums it over the axis.
* :func:`psum_model_split` is the sum for a consumer split over the model
  axis (Mamba-2's gated RMSNorm: each rank normalises its own channels
  by the whole sum of squares): each rank's gradient of the sum is a
  partial one, so the backward sums it over the axis.
* :func:`gather_model_split` is the gather for a consumer split over the
  model axis (the RG-LRU's gates, column-parallel products of the whole
  input; the MoE's dispatch map gathered by rows for a threshold net):
  the backward sums the gradient over the axis and then keeps this
  rank's slice.

The backward's collectives are counted in ``collectives.TP_TRAFFIC``
beside the forward's (``bwd_calls``, ``bwd_bytes``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple

import torch

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)
_DP = contextvars.ContextVar("repro_torch_dp_axes", default=None)
_TP = contextvars.ContextVar("repro_torch_tp_axis", default="model")
_COMM = contextvars.ContextVar("repro_torch_comm_axis", default=None)
_WHOLE = contextvars.ContextVar("repro_torch_whole_batch", default=False)


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
def sharding_hints(mesh, dp: tuple | None = None, tp: str | None = "model",
                   whole_batch: bool = False):
    """Declare the mesh. ``dp``: the axes carrying the batch (default:
    pod and data); ``tp``: the tensor-parallel axis, or None for pure DP.
    ``whole_batch``: the batch of the calls inside runs whole on every
    data rank, as the reference's ``batch_spec`` drops a data axis that
    does not divide the batch (:func:`tensor_parallel`). The data-parallel
    MoE (``models.lm.blocks._moe``) reads the mesh."""
    toks = (_MESH.set(mesh), _DP.set(dp), _TP.set(tp), _WHOLE.set(whole_batch))
    try:
        yield
    finally:
        for var, tok in zip((_MESH, _DP, _TP, _WHOLE), toks):
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


# ---------------------------------------------------------------------------
# Tensor parallelism: the layout, the pins and the dense collectives
# ---------------------------------------------------------------------------

class TensorParallel(NamedTuple):
    """The tensor-parallel layout a rank runs under: its ``model`` axis
    (the weights' and heads' shards), its ``data`` axis (the batch's rows)
    and ``world``, every rank of the mesh, over which a site's block counts
    are summed."""
    model: CommAxis
    data: CommAxis
    world: CommAxis


def tensor_parallel() -> TensorParallel | None:
    """The active tensor-parallel layout: a ``DeviceMesh`` declared by
    ``sharding_hints`` with a tensor-parallel axis that is not among the
    data-parallel ones; None otherwise (no mesh, pure DP, or a stand-in
    mesh). The first call on a mesh makes its groups: every rank reaches it
    at the same point of the same program.

    Under ``sharding_hints(..., whole_batch=True)`` on a mesh of more than
    one data rank the batch is replicated over ``data``: the layout's
    ``data`` axis has one rank and its ``world`` is the ``model`` axis, so
    a site counts the rows once and the MoE routes them once."""
    mesh, tp = _MESH.get(), _TP.get()
    if mesh is None or tp is None or tp in dp_axes() or not hasattr(mesh, "get_group"):
        return None
    lay = mesh_layout(mesh, tp)
    if _WHOLE.get() and lay.data.size > 1:
        return lay._replace(data=CommAxis(lay.data.name, 1), world=lay.model)
    return lay


def mesh_layout(mesh, tp: str = "model") -> TensorParallel:
    """The axes of a ``("data", "model")`` ``DeviceMesh`` as
    :class:`TensorParallel` holds them, whatever the sharding profile (the
    sharded train step reduces over them under pure data parallelism
    too). The first call on a mesh makes its groups."""
    cache = mesh.__dict__.setdefault("_repro_tp", {})
    if tp not in cache:
        cache[tp] = TensorParallel(axis_of(mesh, tp), axis_of(mesh, "data"),
                                   axis_of(mesh, tuple(mesh.mesh_dim_names)))
    return cache[tp]


class _SumModel(torch.autograd.Function):
    """The row-parallel sum: the partial sums added over the axis; the
    gradient passes through, since every rank's consumer of the sum is
    replicated."""

    @staticmethod
    def forward(ctx, t, axis):
        from .collectives import tp_all_reduce
        return tp_all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """Every rank's slice concatenated along ``dim``; the gradient of the
    (replicated) result cut back to this rank's slice."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        from .collectives import tp_all_gather
        ctx.dim, ctx.start, ctx.n = dim, axis.index * t.shape[dim], t.shape[dim]
        return tp_all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


class _SumModelSplit(torch.autograd.Function):
    """The sum over the axis for a consumer split over it: the gradient
    (each rank's, from its own part of the consumer) summed over the
    axis."""

    @staticmethod
    def forward(ctx, t, axis):
        from .collectives import tp_all_reduce
        ctx.axis = axis
        return tp_all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        from .collectives import tp_all_reduce
        return tp_all_reduce(g, ctx.axis, backward=True), None


class _GatherModelSplit(torch.autograd.Function):
    """Every rank's slice concatenated along ``dim``, for a consumer split
    over the axis: the gradient summed over the axis, then cut back to
    this rank's slice."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        from .collectives import tp_all_gather
        ctx.axis, ctx.dim, ctx.start, ctx.n = axis, dim, axis.index * t.shape[dim], t.shape[dim]
        return tp_all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        from .collectives import tp_all_reduce
        g = tp_all_reduce(g.contiguous(), ctx.axis, backward=True)
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


class _CopyModel(torch.autograd.Function):
    """A replicated tensor entering a tensor-parallel product: the identity,
    whose gradient (each rank's, from its own columns) is summed over the
    axis."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from .collectives import tp_all_reduce
        return tp_all_reduce(g, ctx.axis, backward=True), None


def psum_model(t):
    """The sum of ``t`` over the tensor-parallel axis (a row-parallel
    product's partial sums), identical on every rank; ``t`` itself outside
    tensor parallelism. The backward passes the gradient through."""
    tp = tensor_parallel()
    if tp is None or tp.model.size == 1:
        return t
    return _SumModel.apply(t, tp.model)


def row_parallel(x, w):
    """``x @ w`` where ``x``'s last dimension and ``w``'s rows are this
    rank's slice of the contraction (a row-parallel product), summed over
    the tensor-parallel axis. In a 16-bit dtype each rank's partial product
    is kept in float32 and the sum rounded once, as one process's GEMM
    rounds its float32 accumulation once: partial products rounded before
    the sum would add a rounding a rank, which a deep residual stream
    turns into blocks that cross T_obj. ``w`` is cast to x's dtype first,
    as one process casts it. ``x @ w`` in x's dtype outside tensor
    parallelism."""
    tp, w = tensor_parallel(), w.to(x.dtype)
    if tp is None or tp.model.size == 1:
        return x @ w
    if x.element_size() >= 4:
        return psum_model(x @ w)
    return psum_model(x.float() @ w.float()).to(x.dtype)


def gather_model(t, dim: int):
    """Every model rank's ``t`` concatenated along ``dim`` in rank order;
    ``t`` itself outside tensor parallelism. The backward keeps this
    rank's slice of the gradient."""
    tp = tensor_parallel()
    if tp is None or tp.model.size == 1:
        return t
    return _GatherModel.apply(t, tp.model, dim % t.dim())


def psum_model_split(t):
    """The sum of ``t`` over the tensor-parallel axis for a consumer split
    over that axis; ``t`` itself outside tensor parallelism. The backward
    sums the gradient over the axis."""
    tp = tensor_parallel()
    if tp is None or tp.model.size == 1:
        return t
    return _SumModelSplit.apply(t, tp.model)


def gather_model_split(t, dim: int):
    """Every model rank's ``t`` concatenated along ``dim`` in rank order,
    for a consumer split over the tensor-parallel axis; ``t`` itself
    outside tensor parallelism. The backward sums the gradient over the
    axis and keeps this rank's slice."""
    tp = tensor_parallel()
    if tp is None or tp.model.size == 1:
        return t
    return _GatherModelSplit.apply(t, tp.model, dim % t.dim())


def copy_model(t):
    """``t``, a tensor every model rank holds whole, where it enters a
    column-parallel product (or, as a weight, a computation cut by the
    model axis): the identity, whose backward sums the gradient over the
    tensor-parallel axis. ``t`` itself outside tensor parallelism or
    without a gradient to carry."""
    tp = tensor_parallel()
    if tp is None or tp.model.size == 1 or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyModel.apply(t, tp.model)


def _pinned_dim(x, spec, local, axis: CommAxis):
    """The dimension ``spec`` splits over ``axis`` for a tensor whose
    local layout is ``local`` (None: replicated), as the reference's
    partitioner reads the pin: an axis whose size does not divide the
    whole dimension drops."""
    want = None
    for i, s in enumerate(spec):
        axes = s if isinstance(s, (tuple, list)) else (s,)
        size = x.shape[i] * (axis.size if local == i else 1)
        if axis.name in axes and size % axis.size == 0:
            want = i
    return want


def hint(x, *spec, local=None):
    """The reference's layout pin ``spec`` at this point of the model (per
    dimension an axis name, a tuple of names or None; names the mesh
    lacks, and an axis whose size does not divide the dimension, drop as
    in the reference). ``local`` is x's layout on this rank: None (the
    whole tensor), ``"partial"`` (a partial sum) or a dimension (this
    rank's slice of it). A partial sum pinned replicated is summed over the
    tensor-parallel axis here; a layout that already is the pinned one
    moves nothing; any other pairing raises, since no pin of the port
    needs it. A no-op outside tensor parallelism; the batch's axes move
    nothing."""
    tp = tensor_parallel()
    if tp is None:
        return x
    local = local % x.dim() if isinstance(local, int) else local
    want = _pinned_dim(x, spec, local, tp.model)
    if local == "partial" and want is None:
        return psum_model(x)
    if local != want:
        raise NotImplementedError(f"hint: a tensor laid out as {local!r} over "
                                  f"{tp.model.name!r} pinned to {spec}")
    return x


def hint_tokens(x, *trailing, local=None):
    """A batch-sharded activation pin: dim 0 over the data-parallel axes,
    ``trailing`` for the last dimensions, None between; a trailing
    ``"model"`` is the active tensor-parallel axis. See :func:`hint`."""
    tp = _TP.get()
    trailing = tuple(tp if t == "model" else t for t in trailing)
    mid = (None,) * (x.dim() - 1 - len(trailing))
    return hint(x, dp_axes(), *mid, *trailing, local=local)
