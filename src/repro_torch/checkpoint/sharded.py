"""Checkpoints of a sharded train state: the train state of a model cut for
training (``distributed.sharding.build_sharded(..., train=True)``: the
module holds its ``model`` shards, the state its (data, model) shards of
the master parameters, both AdamW moments and the int8 residual).

The file is the one-process format (``checkpoint.manager``): every leaf
whole, under the port's flat names, as the reference's
``CheckpointManager.save`` writes ``jax.device_get`` of its sharded state.
So a file does not depend on the (data, model) layout that wrote it: its
paths and CRCs are those of any other layout's save of the same state, and
of one process's.

* **Save** (:func:`whole_leaves`): each leaf is gathered to rank 0, one
  leaf at a time, over ``data`` and ``model`` where its placement splits
  it; a leaf that several ranks hold comes from the first of them on each
  axis that does not split it. Every other rank holds one shard's host
  copy at most beyond its state. Rank 0 alone writes: the writer thread,
  the atomic ``os.replace`` and the old steps' removal
  (:class:`ShardedCheckpointManager`).
* **Restore**: every rank takes rank 0's list of steps, reads the
  manifest and checks every leaf's CRC as it reads it (the fallback chain
  to an older step unchanged, taken on every rank when any rank failed), then
  cuts its shard of each whole leaf (:func:`recut_`), one leaf at a time,
  by the placements of the model it restores into, whatever layout wrote
  the file. A leaf is read as a memory map of its stored member
  (``manager.StoredNpz``): the manifest's CRC reads every byte, the cut
  copies only the shard.
* :func:`recut_` is also ``ft.remesh_state``'s re-cut: there the whole
  leaves come from the live state (:func:`gather_leaf` to every rank).

The transport is the world group: host tensors on ``gloo`` (the ranks
that share one card, or the CPU), the rank's card tensors on ``nccl``.
"""
from __future__ import annotations

import itertools
from typing import Any

import numpy as np
import torch

from .manager import (_NATIVE_TORCH, CheckpointManager, _leaves, _to_host, checked_reader,
                      map_leaves, open_shard, stored_value)


def is_sharded(model) -> bool:
    """Whether ``model`` is cut for training on a ``torch.distributed``
    mesh (its train state holds shards)."""
    return (getattr(model, "train_places", None) is not None
            and hasattr(getattr(model, "mesh", None), "get_group"))


def param_name(key: str) -> str | None:
    """The parameter a train state's flat leaf mirrors (``params/<name>``,
    ``opt/<slot>/<name>``, ``compress/error/<name>``), or None (``step``)."""
    return key.rsplit("/", 1)[1] if "/" in key else None


def leaf_places(train_places: dict, key: str, mesh) -> tuple:
    """The placements of a train state's leaf ``key``: its parameter's
    (the moments and the residual mirror the parameters), every axis
    replicated for the step."""
    from torch.distributed.tensor import Replicate

    from ..distributed.sharding import mesh_shape
    name = param_name(key)
    if name is not None and name in train_places:
        return train_places[name]
    return tuple(Replicate() for _ in mesh_shape(mesh))


def _split(places: tuple, mesh, axis: str) -> int | None:
    """The dimension ``places`` splits over ``axis`` when that axis has more
    than one rank, else None."""
    from ..distributed.sharding import mesh_shape, split_dim
    if mesh_shape(mesh).get(axis, 1) == 1:
        return None
    return split_dim(places, mesh, axis)


def whole_shape(shape, places: tuple, mesh) -> tuple[int, ...]:
    """The whole leaf's shape, of which ``shape`` is one rank's shard."""
    from ..distributed.sharding import mesh_shape
    out = list(shape)
    for n, pl in zip(mesh_shape(mesh).values(), places):
        if hasattr(pl, "dim"):
            out[pl.dim] *= n
    return tuple(out)


def _owners(places: tuple, mesh):
    """(coordinates, global rank) of the ranks whose shards make the whole
    leaf once: every index of an axis that splits it, the first of one
    that does not."""
    from ..distributed.sharding import mesh_shape
    sizes = mesh_shape(mesh)
    ranges = [range(n if hasattr(pl, "dim") else 1) for n, pl in zip(sizes.values(), places)]
    for idx in itertools.product(*ranges):
        yield dict(zip(sizes, idx)), int(mesh.mesh[idx])


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where a tensor crosses the world group: the host on ``gloo``."""
    import torch.distributed as dist
    return t.device if "nccl" in str(dist.get_backend()) else torch.device("cpu")


def gather_leaf(t: torch.Tensor, places: tuple, mesh, dst: int | None = 0):
    """The whole leaf of which ``t`` is this rank's shard under
    ``places``: on rank ``dst`` a host tensor, None on the others (the
    owners send, :func:`_owners`); with ``dst`` None on every rank, on
    ``t``'s device (each owner broadcasts its shard)."""
    import torch.distributed as dist

    from ..distributed.sharding import local_shard
    me, wire = dist.get_rank(), _wire_device(t)
    owners = list(_owners(places, mesh))
    shape = whole_shape(t.shape, places, mesh)
    t = t.detach()
    if dst is None:
        whole = torch.empty(shape, dtype=t.dtype, device=t.device)
        for coords, r in owners:
            buf = (t.to(wire).contiguous() if r == me
                   else torch.empty(t.shape, dtype=t.dtype, device=wire))
            dist.broadcast(buf, src=r)
            local_shard(whole, places, mesh, coords).copy_(buf)
        return whole
    if me != dst:
        if any(r == me for _, r in owners):
            dist.send(t.to(wire).contiguous(), dst=dst)
        return None
    whole = torch.empty(shape, dtype=t.dtype)
    for coords, r in owners:
        part = local_shard(whole, places, mesh, coords)
        if r == me:
            part.copy_(t)
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, device=wire)
        dist.recv(buf, src=r)
        part.copy_(buf)
    return whole


def whole_leaves(model, state: dict) -> dict[str, np.ndarray] | None:
    """The flat whole leaves of ``model``'s train state (the names and
    host arrays one process's ``CheckpointManager.save`` writes), gathered
    to rank 0 one leaf at a time; None on every other rank."""
    import torch.distributed as dist
    rank0 = dist.get_rank() == 0
    flat = {}
    for key, leaf in _leaves(state):
        if not isinstance(leaf, torch.Tensor):
            if rank0:                   # the step: alike on every rank
                flat[key] = _to_host(leaf)
            continue
        whole = gather_leaf(leaf, leaf_places(model.train_places, key, model.mesh),
                            model.mesh)
        if rank0:
            flat[key] = (whole if whole.dtype in _NATIVE_TORCH else whole.float()).numpy()
    return flat if rank0 else None


def _put(old, cut: torch.Tensor) -> torch.Tensor:
    """``cut`` in ``old``'s dtype and on its device: written into ``old``
    where it has the cut's shape, else a new tensor."""
    with torch.no_grad():
        if old.shape == cut.shape:
            return old.copy_(cut)
        return cut.to(device=old.device, dtype=old.dtype, copy=True).contiguous()


def recut_(state: dict, model, whole_of) -> dict:
    """``state``, the train state of ``model`` (a model cut for training,
    its mesh and placements those to cut by), with every leaf this rank's
    cut of the whole leaf ``whole_of(key, leaf)`` (an array or a tensor),
    one leaf at a time: over both axes for the state's leaf, over
    ``model`` for a parameter's module tensor, which stays the state's own
    leaf where the parameter is whole over ``data`` (as
    ``launch.steps.init_train_state`` hands it out). A tensor of the cut's
    shape is written in place; another (a state cut at another layout) is
    replaced. Returns the state."""
    from ..distributed.sharding import local_shard
    mesh, own = model.mesh, dict(model.named_parameters())

    def cut(key, leaf):
        whole = whole_of(key, leaf)
        if not isinstance(leaf, torch.Tensor):
            return stored_value(leaf, np.asarray(whole))
        whole = torch.as_tensor(whole)
        places = leaf_places(model.train_places, key, mesh)
        name = param_name(key)
        if key.startswith("params/"):
            p = own[name]
            module_cut = local_shard(whole, places, mesh, axes=("model",))
            if p.shape == module_cut.shape:
                _put(p.data, module_cut)
            else:
                p.data = _put(p.data, module_cut)
            if _split(places, mesh, "data") is None:
                return p
            if leaf is p:                   # whole over data before: a copy of its own now
                leaf = p.data.new_empty(0)
        return _put(leaf, local_shard(whole, places, mesh))
    return map_leaves(state, cut)


def load_sharded(path: str, model, like: dict, manifest: dict | None = None,
                 label: str = "ckpt") -> dict:
    """Restore the whole leaves of the shard under ``path`` into ``like``,
    ``model``'s train state, cut to this rank's shards (:func:`recut_`),
    each leaf's CRC32 checked against ``manifest``'s as it is read."""
    read = checked_reader(open_shard(path, label=label), manifest, label)
    return recut_(like, model, lambda key, _: read(key))


class ShardedCheckpointManager(CheckpointManager):
    """``CheckpointManager`` for the train state of ``model``, a model cut
    for training, inside its joined world: every rank calls each method.
    ``save`` gathers the whole leaves to rank 0 (what blocks the loop),
    which alone writes them; ``wait`` joins rank 0's writer, then every
    rank agrees that it succeeded; ``all_steps`` is rank 0's list on every
    rank, so every rank takes one decision to restore, and which step;
    ``restore`` reads the whole leaves on every rank and cuts this rank's
    shards of them, and a step falls back on every rank when it failed on
    any. Every rank must see rank 0's directory: a rank that lists other
    steps raises on every rank."""

    def __init__(self, directory: str, model, keep_last: int = 3, async_save: bool = True):
        import torch.distributed as dist
        super().__init__(directory, keep_last, async_save)
        self.model, self.rank0 = model, dist.get_rank() == 0

    def _wire(self) -> torch.device:
        return _wire_device(next(self.model.parameters()))

    def _agree(self, err: BaseException | None, other: BaseException) -> None:
        """Raise on every rank when any rank failed: ``err`` where it is
        this rank's, else ``other``."""
        import torch.distributed as dist
        flag = torch.tensor([err is not None], dtype=torch.int32, device=self._wire())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if err is not None:
            raise err
        if int(flag):
            raise other

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        flat = whole_leaves(self.model, tree)
        if self.rank0:
            self._publish(step, flat, extra)

    def wait(self) -> None:
        err = None
        try:
            super().wait()
        except BaseException as e:      # noqa: BLE001 - raised below, on every rank
            err = e
        self._agree(err, RuntimeError(f"rank 0's checkpoint write under {self.dir} failed"))

    def all_steps(self) -> list[int]:
        import torch.distributed as dist
        mine, wire = self._steps_on_disk(), self._wire()
        n = torch.tensor([len(mine)], dtype=torch.int64, device=wire)
        dist.broadcast(n, src=0)
        steps = torch.tensor(mine if self.rank0 else [0] * int(n), dtype=torch.int64,
                             device=wire)
        dist.broadcast(steps, src=0)
        steps = steps.tolist()
        self._agree(None if steps == mine else RuntimeError(
            f"rank {dist.get_rank()} lists the checkpoints {mine} under {self.dir}, rank 0 "
            f"{steps}: every rank must see rank 0's directory"),
            RuntimeError(f"a rank lists other checkpoints under {self.dir} than rank 0's "
                         f"{steps}: every rank must see rank 0's directory"))
        return steps

    def _load(self, path: str, like: Any, manifest: dict | None, label: str) -> Any:
        from ..ft.faults import CorruptStream
        err = tree = None
        try:
            tree = load_sharded(path, self.model, like, manifest, label)
        except Exception as e:          # noqa: BLE001 - raised below, on every rank
            err = e
        self._agree(err, CorruptStream(f"{label}: another rank failed to restore it"))
        return tree
