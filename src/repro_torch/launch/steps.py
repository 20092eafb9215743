"""Train and serve steps of the LM (``repro.launch.steps``). PyTorch runs
eagerly, so the reference's jitted steps are plain functions and its
``lax.scan`` loops (over decode steps, over gradient-accumulation
microbatches) are Python loops.

Training: :func:`init_train_state` and :func:`train_step`, the
counterparts of ``make_train_state_shape``'s ``init_fn`` and of
``make_train_step``. The state is ``{"params", "opt", "compress",
"step"}``; ``params`` are the model's own parameters (the module the loss
runs), which the step updates in place with the optimizer's ``update_``,
as it does the optimizer state and the int8 compression residual: at
gemma3-4b's width every copy of the parameters is 7.4 GB.

The sharded train step (a model cut for training by
``distributed.sharding.build_sharded(..., train=True)`` or
``shard_model_(..., train=True)``, on a ``("data", "model")`` mesh, one
process a rank): the module holds its ``model`` shards whole over
``data``; the state holds the float32 master parameters, both AdamW
moments and the int8 residual as (data, model) shards (the reference's
``train_state_specs``; a leaf whole over ``data`` is the module's own
tensor). :func:`train_step` gathers each parameter over ``data`` into the
module (FSDP), runs this data rank's rows of every microbatch
(:func:`data_rows`) forward and backward tensor-parallel over ``model``,
takes the mean of the gradient over ``data`` (a reduce-scatter onto the
shard, or an all-reduce for a leaf whole over ``data``; under the "dp"
profile the batch is cut over every rank, :func:`batch_shards`, no layer
is tensor-parallel and the mean is over ``model`` as well), and then, as the
reference's semantics have it, the compression round trip (int8's scale
the max over every shard of the tensor), the global-norm clip (each
element counted once) and AdamW on the shards. Loss and ``ce`` are the
global batch's; the site observables were summed over the mesh at each
site.

Serving: prefill, next-token choice, the generate loop and the slotted
decode step of the continuous-batching engine, under
``torch.inference_mode``. A model cut for tensor parallelism
(``distributed.sharding.build_sharded`` or ``shard_model_``) carries its mesh, and its steps
run under ``sharding_hints`` of it (:func:`model_hints`), as the
reference's ``make_prefill``/``make_decode_step`` do.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..compress import decompress_tree
from ..ft.faults import PoisonBatch
from ..models.lm import LM
from ..optim import Optimizer, clip_by_global_norm_, compressed_gradients, init_state
from ..optim.optimizers import sharded_global_norm


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def init_train_state(model: LM, opt: Optimizer, compress: str = "bf16") -> dict:
    """The model's parameters (by name, the tensors themselves), the
    optimizer's state for them, the compression state and step 0. For a
    model cut for training (``model.train_places``), this rank's (data,
    model) shards: a copy of its ``data`` shard of each parameter split
    over ``data``, the module's tensor itself for one whole over it, and
    the optimizer and compression state of those."""
    params = dict(model.named_parameters())
    if _layout(model) is not None:
        from ..distributed.sharding import local_shard
        places, mesh = model.train_places, model.mesh
        params = {n: p if _data_dim(model, n) is None else
                  local_shard(p.detach(), places[n], mesh, axes=("data",)).clone()
                  for n, p in params.items()}
    return {"params": params, "opt": opt.init(params),
            "compress": init_state(params, compress), "step": 0}


def _layout(model: LM):
    """The mesh axes a model cut for training reduces over
    (``ctx.mesh_layout``), or None for a model in one process (or cut for
    serving)."""
    if getattr(model, "train_places", None) is None or not hasattr(model.mesh, "get_group"):
        return None
    from ..distributed.ctx import mesh_layout
    return mesh_layout(model.mesh)


def batch_shards(cfg, data: int, model: int, data_index: int, model_index: int):
    """(how many parts the global batch is cut into, this rank's part): over
    ``data`` (the "tp" profile), or under pure data parallelism (the "dp"
    profile) over every rank, data-major as the reference's batch spec
    ``("data", "model")`` lays it out."""
    if cfg.sharding_profile == "dp":
        return data * model, data_index * model + model_index
    return data, data_index


def _data_dim(model: LM, name: str) -> int | None:
    """The dimension parameter ``name`` is split over ``data`` in the train
    state, or None (whole over it, or a data axis of one rank)."""
    from ..distributed.sharding import mesh_shape, split_dim
    if mesh_shape(model.mesh).get("data", 1) == 1:
        return None
    return split_dim(model.train_places[name], model.mesh, "data")


def data_rows(batch: int, grad_accum: int, data: int, index: int) -> list[int]:
    """The global batch's rows data rank ``index`` of ``data`` takes, in
    order: its rows of each of the ``grad_accum`` microbatches, global
    rows ``[i·B/K + index·B/(K·data), ...)``, so microbatch i of every rank
    together is the reference's microbatch i."""
    K = max(grad_accum, 1)
    if batch % (K * data):
        raise ValueError(f"batch {batch} does not split into {K} microbatches over "
                         f"{data} data ranks")
    b = batch // (K * data)
    return [i * (batch // K) + index * b + j for i in range(K) for j in range(b)]


def _own_params(model: LM, params: dict) -> list[torch.Tensor]:
    own = dict(model.named_parameters())
    if params.keys() != own.keys() or any(params[k] is not own[k] for k in own):
        raise ValueError("state['params'] must hold the model's own parameters "
                         "(launch.steps.init_train_state)")
    return list(params.values())


def accumulate_gradients(model: LM, params: dict, tokens: torch.Tensor,
                         enc_feats: torch.Tensor | None = None):
    """The loss of ``tokens`` (B, S+1) (with an encoder-decoder's frames
    ``enc_feats`` (B, enc_seq, d), split like the tokens) and its float32
    gradient with respect to ``params`` (the model's own), over
    ``cfg.grad_accum`` microbatches: rows ``[i·B/K, (i+1)·B/K)`` in order.
    Each microbatch's backward adds its gradient into the parameters'
    ``.grad`` as it arrives (``acc + g``, in microbatch order), so one
    float32 copy of the gradients is alive, not two; the sum is then
    divided by K. Loss, ``ce``, ``zebra_reg``, ``zero_frac`` and
    ``router_aux`` are means over the microbatches; ``measured_bytes`` is
    their sum (extensive: the bytes the whole batch moved, whatever K). Returns ``(grads, loss, metrics)``, all detached;
    the parameters' ``.grad`` is left empty."""
    leaves = _own_params(model, params)
    K = max(model.cfg.grad_accum, 1)
    B = tokens.shape[0]
    if B % K:
        raise ValueError(f"batch {B} does not split into grad_accum={K} microbatches")
    if any(p.grad is not None for p in leaves):
        raise ValueError("the parameters carry gradients already; accumulate_gradients "
                         "sums into .grad from None")
    if K > 1 and any(p.dtype != torch.float32 for p in leaves):
        raise ValueError("grad_accum > 1 sums the microbatches in .grad, which needs "
                         "float32 parameters")
    micro = tokens.reshape(K, B // K, -1)
    enc = None if enc_feats is None else enc_feats.reshape(K, B // K, *enc_feats.shape[1:])
    loss, metrics = None, None
    try:
        for i in range(K):
            l, m = model.loss(micro[i], "train", None if enc is None else enc[i])
            l.backward()
            l, m = l.detach(), {k: v.detach() for k, v in m.items()}
            if loss is None:
                loss, metrics = l, m
                continue
            loss = loss + l
            metrics = {k: metrics[k] + v for k, v in m.items()}
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad.to(torch.float32) for p in leaves]
    finally:
        for p in leaves:
            p.grad = None
    if K > 1:
        for g in grads:
            g.div_(K)
        loss = loss / K
        metrics = {k: v if k == "measured_bytes" else v / K for k, v in metrics.items()}
    return dict(zip(params, grads)), loss, metrics


def train_step(model: LM, opt: Optimizer, state: dict, batch: dict, *,
               compress: str = "bf16", grad_clip: float = 1.0, check_finite: bool = False):
    """One optimizer step on ``batch["tokens"]`` (B, S+1) (and an
    encoder-decoder's ``batch["enc_feats"]``): the accumulated
    gradient, ``compressed_gradients`` (``compress``), clipping to the
    global norm ``grad_clip``, then the optimizer's in-place update at the
    step before the increment. Returns ``(state, metrics)``, the state
    updated in place, the metrics with ``loss`` and ``grad_norm`` added
    (device tensors). With ``check_finite`` the loss is read on the host
    before anything in ``state`` changes, and a non-finite one raises
    ``ft.faults.PoisonBatch`` with the state untouched (the supervisor's
    skip-batch policy); otherwise nothing is read on the host."""
    if _layout(model) is not None:
        return _sharded_train_step(model, opt, state, batch, compress=compress,
                                   grad_clip=grad_clip, check_finite=check_finite)
    grads, loss, metrics = accumulate_gradients(model, state["params"], batch["tokens"],
                                                batch.get("enc_feats"))
    if check_finite and not math.isfinite(float(loss)):
        raise PoisonBatch(f"non-finite loss {float(loss)} at step {state['step']}")
    grads, state["compress"] = compressed_gradients(grads, state["compress"], compress,
                                                    global_max=_stack_max(model))
    gnorm = clip_by_global_norm_(grads, grad_clip)
    opt.update_(grads, state["opt"], state["params"], state["step"])
    del grads
    state["step"] += 1
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


def stacked_leaves(model: LM) -> dict[str, str]:
    """{parameter name: the reference's leaf it is a slice of} for the
    parameters of a run repeated more than once and of an encoder's
    layers, which the reference stacks on a leading axis
    (``models.lm.convert``): ``run0.3.sub1.attn.wo`` is a slice of
    ``run0.sub1.attn.wo``. int8's per-tensor scale is that leaf's."""
    counts = {f"run{ri}": count for ri, (_, count) in enumerate(model.runs) if count > 1}
    if model.cfg.encoder_layers:
        counts["encoder"] = model.cfg.encoder_layers
    out = {}
    for name, _ in model.named_parameters():
        run, c, rest = (name.split(".", 2) + ["", ""])[:3]
        if run in counts and c.isdigit():
            out[name] = f"{run}.{rest}"
    return out


def _stack_max(model: LM, inner=None):
    """int8's ``global_max`` for ``model``: ``inner`` (the maxima over a
    sharded tensor's ranks), then the max over each stacked leaf's slices
    (:func:`stacked_leaves`), the reference's per-tensor scale. ``inner``
    itself where nothing is stacked."""
    stacks = stacked_leaves(model)
    if not stacks:
        return inner

    def global_max(amax: dict) -> dict:
        amax = inner(amax) if inner is not None else dict(amax)
        leaves: dict[str, list] = {}
        for n in amax:
            if n in stacks:
                leaves.setdefault(stacks[n], []).append(amax[n])
        top = {k: torch.stack(v).amax() for k, v in leaves.items()}
        return {n: top[stacks[n]] if n in stacks else v for n, v in amax.items()}
    return global_max


def gather_params_(model: LM, state: dict) -> None:
    """Make each parameter of a model cut for training whole over ``data``
    from the state's shards (FSDP's gather before the forward); the
    leaves whole over ``data`` are the module's own tensors already."""
    from ..distributed.collectives import dp_all_gather
    tp = _layout(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = _data_dim(model, name)
            if dim is not None:
                p.copy_(dp_all_gather(state["params"][name], tp.data, dim))


def _split_axes(model: LM, name: str) -> tuple[str, ...]:
    from ..distributed.sharding import mesh_shape, split_dim
    return tuple(a for a in ("data", "model")
                 if mesh_shape(model.mesh).get(a, 1) > 1
                 and split_dim(model.train_places[name], model.mesh, a) is not None)


def _axis_for(tp, axes: tuple[str, ...]):
    return {(): None, ("data",): tp.data, ("model",): tp.model}.get(axes, tp.world)


def _sharded_train_step(model: LM, opt: Optimizer, state: dict, batch: dict, *,
                        compress: str, grad_clip: float, check_finite: bool):
    """:func:`train_step` of a model cut for training: ``batch["tokens"]``
    are this data rank's rows (:func:`data_rows`)."""
    from ..distributed.collectives import all_reduce_small, dp_mean
    tp = _layout(model)
    pure_dp = model.cfg.sharding_profile == "dp"
    rows_over = tp.world if pure_dp else tp.data        # the axes the batch is cut over
    gather_params_(model, state)
    with model_hints(model):
        grads, loss, metrics = accumulate_gradients(model, dict(model.named_parameters()),
                                                    batch["tokens"], batch.get("enc_feats"))
    # the global batch's loss and ce (and Eq. 1's term with threshold nets):
    # means over the ranks the batch is cut over; the site observables are
    # global already
    keys = ["ce", *(["zebra_reg"] if model.cfg.zebra_tnet else [])]
    mean = all_reduce_small(torch.stack([loss, *(metrics[k] for k in keys)]), rows_over)
    if rows_over.size > 1:
        mean = mean / rows_over.size
    loss, metrics = mean[0], {**metrics, **dict(zip(keys, mean[1:]))}
    if check_finite and not math.isfinite(float(loss)):
        raise PoisonBatch(f"non-finite loss {float(loss)} at step {state['step']}")
    for name in grads:
        g = dp_mean(grads[name], tp.model, None) if pure_dp else grads[name]
        grads[name] = dp_mean(g, tp.data, _data_dim(model, name))
    axes = {n: _split_axes(model, n) for n in grads}

    def global_max(amax: dict) -> dict:
        out = dict(amax)
        for group in sorted(set(axes.values())):     # every rank in one order
            names = [n for n in amax if axes[n] == group]
            axis = _axis_for(tp, group)
            if axis is not None and names:
                got = all_reduce_small(torch.stack([amax[n] for n in names]), axis, "max")
                out.update(zip(names, got.unbind(0)))
        return out
    grads, state["compress"] = compressed_gradients(grads, state["compress"], compress,
                                                    global_max=_stack_max(model, global_max))
    # a leaf whole over an axis counts on that axis's first rank only
    owned = {n for n in grads if ("data" in axes[n] or tp.data.index == 0)
             and ("model" in axes[n] or tp.model.index == 0)}
    norm = sharded_global_norm(grads, owned, lambda t: all_reduce_small(t, tp.world))
    gnorm = clip_by_global_norm_(grads, grad_clip, norm=norm)
    opt.update_(grads, state["opt"], state["params"], state["step"])
    del grads
    state["step"] += 1
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def model_hints(model: LM, whole_batch: bool = False):
    """``sharding_hints`` of the mesh a tensor-parallel model was cut for
    (the reference's ``_hint_args``: the batch over the data-parallel axes,
    the "model" axis tensor-parallel unless the profile is pure DP; with
    ``whole_batch`` the batch runs whole on every data rank); a null
    context for a model in one process."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return contextlib.nullcontext()
    from ..distributed.ctx import sharding_hints
    from ..distributed.sharding import dp
    pure_dp = model.cfg.sharding_profile == "dp"
    return sharding_hints(mesh, dp=dp(mesh, model.cfg), tp=None if pure_dp else "model",
                          whole_batch=whole_batch)


@torch.inference_mode()
def prefill(model: LM, tokens: torch.Tensor, enc_feats: torch.Tensor | None = None, *,
            whole_batch: bool = False):
    """Prefill a batch of prompts with a cache sized to the prompt (an
    encoder-decoder encodes its frames ``enc_feats`` first). On a model cut
    for a mesh ``tokens`` are this data rank's rows, or with
    ``whole_batch`` the whole batch on every data rank."""
    with model_hints(model, whole_batch):
        return model.prefill(tokens, tokens.shape[1], enc_feats)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int64: greedy argmax at temperature 0.0
    (the first maximal index, as ``jnp.argmax``), else a draw from the
    softmax at that temperature from ``generator``."""
    if temperature > 0.0:
        if generator is None:
            raise ValueError("temperature > 0 requires a torch.Generator")
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1)[:, None]


@torch.inference_mode()
def generate(model: LM, tok0: torch.Tensor, state, pos0: int, steps: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             logits_out: list | None = None):
    """``steps`` decode steps from ``tok0`` (B, 1) at position ``pos0``.

    ``state`` may hold its KV caches in compressed form (``CompressedMap``
    leaves from the serve handoff): they are expanded here, before the
    first step. Each step's logits are appended to ``logits_out`` when
    given. Returns (tokens (B, steps), state)."""
    state = decompress_tree(state)         # a no-op for dense caches
    tok, out = tok0, []
    with model_hints(model):
        for i in range(steps):
            logits, state = model.decode_step(tok, state, pos0 + i)
            if logits_out is not None:
                logits_out.append(logits)
            tok = _next_token(logits, temperature, generator)
            out.append(tok)
    toks = torch.cat(out, dim=1) if out else tok0.new_zeros((tok0.shape[0], 0))
    return toks, state


@torch.inference_mode()
def decode_slotted(model: LM, token: torch.Tensor, state, pos: torch.Tensor,
                   temperature: float = 0.0, generator: torch.Generator | None = None,
                   lanes=None):
    """One continuous-batching decode step across B independent request
    lanes (``serve/engine.py``'s hot path): ``token`` (B, 1), ``pos`` (B,),
    each lane at its own sequence position. Returns (the next token of
    every lane (B, 1), state), the caches updated in place. Greedy at
    temperature 0.0; a draw from ``generator`` otherwise.

    ``lanes``: on a model cut for a mesh, the ``data`` axis the lanes are
    split over (``token``, ``pos`` and ``state`` are this data rank's
    contiguous block of them), or None for lanes whole on every data rank.
    Split, every rank gets the tokens of every lane: greedy ones are
    gathered over ``data``, and a draw is made from the gathered logits,
    so every rank draws the whole batch from the same generator."""
    with model_hints(model, whole_batch=lanes is None):
        logits, state = model.decode_step(token, state, pos)
    if lanes is None:
        return _next_token(logits, temperature, generator), state
    from ..distributed.collectives import dp_all_gather
    if temperature > 0.0:
        return _next_token(dp_all_gather(logits.float(), lanes, 0), temperature,
                           generator), state
    return dp_all_gather(_next_token(logits, temperature), lanes, 0), state
