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


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def init_train_state(model: LM, opt: Optimizer, compress: str = "bf16") -> dict:
    """The model's parameters (by name, the tensors themselves), the
    optimizer's state for them, the compression state and step 0."""
    params = dict(model.named_parameters())
    return {"params": params, "opt": opt.init(params),
            "compress": init_state(params, compress), "step": 0}


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
    grads, loss, metrics = accumulate_gradients(model, state["params"], batch["tokens"],
                                                batch.get("enc_feats"))
    if check_finite and not math.isfinite(float(loss)):
        raise PoisonBatch(f"non-finite loss {float(loss)} at step {state['step']}")
    grads, state["compress"] = compressed_gradients(grads, state["compress"], compress)
    gnorm = clip_by_global_norm_(grads, grad_clip)
    opt.update_(grads, state["opt"], state["params"], state["step"])
    del grads
    state["step"] += 1
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def model_hints(model: LM):
    """``sharding_hints`` of the mesh a tensor-parallel model was cut for
    (the reference's ``_hint_args``: the batch over the data-parallel axes,
    the "model" axis tensor-parallel unless the profile is pure DP); a
    null context for a model in one process."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return contextlib.nullcontext()
    from ..distributed.ctx import sharding_hints
    from ..distributed.sharding import dp
    pure_dp = model.cfg.sharding_profile == "dp"
    return sharding_hints(mesh, dp=dp(mesh, model.cfg), tp=None if pure_dp else "model")


@torch.inference_mode()
def prefill(model: LM, tokens: torch.Tensor, enc_feats: torch.Tensor | None = None):
    """Prefill a batch of prompts with a cache sized to the prompt (an
    encoder-decoder encodes its frames ``enc_feats`` first)."""
    with model_hints(model):
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
                   temperature: float = 0.0, generator: torch.Generator | None = None):
    """One continuous-batching decode step across B independent request
    lanes (``serve/engine.py``'s hot path): ``token`` (B, 1), ``pos`` (B,),
    each lane at its own sequence position. Returns (the next token of
    every lane (B, 1), state), the caches updated in place. Greedy at
    temperature 0.0; a draw from ``generator`` otherwise."""
    with model_hints(model):
        logits, state = model.decode_step(token, state, pos)
    return _next_token(logits, temperature, generator), state
