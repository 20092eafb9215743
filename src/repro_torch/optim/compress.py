"""Gradient compression (``repro.optim.compress``): the wire format a
gradient takes before an all-reduce, decoded back to float32.

Three modes:
  * ``none``: the gradients as they are.
  * ``bf16``: a round trip through bfloat16 (half the wire bytes),
    stateless.
  * ``int8`` with error feedback: per-tensor max-abs scaling to int8 (a
    quarter of the bytes), the quantization residual carried to the next
    step so the compression bias vanishes over time.

The round trip is applied as the reference's semantics have it and
changes the update exactly as it does there. In one process that is all
there is; the sharded train step (``launch.steps``) applies it to each
rank's shards of the reduced gradient, and int8's per-tensor scale is
then the max over every shard (``global_max``), so the decoded values are
those of the whole tensor. Gradients are dicts of name -> float32 tensor;
they are decoded in place (the train step owns them), so a step at
gemma3-4b's width holds no second copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MODES = ("none", "bf16", "int8")
CHUNK = 1 << 24      # elements a chunk of the int8 pass: its temporaries' bound


class CompressionState(NamedTuple):
    error: dict[str, torch.Tensor] | None     # residual carried between steps (int8)


def init_state(params: dict[str, torch.Tensor], mode: str = "bf16") -> CompressionState:
    if mode == "int8":
        return CompressionState(error={k: torch.zeros_like(p, dtype=torch.float32)
                                       for k, p in params.items()})
    return CompressionState(error=None)


def _chunks(t: torch.Tensor):
    """Views of ``CHUNK`` consecutive elements of a contiguous tensor (the
    last one ragged)."""
    flat = t.view(-1)
    return flat.split(CHUNK)


def _abs_max(e: torch.Tensor) -> torch.Tensor:
    """``max |e|`` over the whole tensor, a chunk at a time (exact: a max
    rounds nothing), so no full-size ``abs`` copy is made."""
    return torch.stack([c.abs().amax() for c in _chunks(e)]).amax()


@torch.no_grad()
def compressed_gradients(grads: dict[str, torch.Tensor], state: CompressionState,
                         mode: str = "bf16", *, global_max=None):
    """Returns (wire-format grads decoded back to float32, new state). A
    float32 gradient is decoded in place; the int8 residual is updated in
    place in ``state.error``. ``global_max`` (int8, sharded gradients):
    maps {name: this shard's max |g + e|} to the whole tensors' maxima.

    int8: ``g + e`` rounded once, the scale ``max(max|g + e|, 1e-12) /
    127`` in float32, ``round`` half to even (as ``jnp.round``), clipped to
    ±127, decoded as ``q · scale``; the residual is ``(g + e) - q · scale``
    rounded once. The pass after the scale walks the flat tensor in chunks
    of ``CHUNK`` elements, so its temporaries (the float32 quotient, the
    int8 chunk, one float64 chunk for the residual) are a few chunks, not
    copies of the largest tensor.
    A gradient that is not float32 is decoded into a new float32 tensor."""
    if mode == "none":
        return grads, state
    if mode == "bf16":
        out = {}
        for k, g in grads.items():
            h = g.to(torch.bfloat16)
            out[k] = g.copy_(h) if g.dtype == torch.float32 else h.to(torch.float32)
            del h
        return out, state
    if mode == "int8":
        amax = {}
        for k, g in grads.items():
            e = state.error[k]
            e.add_(g.to(torch.float32))               # g + e: the carried residual added
            amax[k] = _abs_max(e)
        if global_max is not None:
            amax = global_max(amax)
        out = {}
        for k, g in grads.items():
            e = state.error[k]
            scale = torch.clamp(amax[k], min=1e-12) / 127.0
            dec = g if g.dtype == torch.float32 else torch.empty_like(e)
            for ec, dc in zip(_chunks(e), _chunks(dec)):
                q = torch.div(ec, scale).round_().clamp_(-127, 127).to(torch.int8)
                dc.copy_(q.to(torch.float32).mul_(scale))   # the int8 value decoded
                # the new residual (g + e) - q·scale, rounded once: the compiled
                # reference contracts it into a fused multiply-add. q·scale is
                # exact in float64 and so is the difference (|residual| <=
                # scale / 2), so one rounding to float32 remains; one float64
                # chunk holds it
                r = q.double().mul_(scale.double())
                ec.copy_(r.neg_().add_(ec))
                del q, r
            out[k] = dec
        return out, state
    raise ValueError(f"unknown compression mode {mode!r}; known: {MODES}")
