"""Serve steps of the LM (``repro.launch.steps``): prefill, next-token
choice and the generate loop. PyTorch runs eagerly, so the reference's
jitted steps are plain functions and its ``lax.scan`` over decode steps is
a Python loop. Everything runs under ``torch.inference_mode``. The train
step waits with the LM half of training (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..compress import decompress_tree
from ..models.lm import LM


@torch.inference_mode()
def prefill(model: LM, tokens: torch.Tensor):
    """Prefill a batch of prompts with a cache sized to the prompt."""
    return model.prefill(tokens, tokens.shape[1])


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
             temperature: float = 0.0, generator: torch.Generator | None = None):
    """``steps`` decode steps from ``tok0`` (B, 1) at position ``pos0``.

    ``state`` may hold its KV caches in compressed form (``CompressedMap``
    leaves from the serve handoff): they are expanded here, before the
    first step. Returns (tokens (B, steps), state)."""
    state = decompress_tree(state)         # a no-op for dense caches
    tok, out = tok0, []
    for i in range(steps):
        logits, state = model.decode_step(tok, state, pos0 + i)
        tok = _next_token(logits, temperature, generator)
        out.append(tok)
    toks = torch.cat(out, dim=1) if out else tok0.new_zeros((tok0.shape[0], 0))
    return toks, state
