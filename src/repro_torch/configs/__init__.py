"""Architecture registry of the port (``repro.configs``).

``get(arch)`` -> LMConfig; ``reduced(arch)`` -> the smoke-test config.
All ten of the reference's architectures are ported: the five dense ones
(gemma3-4b, command-r-35b, qwen2.5-14b, starcoder2-15b, chameleon-34b), the
two MoE ones (granite-moe-1b-a400m, llama4-scout-17b-a16e), the
encoder-decoder whisper-medium, the SSM mamba2-2.7b and the hybrid
recurrentgemma-2b (RG-LRU and local attention).
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "chameleon-34b": "chameleon_34b",
    "command-r-35b": "command_r_35b",
    "gemma3-4b": "gemma3_4b",
    "qwen2.5-14b": "qwen25_14b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-medium": "whisper_medium",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCHS = tuple(_ARCH_MODULES)


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)


def get(arch: str):
    return _mod(arch).CONFIG


def reduced(arch: str):
    return _mod(arch).reduced()


def with_layers(arch: str, *, reduced: bool = False, n_layers: int = 0):
    """The architecture's config (or its smoke-test config) with only its
    first ``n_layers`` layers, at full width; 0 keeps them all."""
    cfg = _mod(arch).reduced() if reduced else _mod(arch).CONFIG
    if not 0 <= n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers {n_layers}: {cfg.name} has {cfg.n_layers} layers "
                         f"(0 keeps them all)")
    return cfg.replace(n_layers=n_layers) if n_layers else cfg
