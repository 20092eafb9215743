"""gemma3-4b [dense] — 5 local (sliding-window) : 1 global layer pattern,
128k context. [hf:google/gemma-3-*] (a copy of ``repro.configs.gemma3_4b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, norm="rmsnorm", rope_theta=1_000_000.0,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=512, window=32, attn_chunk=64)
