"""qwen2.5-14b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-14B] (a copy of
``repro.configs.qwen25_14b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064,
    layer_pattern=("global",), qkv_bias=True, norm="rmsnorm", act="swiglu",
    tie_embeddings=True, rope_theta=1_000_000.0,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=160, n_heads=8, n_kv_heads=2,
                          d_ff=320, vocab=512, attn_chunk=64)
