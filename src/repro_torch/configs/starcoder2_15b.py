"""starcoder2-15b [dense] — GQA kv=4, RoPE, LayerNorm + GELU MLP (the
StarCoder2 family keeps the classic MLP). [arXiv:2402.19173] (a copy of
``repro.configs.starcoder2_15b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    layer_pattern=("global",), qkv_bias=True, norm="layernorm", act="gelu",
    tie_embeddings=True,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=192, n_heads=8, n_kv_heads=2,
                          d_ff=384, vocab=512, attn_chunk=64)
