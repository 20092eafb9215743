"""recurrentgemma-2b [hybrid] — Griffin: 2 RG-LRU recurrent blocks : 1
local-attention block, window 2048. [arXiv:2402.19427] (a copy of
``repro.configs.recurrentgemma_2b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-2b",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048, lru_dim=2560, conv_width=4,
    qkv_bias=False, norm="rmsnorm", act="swiglu", tie_embeddings=True,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
                          d_ff=256, vocab=512, lru_dim=128, window=32,
                          attn_chunk=64)
