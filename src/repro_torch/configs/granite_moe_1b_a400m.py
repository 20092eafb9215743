"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing, narrow experts
(d_ff=512). [hf:ibm-granite/granite-3.0-1b-a400m-base] (a copy of
``repro.configs.granite_moe_1b_a400m``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    layer_pattern=("global",), qkv_bias=False, norm="rmsnorm", act="swiglu",
    tie_embeddings=True,
    n_experts=32, top_k=8, capacity_factor=1.25,
    zebra_block_ch=128,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=128, vocab=512, n_experts=8, top_k=2,
                          attn_chunk=64)
