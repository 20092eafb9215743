"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing, early fusion
(the vision frontend is a stub, as in the reference: token ids in).
[hf:meta-llama/Llama-4-Scout-17B-16E] (a copy of
``repro.configs.llama4_scout_17b_a16e``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    layer_pattern=("global",), qkv_bias=False, norm="rmsnorm", act="swiglu",
    tie_embeddings=True,
    n_experts=16, top_k=1, capacity_factor=1.25,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=128, vocab=512, n_experts=4, top_k=1,
                          attn_chunk=64)
