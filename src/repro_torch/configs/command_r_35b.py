"""command-r-35b [dense] — GQA, no biases anywhere.
[hf:CohereForAI/c4ai-command-r-v01] (a copy of
``repro.configs.command_r_35b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000,
    layer_pattern=("global",), qkv_bias=False, norm="layernorm", act="swiglu",
    tie_embeddings=True,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=256, vocab=512, attn_chunk=64)
