"""chameleon-34b [vlm] — early-fusion, VQ image tokens live in the text
vocab (65536 covers text + image codes); the modality frontend is the VQ
tokenizer, a stub here as in the reference: the prompts are token ids.
Backbone: dense GQA transformer. [arXiv:2405.09818] (a copy of
``repro.configs.chameleon_34b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="chameleon-34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    layer_pattern=("global",), qkv_bias=False, norm="rmsnorm", act="swiglu",
    tie_embeddings=False,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                          d_ff=256, vocab=512, attn_chunk=64)
