"""whisper-medium [audio] — encoder-decoder; the conv frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings (B,
1500, d_model). Full MHA (kv=16 == heads), LayerNorm + GELU.
[arXiv:2212.04356] (a copy of ``repro.configs.whisper_medium``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    layer_pattern=("global",), qkv_bias=True, norm="layernorm", act="gelu",
    tie_embeddings=True,
    encoder_layers=24, enc_seq=1500,
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=256, vocab=512, encoder_layers=2, enc_seq=64,
                          attn_chunk=64)
