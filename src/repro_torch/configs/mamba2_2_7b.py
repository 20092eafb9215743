"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality),
d_state=128, headdim=64, expand=2. The Mamba-2 block contains its own
gated MLP (d_ff=0 → no separate FFN). [arXiv:2405.21060] (a copy of
``repro.configs.mamba2_2_7b``)"""
from ..models.lm.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-2.7b",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    layer_pattern=("ssm",), norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    head_dim=64,
    # Zebra applies to the gated SSD output map via layer_out site
    zebra_sites=("layer_out",),
)


def reduced() -> LMConfig:
    return CONFIG.replace(n_layers=2, d_model=128, vocab=512, ssm_state=16,
                          ssm_head_dim=32, ssm_chunk=32)
