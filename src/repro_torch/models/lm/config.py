"""LM architecture config (``repro.models.lm.config``): one frozen dataclass
drives the whole stack.

``layer_pattern`` is cycled over ``n_layers``; its element types:
"global" (full causal self-attention), "local" (sliding window of
``window``, banded or, with ``local_impl="scanned"``, one chunk at a
time), both with optional Q/K/V biases, "rglru" (Griffin's recurrent
block: a temporal conv of ``conv_width`` and the gated linear recurrence
over ``lru_dim`` channels) and "ssm" (Mamba-2's SSD block: ``ssm_heads``
heads of ``ssm_head_dim`` over ``d_inner = ssm_expand · d_model``, a state
of ``ssm_state``, chunks of at most ``ssm_chunk``). Every layer but an
"ssm" one is followed by its FFN when ``d_ff`` > 0: dense (SwiGLU, or the
GELU MLP with biases) or, with ``n_experts`` > 0, the top-k MoE
(``top_k``, ``capacity_factor``, ``router_aux_coef``); a tied or untied
vocabulary head. ``encoder_layers`` > 0 adds whisper's non-causal encoder
over ``enc_seq`` precomputed frames and cross-attention in every decoder
layer. ``ce_chunk`` (the chunked cross-entropy of ``LM.loss``),
``grad_accum`` (the microbatches of ``launch.steps.train_step``) and
``remat`` (what the backward keeps of a layer unit, ``remat.run_unit``)
are the reference's, and so is ``sharding_profile``: "tp" (FSDP + tensor
and expert parallelism) or "dp" (pure data parallelism over every mesh
axis: the MoE routes each rank's rows against replicated experts,
``ffn.moe_apply_dp``; ``distributed.sharding`` reads it too). Its TPU
knob for scan unrolling has no counterpart.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab: int = 32000
    head_dim: int = 0                # 0 => d_model // n_heads
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 1024               # sliding-window size for "local"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- Mamba-2 ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # --- RG-LRU ---
    lru_dim: int = 0                 # 0 => d_model
    conv_width: int = 4
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    enc_seq: int = 1500              # stub frontend frames
    attn_chunk: int = 1024           # q/kv chunk for chunked attention
    ce_chunk: int = 1024             # 0 = unchunked CE; else the sequence chunk
                                     # of LM.loss (one (B, chunk, V) logits
                                     # buffer alive at a time)
    grad_accum: int = 1              # microbatches per train step
    remat: str = "block"             # none | block | save_acts
    sharding_profile: str = "tp"     # "tp" (FSDP+TP/EP) | "dp" (pure data
                                     # parallel over data x model)
    local_impl: str = "banded"       # "banded" | "scanned" local attention
                                     # (scanned: one chunk's scores alive at
                                     # a time, recomputed in the backward)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- Zebra integration (the paper's technique) ---
    zebra_enabled: bool = True
    zebra_t_obj: float = 0.1
    zebra_block_seq: int = 8
    zebra_block_ch: int = 128
    zebra_sites: tuple[str, ...] = ("ffn_hidden",)  # +"layer_out", +"kv_cache"
    zebra_backend: str = "reference"  # reference | pallas | stream | fused
    zebra_site_backends: tuple[tuple[str, str], ...] = ()
    zebra_tnet: bool = True          # learned threshold nets at Zebra sites
    zebra_validation: str = "off"    # stream integrity: off | structural | checksum

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.lru_dim == 0:
            object.__setattr__(self, "lru_dim", self.d_model)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:        # Mamba-2's inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)
