"""The dense FFNs, SwiGLU and the GELU MLP with biases, each with its
Zebra site on the hidden map (``repro.models.lm.ffn``), executed through
the site engine. On the ``fused`` backend ``w_down`` consumes the
compressed hidden map: the engine's payload GEMM (``kernels.spmm_cs``)
skips dead blocks and the masked map is never re-read densely; the GELU
MLP adds ``b_down`` after it.

MoE FFNs wait (ROADMAP.md, module queue), and so does the
sequence-parallel layer-output exchange (``ffn_layer_out_exchange``), a
no-op without the comm context the port does not have yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.engine import wants_fused, zebra_site
from ...core.zebra import ThresholdNet, ZebraConfig
from ..layers import lecun_normal
from .config import LMConfig

ACTS = ("swiglu", "gelu")


def zebra_cfg_for(cfg: LMConfig, mode: str) -> ZebraConfig:
    return ZebraConfig(enabled=cfg.zebra_enabled, t_obj=cfg.zebra_t_obj,
                       block_seq=cfg.zebra_block_seq, block_ch=cfg.zebra_block_ch,
                       mode=mode, backend=cfg.zebra_backend, use_tnet=cfg.zebra_tnet,
                       site_backends=tuple(cfg.zebra_site_backends),
                       validation=cfg.zebra_validation)


def eff_block_ch(f: int, cfg: LMConfig) -> int:
    """Channel-block size used for a width-f map (one block spanning the
    whole width when f does not divide)."""
    return cfg.zebra_block_ch if f % cfg.zebra_block_ch == 0 else f


def _hidden_site_cfg(cfg: LMConfig, mode: str) -> ZebraConfig:
    zc = zebra_cfg_for(cfg, mode)
    if "ffn_hidden" not in cfg.zebra_sites:
        zc = zc.replace(enabled=False)
    return zc


class FFN(nn.Module):
    """Weights as the reference stores them: ``w_gate``/``w_up`` (d, f),
    ``w_down`` (f, d), applied untransposed (``x @ w``); the GELU MLP
    (``cfg.act == "gelu"``) has no ``w_gate`` and adds the biases ``b_up``
    (f,) and ``b_down`` (d,), zero at init as in the reference;
    ``zebra_tnet`` is the hidden site's threshold net (one threshold per
    channel block). ``w_gate``/``w_up`` are drawn with fan-in f, as the
    reference draws them (``lecun_normal``'s default: the last axis)."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if cfg.act not in ACTS:
            raise ValueError(f"unknown FFN activation {cfg.act!r}; known: {ACTS}")
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, dtype=dtype, device=device)
        if cfg.act == "swiglu":
            self.w_gate = nn.Parameter(lecun_normal((d, f), **kw))
        self.w_up = nn.Parameter(lecun_normal((d, f), **kw))
        if cfg.act == "gelu":
            self.b_up = nn.Parameter(torch.zeros(f, dtype=dtype, device=device))
            self.b_down = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))
        self.w_down = nn.Parameter(lecun_normal((f, d), fan_in=f, **kw))
        if cfg.zebra_enabled and "ffn_hidden" in cfg.zebra_sites and cfg.zebra_tnet:
            self.zebra_tnet = ThresholdNet(f, f // eff_block_ch(f, cfg),
                                           generator=generator, device=device)


def ffn_apply(p: FFN, x: torch.Tensor, cfg: LMConfig, mode: str):
    """x (B, S, d) -> (y (B, S, d), SiteAux of the hidden site)."""
    cdt = x.dtype
    if cfg.act == "swiglu":
        h = F.silu(x @ p.w_gate.to(cdt)) * (x @ p.w_up.to(cdt))
    else:       # jax.nn.gelu's default is the tanh form; torch's is erf
        h = F.gelu(x @ p.w_up.to(cdt) + p.b_up.to(cdt), approximate="tanh")
    zc = _hidden_site_cfg(cfg, mode)
    if wants_fused(zc, "ffn_hidden"):
        # fused: w_down consumes the compressed hidden map (dead blocks
        # skipped); capability resolution decides legality, not a mode check
        y, zaux = zebra_site(h, zc, site="ffn_hidden", w=p.w_down.to(cdt))
    else:
        h, zaux = zebra_site(h, zc, site="ffn_hidden", tnet=getattr(p, "zebra_tnet", None))
        y = h @ p.w_down.to(cdt)
    if cfg.act == "gelu":
        y = y + p.b_down.to(cdt)
    return y, zaux
