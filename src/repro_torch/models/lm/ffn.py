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

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.engine import wants_fused, zebra_site
from ...core.zebra import ThresholdNet, ZebraConfig
from ..layers import lecun_normal
from .config import LMConfig
from .remat import checkpoint_name

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


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to ``like``'s dtype, as the reference's weakly typed
    Python constants are."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


class _Silu16(torch.autograd.Function):
    """silu in a 16-bit dtype: the reference's ops one by one, each rounded
    to the dtype (``negate``, ``exp``, ``1 +``, ``1 /``, ``x ·``); the
    backward is ``F.silu``'s (float32 inside, rounded once), which saves
    only x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        one = _const(1.0, x)
        return x * (one / (one + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.silu_backward(g, x)


class _Gelu16(torch.autograd.Function):
    """The tanh gelu in a 16-bit dtype: the reference's ops one by one, each
    rounded, its constants rounded to the dtype (``x·x·x``, ``· 0.044715``,
    ``x +``, ``· sqrt(2/π)``, ``tanh``, ``1 +``, ``· 0.5``, ``x ·``); the
    backward is ``F.gelu``'s."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        t = (x + (x * x * x) * _const(0.044715, x)) * _const(math.sqrt(2 / math.pi), x)
        return x * ((_const(1.0, x) + torch.tanh(t)) * _const(0.5, x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: in a 16-bit dtype rounded after each op as the
    reference's HLO is (``F.silu`` computes in float32 and rounds once);
    in float32 ``F.silu``, as the op-by-op form differs from it in the last
    bit there and both are within an ulp of the reference."""
    return F.silu(x) if x.element_size() > 2 else _Silu16.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf),
    rounded as :func:`silu` is."""
    return F.gelu(x, approximate="tanh") if x.element_size() > 2 else _Gelu16.apply(x)


def ffn_apply(p: FFN, x: torch.Tensor, cfg: LMConfig, mode: str):
    """x (B, S, d) -> (y (B, S, d), SiteAux of the hidden site)."""
    cdt = x.dtype
    if cfg.act == "swiglu":
        h = silu(x @ p.w_gate.to(cdt)) * (x @ p.w_up.to(cdt))
    else:
        h = gelu(x @ p.w_up.to(cdt) + p.b_up.to(cdt))
    zc = _hidden_site_cfg(cfg, mode)
    if wants_fused(zc, "ffn_hidden"):
        # fused: w_down consumes the compressed hidden map (dead blocks
        # skipped); capability resolution decides legality, not a mode check
        y, zaux = zebra_site(h, zc, site="ffn_hidden", w=p.w_down.to(cdt))
    else:
        h, zaux = zebra_site(h, zc, site="ffn_hidden", tnet=getattr(p, "zebra_tnet", None))
        h = checkpoint_name(h, "ffn_hidden", cfg.remat)
        y = h @ p.w_down.to(cdt)
    if cfg.act == "gelu":
        y = y + p.b_down.to(cdt)
    return y, zaux
