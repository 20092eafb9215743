"""Zebra — Zero-Block Regularization of activation maps (Shih & Chang, ISCAS'20).

The port of ``repro.core.zebra``: the config, the threshold nets and the
plain PyTorch masking path (the ``reference`` backend) for both
activation layouts:

* **CNN maps** ``(B, C, H, W)`` — non-overlapping spatial ``b×b`` blocks
  per channel, block importance = block max, one threshold per (layer,
  channel) from a GAP+FC threshold net (training) or the constant
  ``T_obj`` (inference). Paper §II.A/§II.B.
* **Token maps** ``(B, S, D)`` — ``(block_seq × block_ch)`` tile blocks,
  importance ``max(|x|)`` (post-ReLU maps are non-negative, where
  ``max(|x|) == max(x)``, so the CNN path stays faithful).

Training-mode gradient semantics (paper default ``grad_mode="hard"``): the
mask is a hard 0/1 gate without gradient; thresholds receive gradient only
from the L2 regulariser pulling them to ``T_obj`` (Eq. 1), surviving
blocks receive the task gradient. ``"ste"`` and ``"soft"`` are
trainability variants beyond the paper.

Constant-threshold training (``use_tnet=False``): the deployed ``T_obj``
comparator is the forward gate for every gradient mode, which only picks
the backward surrogate, so train-time gating matches inference masking
exactly. The kernel backends reproduce this through
``kernels.grad.ZebraKernelTrainable``; the reg slot reports the realised
zero-block count.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..kernels.ref import threshold_as

Aux = dict[str, Any]

@dataclasses.dataclass(frozen=True)
class ZebraConfig:
    """Every field of ``repro.core.zebra.ZebraConfig`` that defines
    semantics. The TPU's ``interpret`` and ``vmem_budget_bytes`` have no
    counterpart: the Hopper kernels size their own launches.
    ``zero_frac_hint`` (a plan hint of the fused path) comes with that
    path."""
    enabled: bool = True
    t_obj: float = 0.1           # target threshold T_obj (Eq. 1)
    block_hw: int = 4            # spatial b for CNN maps (paper: 4 / 8 / 2)
    block_seq: int = 8           # token-block rows for LM maps
    block_ch: int = 128          # token-block cols for LM maps
    lambda_ce: float = 1.0       # λ weighting the CE term in Eq. 1
    mode: str = "train"          # "train" (threshold net) | "infer" (T_obj)
    grad_mode: str = "hard"      # "hard" (paper) | "ste" | "soft"
    soft_temp: float = 0.05
    use_tnet: bool = True        # train with a learned threshold net
    act_bits: int = 16           # B in Eq. 2
    backend: str = "reference"   # reference | pallas | stream | fused
    site_backends: tuple[tuple[str, str], ...] = ()  # per-site overrides
    validation: str = "off"      # stream integrity: off | structural | checksum

    def __post_init__(self):
        from ..compress.integrity import validate_level
        from .backends import validate_backend
        if self.backend:
            validate_backend(self.backend)
        for _, name in self.site_backends:
            if name:
                validate_backend(name)
        validate_level(self.validation)

    def replace(self, **kw) -> "ZebraConfig":
        return dataclasses.replace(self, **kw)

    def backend_for(self, site: str = "") -> str:
        """Resolve the execution backend for one named site."""
        return dict(self.site_backends).get(site, self.backend) or "reference"


# ---------------------------------------------------------------------------
# Threshold network: T_{l,c} = FC(GAP(x))  (paper Fig. 2)
# ---------------------------------------------------------------------------

class ThresholdNet(nn.Module):
    """One per Zebra site: an FC from GAP features (``d_in``) to thresholds
    (``d_out``, default ``d_in``: one per channel). ``w`` is stored
    ``(d_in, d_out)`` and applied untransposed, ``gap @ w + b``, as the
    reference stores and applies it. A token map's net emits one
    threshold per channel block (``d_out = D // block_ch``). Inference
    reads the constant ``T_obj`` instead."""

    def __init__(self, d_in: int, d_out: int | None = None, *,
                 generator: torch.Generator | None = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d_out = d_in if d_out is None else d_out
        w = torch.randn(d_in, d_out, generator=generator, dtype=dtype, device=device)
        self.w = nn.Parameter(w * d_in ** -0.5)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))

    def forward(self, gap: torch.Tensor) -> torch.Tensor:
        """gap (B, d_in) -> thresholds (B, d_out)."""
        return gap @ self.w + self.b


# ---------------------------------------------------------------------------
# Block partition + masking
# ---------------------------------------------------------------------------

def _block_reduce_max_nchw(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B,C,H,W) -> per-block max|x| (B,C,H//b,W//b); NaN propagates."""
    B, C, H, W = x.shape
    return x.abs().reshape(B, C, H // b, b, W // b, b).amax(dim=(3, 5))


def _block_reduce_max_bsd(x: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """(B,S,D) -> per-block max|x| (B,S//bs,D//bc); NaN propagates."""
    B, S, D = x.shape
    return x.abs().reshape(B, S // bs, bs, D // bc, bc).amax(dim=(2, 4))


def _expand_mask_nchw(mask_blocks: torch.Tensor, b: int) -> torch.Tensor:
    return mask_blocks.repeat_interleave(b, 2).repeat_interleave(b, 3)


def _expand_mask_bsd(mask_blocks: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    return mask_blocks.repeat_interleave(bs, 1).repeat_interleave(bc, 2)


def zero_fraction(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` in float32, computed as the reference's compiled
    form is: XLA turns the division by the block count into a product by
    its float32 reciprocal and contracts ``1 - live · r`` into one fused
    multiply-add, so the value is rounded once. Here the product and the
    difference are exact in float64 (live < 2**29, r of 24 bits), then
    rounded to float32: equal bit for bit, also when the block count is
    not a power of two."""
    return zero_fraction_of(keep.sum(dtype=torch.int64), keep.numel())


def zero_fraction_of(live: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`zero_fraction` from a live block count and the block count."""
    inv_n = float(np.float32(1.0) / np.float32(n))
    return (1.0 - live.to(torch.float64) * inv_n).to(torch.float32)


def effective_tnet(cfg: ZebraConfig, tnet):
    """``use_tnet=False`` is authoritative: gate with the constant T_obj."""
    return tnet if cfg.use_tnet else None


def require_tnet(cfg: ZebraConfig, tnet, site: str = "") -> None:
    """Train mode with ``use_tnet=True`` must receive a threshold net:
    silently training the constant-T_obj gate instead would change the
    objective. The one guard of ``zebra_cnn``, ``zebra_tokens`` and the
    engine."""
    if cfg.mode == "train" and tnet is None and cfg.use_tnet:
        at = f" at site {site!r}" if site else ""
        raise ValueError(
            f"train mode expects a threshold net{at} (use_tnet=True); pass "
            f"tnet, or set use_tnet=False for constant-threshold "
            f"(kernel-trainable) training")


def _apply_gate(x: torch.Tensor, keep: torch.Tensor, blockmax: torch.Tensor,
                thr: torch.Tensor, cfg: ZebraConfig, expand,
                surrogate_only: bool = False) -> torch.Tensor:
    """Gate x by the block keep-mask under the configured gradient mode.

    ``surrogate_only`` (constant-threshold training): the value is always
    the deployed hard mask and the gradient mode only picks the backward
    surrogate, exactly as ``kernels.grad.ZebraKernelTrainable`` computes
    it. ``keep`` is a comparison and carries no gradient."""
    train = cfg.mode == "train"
    if cfg.grad_mode == "soft" and train:
        gate = torch.sigmoid((blockmax - thr) / cfg.soft_temp)
        if surrogate_only:
            # value: hard mask; dy/dx: the sigmoid surrogate gate
            mask = expand(keep).to(x.dtype)
            ge = expand(gate.detach()).to(x.dtype)
            return x * ge + (x * mask - x * ge).detach()
        return x * expand(gate).to(x.dtype)
    mask = expand(keep).to(x.dtype)
    y = x * mask
    if cfg.grad_mode == "ste" and train:
        # value: masked; gradient wrt x: identity (lets pruned blocks recover)
        y = y + (x - x.detach()) * (1.0 - mask)
    return y


def _reg_loss(thr: torch.Tensor, t_obj: float) -> torch.Tensor:
    """Σ_c ||T_obj − T_c||², averaged over the batch dim (Eq. 1 second term)."""
    per_sample = torch.square(t_obj - thr.to(torch.float32)).sum(dim=-1)
    return per_sample.mean()


def _disabled(x: torch.Tensor) -> tuple[torch.Tensor, Aux]:
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"reg": z, "zero_frac": z, "n_blocks": 0, "thresholds": None}


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def zebra_cnn(x: torch.Tensor, cfg: ZebraConfig, tnet=None) -> tuple[torch.Tensor, Aux]:
    """Zebra over a (B, C, H, W) activation map. Returns (masked x, aux).

    aux: reg (Eq. 1 term with a net; the realised zero-block count in
    constant-threshold training; 0 in infer mode), zero_frac, n_blocks
    (per sample), thresholds ((B, C) from the net, else the constant
    per-channel T_obj)."""
    if not cfg.enabled:
        return _disabled(x)
    B, C, H, W = x.shape
    b = cfg.block_hw
    if H % b or W % b:
        raise ValueError(f"map {H}x{W} not divisible by block {b}")
    tnet = effective_tnet(cfg, tnet)
    require_tnet(cfg, tnet)
    blockmax = _block_reduce_max_nchw(x, b)                       # (B,C,Hb,Wb)
    train = cfg.mode == "train"
    if train and tnet is not None:
        gap = x.mean(dim=(2, 3)).to(torch.float32)               # (B,C) GAP
        thr = tnet(gap)                                           # (B,C)
        reg = _reg_loss(thr, cfg.t_obj)
        thr_b = thr[:, :, None, None].to(blockmax.dtype)
    else:
        # infer, or constant-threshold (deployment-matched) training: the
        # deployed T_obj comparator is the gate (Fig. 3)
        thr = torch.full((C,), cfg.t_obj, dtype=torch.float32, device=x.device)
        reg = None if train else torch.zeros((), dtype=torch.float32, device=x.device)
        thr_b = thr[None, :, None, None].to(blockmax.dtype)
    keep = blockmax >= thr_b
    y = _apply_gate(x, keep, blockmax, thr_b, cfg, lambda m: _expand_mask_nchw(m, b),
                    surrogate_only=train and tnet is None)
    zero_frac = zero_fraction(keep)
    n_blocks = C * (H // b) * (W // b)
    if reg is None:
        reg = zero_frac.detach() * n_blocks
    return y, {"reg": reg, "zero_frac": zero_frac, "n_blocks": n_blocks,
               "thresholds": thr}


def zebra_tokens(x: torch.Tensor, cfg: ZebraConfig, tnet=None) -> tuple[torch.Tensor, Aux]:
    """Zebra over a (B, S, D) token activation map (tile blocks). With a
    net, thresholds are per channel block, from the GAP of ``|x|`` over
    the sequence. The aux also carries ``keep``, the (B, S/bs, D/bc) block
    mask."""
    if not cfg.enabled:
        return _disabled(x)
    B, S, D = x.shape
    bs, bc = cfg.block_seq, cfg.block_ch
    if S % bs or D % bc:
        raise ValueError(f"(S={S}, D={D}) not divisible by block ({bs},{bc})")
    tnet = effective_tnet(cfg, tnet)
    require_tnet(cfg, tnet)
    blockmax = _block_reduce_max_bsd(x, bs, bc)                   # (B,Sb,Db)
    train = cfg.mode == "train"
    if train and tnet is not None:
        gap = x.abs().mean(dim=1).to(torch.float32)              # (B,D) GAP
        thr_ch = tnet(gap)                                        # (B,Db)
        reg = _reg_loss(thr_ch, cfg.t_obj)
        thr_b = thr_ch[:, None, :].to(blockmax.dtype)             # (B,1,Db)
    else:
        # infer, or constant-threshold (deployment-matched) training
        reg = None if train else torch.zeros((), dtype=torch.float32, device=x.device)
        thr_b = torch.tensor(threshold_as(cfg.t_obj, blockmax.dtype),
                             dtype=blockmax.dtype, device=x.device)
        thr_ch = None
    keep = blockmax >= thr_b
    y = _apply_gate(x, keep, blockmax, thr_b, cfg,
                    lambda m: _expand_mask_bsd(m, bs, bc),
                    surrogate_only=train and tnet is None)
    zero_frac = zero_fraction(keep)
    n_blocks = (S // bs) * (D // bc)
    if reg is None:
        reg = zero_frac.detach() * n_blocks
    return y, {"reg": reg, "zero_frac": zero_frac, "n_blocks": n_blocks,
               "thresholds": thr_ch, "keep": keep}


def collect_zebra_loss(auxes) -> torch.Tensor:
    """Σ_l reg_l — the second term of Eq. 1 across all Zebra sites."""
    regs = [a["reg"] for a in auxes if a.get("reg") is not None]
    return torch.stack(regs).sum() if regs else torch.zeros((), dtype=torch.float32)


def mean_zero_frac(auxes) -> torch.Tensor:
    """Block-count-weighted mean zero-block fraction across sites. The
    division by the total block count is a product by its float32
    reciprocal, as XLA compiles the reference's ``num / den``, so the value
    is equal bit for bit also when the count is not a power of two."""
    num, den = None, 0.0
    for a in auxes:
        nb = float(a.get("n_blocks", 0) or 0)
        if nb:
            term = a["zero_frac"] * nb
            num = term if num is None else num + term
            den += nb
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return num * float(np.float32(1.0) / np.float32(den))
