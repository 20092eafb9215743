"""Zebra — Zero-Block Regularization of activation maps (Shih & Chang, ISCAS'20).

The port of ``repro.core.zebra``: the config and the plain PyTorch
masking path (the ``reference`` backend) for both activation layouts:

* **CNN maps** ``(B, C, H, W)`` — non-overlapping spatial ``b×b`` blocks
  per channel, block importance = block max, compared with the constant
  ``T_obj`` at inference (paper §II.B).
* **Token maps** ``(B, S, D)`` — ``(block_seq × block_ch)`` tile blocks,
  importance ``max(|x|)`` (post-ReLU maps are non-negative, where
  ``max(|x|) == max(x)``, so the CNN path stays faithful).

Only inference is ported: train mode (threshold nets, the Eq. 1
regularizer, the hard/STE/soft gates) raises ``NotImplementedError``
until the training slice of ROADMAP.md lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..kernels.ref import threshold_as

Aux = dict[str, Any]

# Stream-integrity levels of ``repro.compress.integrity``. Only "off" runs
# in the port until the stream codec (compress/) is ported.
VALIDATION_LEVELS = ("off", "structural", "checksum")
PORTED_VALIDATION_LEVELS = ("off",)

TRAIN_NOT_PORTED = ("train mode is not yet ported to repro_torch (ROADMAP.md, "
                    "module queue: training with torch.autograd.Function)")


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
    validation: str = "off"      # stream-integrity level ("off" only, so far)

    def __post_init__(self):
        from .backends import validate_backend
        if self.backend:
            validate_backend(self.backend)
        for _, name in self.site_backends:
            if name:
                validate_backend(name)
        if self.validation not in VALIDATION_LEVELS:
            raise ValueError(f"unknown validation level {self.validation!r}; "
                             f"expected one of {VALIDATION_LEVELS}")
        if self.validation not in PORTED_VALIDATION_LEVELS:
            raise NotImplementedError(
                f"validation={self.validation!r} is not yet ported to "
                f"repro_torch (ROADMAP.md, module queue: compress/ codec)")

    def replace(self, **kw) -> "ZebraConfig":
        return dataclasses.replace(self, **kw)

    def backend_for(self, site: str = "") -> str:
        """Resolve the execution backend for one named site."""
        return dict(self.site_backends).get(site, self.backend) or "reference"


# ---------------------------------------------------------------------------
# Threshold network: T_{l,c} = FC(GAP(x))  (paper Fig. 2)
# ---------------------------------------------------------------------------

class ThresholdNet(nn.Module):
    """One per Zebra site: an FC from GAP features to per-channel
    thresholds. Held so that trained nets carry across; inference reads
    the constant ``T_obj`` instead."""

    def __init__(self, channels: int, *, generator: torch.Generator | None = None,
                 dtype=torch.float32):
        super().__init__()
        w = torch.randn(channels, channels, generator=generator, dtype=dtype)
        self.w = nn.Parameter(w * channels ** -0.5)
        self.b = nn.Parameter(torch.zeros(channels, dtype=dtype))


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
    mean is: the exact live count times the float32 reciprocal of the
    block count (XLA turns a division by a constant into that product), so
    the value is equal bit for bit."""
    live = keep.sum(dtype=torch.int64).to(torch.float32)
    inv_n = (torch.tensor(1.0, dtype=torch.float32) / keep.numel()).item()
    return 1.0 - live * inv_n


def effective_tnet(cfg: ZebraConfig, tnet):
    """``use_tnet=False`` is authoritative: gate with the constant T_obj."""
    return tnet if cfg.use_tnet else None


def require_infer(cfg: ZebraConfig) -> None:
    if cfg.mode != "infer":
        raise NotImplementedError(TRAIN_NOT_PORTED)


def _disabled(x: torch.Tensor) -> tuple[torch.Tensor, Aux]:
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"reg": z, "zero_frac": z, "n_blocks": 0, "thresholds": None}


# ---------------------------------------------------------------------------
# Public entry points (infer mode)
# ---------------------------------------------------------------------------

def zebra_cnn(x: torch.Tensor, cfg: ZebraConfig, tnet=None) -> tuple[torch.Tensor, Aux]:
    """Zebra over a (B, C, H, W) activation map. Returns (masked x, aux).

    aux: reg (0 in infer mode), zero_frac, n_blocks (per sample),
    thresholds (the constant per-channel T_obj)."""
    if not cfg.enabled:
        return _disabled(x)
    require_infer(cfg)
    B, C, H, W = x.shape
    b = cfg.block_hw
    if H % b or W % b:
        raise ValueError(f"map {H}x{W} not divisible by block {b}")
    blockmax = _block_reduce_max_nchw(x, b)
    keep = blockmax >= threshold_as(cfg.t_obj, blockmax.dtype)
    y = x * _expand_mask_nchw(keep, b).to(x.dtype)
    thr = torch.full((C,), cfg.t_obj, dtype=torch.float32, device=x.device)
    return y, {"reg": torch.zeros((), dtype=torch.float32, device=x.device),
               "zero_frac": zero_fraction(keep),
               "n_blocks": C * (H // b) * (W // b), "thresholds": thr}


def zebra_tokens(x: torch.Tensor, cfg: ZebraConfig, tnet=None) -> tuple[torch.Tensor, Aux]:
    """Zebra over a (B, S, D) token activation map (tile blocks)."""
    if not cfg.enabled:
        return _disabled(x)
    require_infer(cfg)
    B, S, D = x.shape
    bs, bc = cfg.block_seq, cfg.block_ch
    if S % bs or D % bc:
        raise ValueError(f"(S={S}, D={D}) not divisible by block ({bs},{bc})")
    blockmax = _block_reduce_max_bsd(x, bs, bc)
    keep = blockmax >= threshold_as(cfg.t_obj, blockmax.dtype)
    y = x * _expand_mask_bsd(keep, bs, bc).to(x.dtype)
    return y, {"reg": torch.zeros((), dtype=torch.float32, device=x.device),
               "zero_frac": zero_fraction(keep),
               "n_blocks": (S // bs) * (D // bc), "thresholds": None}


def mean_zero_frac(auxes) -> torch.Tensor:
    """Block-count-weighted mean zero-block fraction across sites."""
    num, den = None, 0.0
    for a in auxes:
        nb = float(a.get("n_blocks", 0) or 0)
        if nb:
            term = a["zero_frac"] * nb
            num = term if num is None else num + term
            den += nb
    if num is None:
        return torch.zeros((), dtype=torch.float32)
    return num / den
