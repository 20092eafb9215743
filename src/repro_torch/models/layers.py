"""Shared layers (the port of ``repro.models.layers``): the CNN side in
NCHW / OIHW, the LM side's norms over (B, S, D).

Plain functions on tensors, plus the small ``nn.Module``s that hold their
parameters. Layouts follow the reference so parameters copy across:
conv weights are OIHW on both sides; a CNN dense weight is stored as
torch's (out, in), the transpose of the reference's (in, out).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def he_normal(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
              dtype=torch.float32, fan_in: int | None = None) -> torch.Tensor:
    if fan_in is None:
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    return torch.randn(shape, generator=generator, dtype=dtype) * math.sqrt(2.0 / fan_in)


def lecun_normal(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
                 dtype=torch.float32, fan_in: int | None = None,
                 device=None) -> torch.Tensor:
    """N(0, 1/fan_in) in ``dtype``: drawn in float32 on ``device`` (the
    generator's), cast, then scaled in ``dtype`` as the reference does."""
    if fan_in is None:
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=generator, device=device).to(dtype)
    return x * math.sqrt(1.0 / fan_in)


def same_padding(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial side: ``ceil(n / stride)``
    outputs, the odd pixel of padding after the map. A stride-2 3x3 conv on
    an even map pads (0, 1), not (1, 1)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_apply(w: torch.Tensor, x: torch.Tensor, stride: int = 1,
               groups: int = 1) -> torch.Tensor:
    """2-D convolution with ``"SAME"`` padding, NCHW input, OIHW weight."""
    kh, kw = w.shape[-2:]
    ph = same_padding(x.shape[-2], kh, stride)
    pw = same_padding(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


_BN_MOMENTUM = 0.9


def bn_apply(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor, x: torch.Tensor, train: bool = False,
             eps: float = 1e-5
             ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm over NCHW in the reference's order, ``(x - mean) *
    rsqrt(var + eps) * scale + bias``. Returns ``(y, (new mean, new var))``.

    ``train``: normalise with the batch mean and the biased variance, and
    return the running statistics ``0.9·old + 0.1·batch`` in float32.
    (``nn.BatchNorm2d`` defines momentum the other way round and keeps the
    unbiased variance.) Otherwise normalise with the running
    statistics, returned unchanged. Nothing is updated in place."""
    if train:
        bmean = x.mean(dim=(0, 2, 3))
        bvar = x.var(dim=(0, 2, 3), correction=0)
        new = (_BN_MOMENTUM * mean + (1 - _BN_MOMENTUM) * bmean.to(torch.float32),
               _BN_MOMENTUM * var + (1 - _BN_MOMENTUM) * bvar.to(torch.float32))
        mean, var = bmean, bvar
    else:
        new = (mean, var)
    inv = torch.rsqrt(var.to(torch.float32) + eps)
    c = (slice(None), None, None)
    y = (x - mean[c].to(x.dtype)) * inv[c].to(x.dtype)
    return y * scale[c].to(x.dtype) + bias[c].to(x.dtype), new


def dense_apply(w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` with w stored (out, in)."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def _valid_windows(x: torch.Tensor, k: int, stride: int) -> tuple[int, int]:
    return tuple(max((n - k) // stride + 1, 0) for n in x.shape[-2:])


def max_pool(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """k x k max over NCHW windows, ``"VALID"``: an odd trailing row or
    column is dropped, a map smaller than the window gives an empty map
    (VGG-16's last pool on a 16x16 input), and a NaN in a window gives NaN,
    as ``lax.max``."""
    oh, ow = _valid_windows(x, k, stride)
    if oh == 0 or ow == 0:
        return x.new_empty(*x.shape[:-2], oh, ow)
    return F.max_pool2d(x, k, stride)


def avg_pool(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """k x k mean over NCHW windows, ``"VALID"``, as ``max_pool``."""
    oh, ow = _valid_windows(x, k, stride)
    if oh == 0 or ow == 0:
        return x.new_empty(*x.shape[:-2], oh, ow)
    return F.avg_pool2d(x, k, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


class Conv(nn.Module):
    """Holds an OIHW conv weight, He-normal initialised."""

    def __init__(self, c_in: int, c_out: int, k: int, *, groups: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(he_normal((c_out, c_in // groups, k, k),
                                        generator=generator,
                                        fan_in=(c_in // groups) * k * k))
        self.groups = groups

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return conv_apply(self.w, x, stride, self.groups)


class BatchNorm(nn.Module):
    """Per-channel scale/bias parameters and mean/var running buffers.
    ``forward(x, train)`` returns ``(y, (new mean, new var))``: the new
    statistics come back as values, so a ``functional_call`` never writes
    its buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False):
        return bn_apply(self.scale, self.bias, self.mean, self.var, x, train)


class Dense(nn.Module):
    """Dense layer with the weight stored (out, in) and a zero bias."""

    def __init__(self, d_in: int, d_out: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(he_normal((d_out, d_in), generator=generator,
                                        fan_in=d_in))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.w, self.b, x)


def mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` as the reference's compiled form computes it. XLA's CPU
    contracts a float32 product and sum into one fused multiply-add, so
    in float32 the product and the sum run in float64 (the product of two
    float32 values is exact there) and round once; a 16-bit dtype rounds
    after each op, as XLA's CPU does there."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


# ----------------------------------------------------------------------------
# Norms for the LM side
# ----------------------------------------------------------------------------

def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis in float32, back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm_apply(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis (biased variance) in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class Norm(nn.Module):
    """``rmsnorm`` (a ``scale``) or ``layernorm`` (``scale`` and ``bias``),
    initialised to the identity."""

    def __init__(self, d: int, kind: str = "rmsnorm", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm_apply(self.scale, x)
        return layernorm_apply(self.scale, self.bias, x)
