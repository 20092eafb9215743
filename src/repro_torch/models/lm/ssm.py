"""Mamba-2's SSD block (``repro.models.lm.ssm``; Dao & Gu, arXiv:2405.21060)
in the chunked matmul form, with its decode cache and step.

State-space duality: y_t = Σ_{s≤t} C_t·(Π_{r∈(s,t]} e^{A·dt_r})·B_s·dt_s·x_s
+ D·x_t, computed as an intra-chunk quadratic part plus a state scan over
the chunks, one group (ngroups = 1). The projections are separate (z, x,
B, C, dt), as the reference keeps them; x, B and C each pass a depthwise
causal conv of ``conv_width`` and silu; then the SSD over the heads,
y ⊙ silu(z), an RMSNorm over ``d_inner`` and ``out_proj``.

Tensor-parallel (a model cut by ``distributed.sharding``, ``d_inner`` and
its heads over the model axis): ``z_proj``/``x_proj``/``dt_proj`` are
column-parallel, ``conv_x``, ``A_log``/``D``/``dt_bias`` and the SSD are
this rank's channels and heads, ``b_proj``/``c_proj`` and their convs run
whole on every rank and enter this rank's heads of the SSD through
``copy_model`` (their gradient summed over the model axis, so that the
gradients of ``h``, ``b_proj``, ``c_proj``, ``conv_b`` and ``conv_c`` are
whole on every rank), the RMSNorm over ``d_inner`` sums its squares over
the model axis before the rsqrt (``psum_model_split``: each rank
normalises its own channels, so the sum's gradient is summed over the
axis too), and ``out_proj`` is row-parallel, its
partial products summed in float32 and rounded once
(``distributed.ctx.row_parallel``). The decode state is split as the reference's
``cache_specs`` split it: ``H`` on its heads, ``conv_x`` on its channels.

Rounding follows the reference's compiled form: XLA's CPU contracts a
float32 product and sum into one fused multiply-add (the conv taps, the
chunk scan ``H·decay + S``, the ``D`` skip term, the decode update),
which ``layers.mul_add`` reproduces. The reference's ``cumsum`` lowers to a ``reduce_window``
whose order of summation neither ``torch.cumsum`` nor a sequential loop
follows, so outputs agree allclose, not bit for bit.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import Norm, lecun_normal, mul_add, rmsnorm_apply
from .config import LMConfig
from .ffn import silu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C) depthwise causal: y[t] = Σ_i w[i]·x[t-W+1+i],
    summed in the reference's order (tap 0 first), each product added with
    :func:`layers.mul_add` (XLA fuses the first into the second tap's
    rounded product)."""
    W, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    if W == 1:
        return pad * w[0]
    y = mul_add(pad[:, 0:S], w[0], pad[:, 1:1 + S] * w[1])
    for i in range(2, W):
        y = mul_add(pad[:, i:i + S], w[i], y)
    return y


def _segsum(dtA: torch.Tensor) -> torch.Tensor:
    """dtA (..., Q) -> L (..., Q, Q): L[i, j] = Σ_{j<r<=i} dtA[r], -inf j>i."""
    Q = dtA.shape[-1]
    cs = torch.cumsum(dtA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ok = torch.ones(Q, Q, dtype=torch.bool, device=dtA.device).tril()
    return diff.masked_fill(~ok, float("-inf"))


class SSM(nn.Module):
    """The reference's ``ssm_init`` tree: ``z_proj``/``x_proj`` (d, d_inner),
    ``b_proj``/``c_proj`` (d, ssm_state), ``dt_proj`` (d, ssm_heads), the
    depthwise conv weights ``conv_x``/``conv_b``/``conv_c`` (W, C) drawn
    N(0, 1/W), float32 ``A_log`` (zeros: A = -1), ``D`` (ones) and
    ``dt_bias`` (-2: softplus ~0.13) whatever the parameter dtype, the
    float32 ``out_norm`` over d_inner and ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: LMConfig, *, generator=None, dtype=torch.float32, device=None):
        super().__init__()
        d, di, ds, nh, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                             cfg.conv_width)
        kw = dict(generator=generator, dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.z_proj = nn.Parameter(lecun_normal((d, di), **kw))
        self.x_proj = nn.Parameter(lecun_normal((d, di), **kw))
        self.b_proj = nn.Parameter(lecun_normal((d, ds), **kw))
        self.c_proj = nn.Parameter(lecun_normal((d, ds), **kw))
        self.dt_proj = nn.Parameter(lecun_normal((d, nh), **kw))
        for name, c in (("conv_x", di), ("conv_b", ds), ("conv_c", ds)):
            w = torch.randn((cw, c), generator=generator, device=device).to(dtype)
            setattr(self, name, nn.Parameter(w * cw ** -0.5))
        self.A_log = nn.Parameter(torch.zeros(nh, **f32))
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.dt_bias = nn.Parameter(torch.full((nh,), -2.0, **f32))
        self.out_norm = Norm(di, "rmsnorm", device=device)
        self.out_proj = nn.Parameter(lecun_normal((di, d), fan_in=di, **kw))


def _dims(p: SSM, cfg: LMConfig) -> tuple[int, int]:
    """(d_inner, heads) this rank holds: the whole ones in one process."""
    return p.x_proj.shape[1], p.A_log.shape[0]


def _projections(p: SSM, h: torch.Tensor, split: bool = False):
    from ...distributed.ctx import copy_model
    dt = h.dtype
    # into the column-parallel z, x and dt projections
    hc = copy_model(h) if split else h
    return (hc @ p.z_proj.to(dt), hc @ p.x_proj.to(dt), h @ p.b_proj.to(dt),
            h @ p.c_proj.to(dt), hc @ p.dt_proj.to(dt))


def _conv_silu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return silu(causal_conv1d(x, w.to(x.dtype)))


def _gated_out(p: SSM, y: torch.Tensor, z: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """y (B, S, d_inner) in the compute dtype: ⊙ silu(z), RMSNorm, out_proj;
    this rank's channels of d_inner under tensor parallelism (module
    docstring)."""
    y = y * silu(z)
    if y.shape[-1] == cfg.d_inner:
        return rmsnorm_apply(p.out_norm.scale, y) @ p.out_proj.to(y.dtype)
    from ...distributed.ctx import psum_model_split, row_parallel
    yf = y.to(torch.float32)
    var = psum_model_split(yf.square().sum(dim=-1, keepdim=True)) / cfg.d_inner
    y = (yf * torch.rsqrt(var + 1e-6) * p.out_norm.scale.to(torch.float32)).to(y.dtype)
    return row_parallel(y, p.out_proj)


def ssm_apply(p: SSM, hidden: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """hidden (B, S, d) -> (B, S, d): the chunked SSD over chunks of Q, the
    largest chunk <= ``cfg.ssm_chunk`` that divides S."""
    B, S, _ = hidden.shape
    (di, nh), ds, hd = _dims(p, cfg), cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    split = di != cfg.d_inner
    z, xr, Bm, Cm, dt = _projections(p, hidden, split)
    xs = _conv_silu(xr, p.conv_x).reshape(B, S, nh, hd)
    Bm = _conv_silu(Bm, p.conv_b)
    Cm = _conv_silu(Cm, p.conv_c)
    if split:       # whole on every rank, into this rank's heads
        from ...distributed.ctx import copy_model
        Bm, Cm = copy_model(Bm), copy_model(Cm)
    A = -torch.exp(p.A_log)                                          # (nh,)
    dt = softplus(dt.to(f32) + p.dt_bias)                            # (B, S, nh)

    xc = xs.reshape(B, nc, Q, nh, hd)
    dtc = dt.reshape(B, nc, Q, nh)
    Bc = Bm.reshape(B, nc, Q, ds).to(f32)
    Cc = Cm.reshape(B, nc, Q, ds).to(f32)
    dtA = dtc * A                                                    # (B, nc, Q, nh)
    xdt = xc.to(f32) * dtc[..., None]

    # intra-chunk (quadratic within Q)
    L = torch.exp(_segsum(dtA.movedim(-1, -2)))                      # (B, nc, nh, Q, Q)
    G = torch.einsum("bnis,bnjs->bnij", Cc, Bc)                      # (B, nc, Q, Q)
    Yd = torch.einsum("bnhij,bnjhp->bnihp", G[:, :, None] * L, xdt)

    # chunk states, then the recurrence over the chunks
    cs = torch.cumsum(dtA, dim=2)                                    # (B, nc, Q, nh)
    to_end = torch.exp(cs[:, :, -1:, :] - cs)                        # decay j..end
    St = torch.einsum("bnjs,bnjh,bnjhp->bnhsp", Bc, to_end, xdt)     # (B, nc, nh, ds, hd)
    chunk_decay = torch.exp(cs[:, :, -1, :])[..., None, None]        # (B, nc, nh, 1, 1)
    H = torch.zeros(B, nh, ds, hd, dtype=f32, device=hidden.device)
    prev = []
    for n in range(nc):
        prev.append(H)                                               # the state before n
        H = mul_add(H, chunk_decay[:, n], St[:, n])
    Hprev = torch.stack(prev, dim=1)                                 # (B, nc, nh, ds, hd)
    Yo = torch.einsum("bnis,bnhsp,bnih->bnihp", Cc, Hprev, torch.exp(cs))

    y = mul_add(p.D[:, None], xs.to(f32), (Yd + Yo).reshape(B, S, nh, hd))
    return _gated_out(p, y.reshape(B, S, di).to(hidden.dtype), z, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def ssm_init_cache(cfg: LMConfig, batch: int, dtype, device=None) -> dict:
    """The decode state: ``H`` (B, nh, ds, hd) float32 and the last W-1
    pre-conv inputs of x, B and C in the compute dtype."""
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    w = cfg.conv_width - 1
    return {"H": torch.zeros((batch, nh, ds, hd), dtype=torch.float32, device=device),
            "conv_x": torch.zeros((batch, w, di), dtype=dtype, device=device),
            "conv_b": torch.zeros((batch, w, ds), dtype=dtype, device=device),
            "conv_c": torch.zeros((batch, w, ds), dtype=dtype, device=device)}


def _conv_step(buf: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """One token through the causal conv: (conv output (B, C), the new
    buffer of the last W-1 inputs)."""
    hist = torch.cat([buf, new], dim=1)                              # (B, W, C)
    return torch.einsum("bwc,wc->bc", hist, w), hist[:, 1:]


def ssm_decode_step(p: SSM, hidden: torch.Tensor, cache: dict, cfg: LMConfig):
    """hidden (B, 1, d) -> (y (B, 1, d), new cache): the O(1) recurrent
    update. The cache's tensors are not changed; the new state is new
    tensors."""
    B = hidden.shape[0]
    (di, nh), hd = _dims(p, cfg), cfg.ssm_head_dim
    f32, cdt = torch.float32, hidden.dtype
    z, xr, Bm, Cm, dt = _projections(p, hidden, di != cfg.d_inner)   # (B, 1, .)
    xo, cx = _conv_step(cache["conv_x"], xr, p.conv_x.to(cdt))
    bo, cb = _conv_step(cache["conv_b"], Bm, p.conv_b.to(cdt))
    co, cc = _conv_step(cache["conv_c"], Cm, p.conv_c.to(cdt))
    xs = silu(xo).reshape(B, nh, hd).to(f32)
    Bv, Cv = silu(bo).to(f32), silu(co).to(f32)
    A = -torch.exp(p.A_log)
    dt1 = softplus(dt[:, 0].to(f32) + p.dt_bias)                     # (B, nh)
    decay = torch.exp(dt1 * A)[..., None, None]
    # H·decay + (dt·B)·x, XLA fusing the last product: (B, nh, ds, hd)
    H = mul_add(dt1[:, :, None, None] * Bv[:, None, :, None], xs[:, :, None, :],
                cache["H"] * decay)
    y = mul_add(p.D[:, None], xs, torch.einsum("bs,bhsp->bhp", Cv, H))
    out = _gated_out(p, y.reshape(B, 1, di).to(cdt), z, cfg)
    return out, {"H": H, "conv_x": cx, "conv_b": cb, "conv_c": cc}


def ssm_prefill_state(p: SSM, hidden: torch.Tensor, cfg: LMConfig) -> dict:
    """The decode state after ``hidden`` (B, S, d): the projections again and
    ``H`` from one einsum over the whole sequence (as the reference builds
    it, not by the chunk scan), and the last W-1 pre-conv inputs."""
    B, S, _ = hidden.shape
    (di, nh), hd = _dims(p, cfg), cfg.ssm_head_dim
    f32 = torch.float32
    _, xr_pre, Bm_pre, Cm_pre, dt = _projections(p, hidden, di != cfg.d_inner)
    xs = _conv_silu(xr_pre, p.conv_x).reshape(B, S, nh, hd).to(f32)
    Bm = _conv_silu(Bm_pre, p.conv_b)
    A = -torch.exp(p.A_log)
    dtv = softplus(dt.to(f32) + p.dt_bias)
    cs = torch.cumsum(dtv * A, dim=1)
    to_end = torch.exp(cs[:, -1:, :] - cs)
    H = torch.einsum("bjs,bjh,bjhp->bhsp", Bm.to(f32), to_end * dtv, xs)
    w = cfg.conv_width - 1
    return {"H": H, "conv_x": xr_pre[:, -w:], "conv_b": Bm_pre[:, -w:],
            "conv_c": Cm_pre[:, -w:]}
