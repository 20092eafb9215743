"""Griffin's recurrent block with the RG-LRU (``repro.models.lm.rglru``; De
et al., arXiv:2402.19427), with its decode cache and step.

Block: x -> [linear -> GeLU] gate branch ∥ [linear -> causal conv1d ->
RG-LRU] recurrent branch -> ⊙ -> out linear.

RG-LRU:  r_t = σ(W_a u_t + b_a);  i_t = σ(W_x u_t + b_x)
         log a_t = -c · softplus(Λ) · r_t            (c = 8)
         h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The sequence recurrence is a first-order linear scan. The reference runs
it as ``jax.lax.associative_scan`` with ``combine((al, bl), (ar, br)) =
(al·ar, ar·bl + br)``; :func:`linear_scan` is the same odd-even recursion
(combine adjacent pairs, recurse on the half, fill in the evens), so each
h_t is the same tree of the same roundings, with ``ar·bl + br`` fused as
XLA's CPU fuses it (``layers.mul_add``): it equals the reference bit for
bit in float32. It has O(log S) depth; a cumulative product in log space
would lose small ``a``. Decode is an O(1) update.

Tensor-parallel (a model cut by ``distributed.sharding``, ``lru_dim`` over
the model axis): both branches are column-parallel and the conv is this
rank's channels, so ``u`` is too; the gates' ``w_a``/``w_x`` are split by
output column and take the whole ``u``, gathered over the model axis
(``gather_model_split``: each rank's gates see all of ``u``, so the
gathered gradient is summed over the axis before this rank keeps its
slice), while ``i · u`` takes this rank's slice; the scan runs on this rank's
channels, and ``w_out`` is row-parallel, its partial products summed in
float32 and rounded once (``distributed.ctx.row_parallel``). The
decode state ``h`` and the conv ring are split on their channels.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import lecun_normal, mul_add
from .config import LMConfig
from .ffn import gelu
from .ssm import causal_conv1d, softplus

C = 8.0      # the gate's constant c


class RGLRU(nn.Module):
    """The reference's ``rglru_init`` tree: ``w_gate_branch``/``w_rec_branch``
    (d, lru_dim), ``conv_w`` (W, lru_dim) drawn N(0, 1/W), ``w_a``/``w_x``
    (lru_dim, lru_dim), float32 ``b_a``/``b_x`` (zeros) and ``lam``
    whatever the parameter dtype, and ``w_out`` (lru_dim, d). Λ is drawn
    so that a^c lies in [0.9, 0.999] at r = 1 (the paper's App. A):
    u ~ U(0.9, 0.999), Λ = softplus⁻¹(-log(u) / c)."""

    def __init__(self, cfg: LMConfig, *, generator=None, dtype=torch.float32, device=None):
        super().__init__()
        d, dl, cw = cfg.d_model, cfg.lru_dim, cfg.conv_width
        kw = dict(generator=generator, dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        u = 0.9 + (0.999 - 0.9) * torch.rand(dl, generator=generator, device=device)
        self.w_gate_branch = nn.Parameter(lecun_normal((d, dl), **kw))
        self.w_rec_branch = nn.Parameter(lecun_normal((d, dl), **kw))
        w = torch.randn((cw, dl), generator=generator, device=device).to(dtype)
        self.conv_w = nn.Parameter(w * cw ** -0.5)
        self.w_a = nn.Parameter(lecun_normal((dl, dl), **kw))
        self.b_a = nn.Parameter(torch.zeros(dl, **f32))
        self.w_x = nn.Parameter(lecun_normal((dl, dl), **kw))
        self.b_x = nn.Parameter(torch.zeros(dl, **f32))
        self.lam = nn.Parameter(torch.log(torch.expm1(-torch.log(u) / C)))
        self.w_out = nn.Parameter(lecun_normal((dl, d), fan_in=dl, **kw))


def _gates(p: RGLRU, u: torch.Tensor):
    """u (B, S, lru_dim), this rank's channels under tensor parallelism ->
    the scan's (a, b), float32."""
    from ...distributed.ctx import gather_model_split
    f32 = torch.float32
    uw = u if u.shape[-1] == p.w_a.shape[0] else gather_model_split(u, -1)
    r = torch.sigmoid(uw @ p.w_a.to(u.dtype) + p.b_a.to(u.dtype))
    i = torch.sigmoid(uw @ p.w_x.to(u.dtype) + p.b_x.to(u.dtype))
    log_a = (-C * softplus(p.lam)) * r.to(f32)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * (i.to(f32) * u.to(f32))
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along dim 1: even[0], odd[0], even[1], ... (``even`` as long as
    ``odd`` or one longer)."""
    n = even.shape[1] + odd.shape[1]
    if even.shape[1] == odd.shape[1]:
        return torch.stack([even, odd], dim=2).reshape(even.shape[0], n, *even.shape[2:])
    return torch.cat([_interleave(even[:, :-1], odd), even[:, -1:]], dim=1)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t along dim 1 from h_{-1} = 0, as
    ``jax.lax.associative_scan`` computes it (module docstring)."""
    def combine(al, bl, ar, br):
        return al * ar, mul_add(ar, bl, br)

    def scan(a, b):
        n = a.shape[1]
        if n < 2:
            return a, b
        odd_a, odd_b = scan(*combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2]))
        m = odd_a.shape[1] - (n % 2 == 0)       # the odd prefixes that start an even
        ev_a, ev_b = combine(odd_a[:, :m], odd_b[:, :m], a[:, 2::2], b[:, 2::2])
        return (_interleave(torch.cat([a[:, :1], ev_a], 1), odd_a),
                _interleave(torch.cat([b[:, :1], ev_b], 1), odd_b))

    return scan(a, b)[1]


def _recurrence(p: RGLRU, x: torch.Tensor):
    """x (B, S, d) -> (the gate branch, the recurrent branch's pre-conv input
    u_in, the hidden sequence h (B, S, lru_dim) float32)."""
    from ...distributed.ctx import copy_model
    if p.w_a.shape[1] != p.w_a.shape[0]:
        x = copy_model(x)   # into the column-parallel branches
    gate = gelu(x @ p.w_gate_branch.to(x.dtype))
    u_in = x @ p.w_rec_branch.to(x.dtype)
    a, b = _gates(p, causal_conv1d(u_in, p.conv_w.to(x.dtype)))
    return gate, u_in, linear_scan(a, b)


def _out(p: RGLRU, h: torch.Tensor, gate: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """(h ⊙ gate) @ w_out, row-parallel under tensor parallelism
    (``distributed.ctx.row_parallel``)."""
    from ...distributed.ctx import row_parallel
    y = h.to(gate.dtype) * gate
    if p.w_out.shape[0] == cfg.lru_dim:
        return y @ p.w_out.to(gate.dtype)
    return row_parallel(y, p.w_out)


def rglru_apply(p: RGLRU, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the full-sequence (training, prefill) path."""
    gate, _, h = _recurrence(p, x)
    return _out(p, h, gate, cfg)


def rglru_prefill(p: RGLRU, x: torch.Tensor, cfg: LMConfig):
    """:func:`rglru_apply` and the decode state after it: ``h`` the float32
    last state, ``conv`` the last W-1 pre-conv inputs."""
    gate, u_in, h = _recurrence(p, x)
    return _out(p, h, gate, cfg), {"h": h[:, -1], "conv": u_in[:, -(cfg.conv_width - 1):]}


def rglru_init_cache(cfg: LMConfig, batch: int, dtype, device=None) -> dict:
    dl = cfg.lru_dim
    return {"h": torch.zeros((batch, dl), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, dl), dtype=dtype, device=device)}


def rglru_decode_step(p: RGLRU, x: torch.Tensor, cache: dict, cfg: LMConfig):
    """x (B, 1, d) -> (y (B, 1, d), new cache): O(1). The cache's tensors are
    not changed; the new state is new tensors."""
    from ...distributed.ctx import copy_model
    x = copy_model(x)
    gate = gelu(x @ p.w_gate_branch.to(x.dtype))
    u_in = x @ p.w_rec_branch.to(x.dtype)                            # (B, 1, dl)
    hist = torch.cat([cache["conv"], u_in], dim=1)
    u = torch.einsum("bwc,wc->bc", hist, p.conv_w.to(x.dtype))[:, None]
    a, b = _gates(p, u)                                              # (B, 1, dl)
    h = mul_add(a[:, 0], cache["h"], b[:, 0])
    return _out(p, h[:, None], gate, cfg), {"h": h, "conv": hist[:, 1:]}
