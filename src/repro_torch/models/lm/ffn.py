"""The FFNs (``repro.models.lm.ffn``), each with its Zebra site on the
hidden map, executed through the site engine: the dense SwiGLU and the
GELU MLP with biases, and the top-k MoE with sort-based dispatch.

On the ``fused`` backend the dense FFN's ``w_down`` consumes the
compressed hidden map: the engine's payload GEMM (``kernels.spmm_cs``)
skips dead blocks and the masked map is never re-read densely; the GELU
MLP adds ``b_down`` after it. The MoE site runs on the expert dispatch
buffer, (E·cap, d_ff) rows of capacity slots, and hands the engine no
weight (the per-expert products are batched GEMMs), so ``fused`` runs the
masking pass there.

Under a comm context (``distributed.ctx.comm_context``) ``ffn_apply``
treats its rows as this rank's sequence shard and gathers the output over
the context's axis (``ffn_layer_out_exchange``: masked at the
``layer_out`` site, then the compressed all-gather when the backend
declares the capability). Under the "dp" sharding profile with a mesh
declared (``sharding_hints``), the MoE of ``blocks.apply_layer`` runs
``moe_apply_dp``: each rank routes its own rows, its aux averaged and its
bytes summed over the data-parallel ranks. With neither context both are
no-ops and every path is the single-process one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.engine import LayerAux, merge_site_aux, wants_fused, zebra_site
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
    """x (B, S, d) -> (y (B, S, d), SiteAux of the hidden site); under a
    comm context y is the gathered (B, n·S, d) and the aux the hidden
    site's merged with the exchange's (``ffn_layer_out_exchange``).

    Tensor-parallel (a model cut to its shards by ``distributed.sharding``):
    ``w_gate``/``w_up``/``b_up`` are column-parallel, so the hidden map is
    this rank's d_ff columns; the site runs as ``core.engine._tp_site``
    says, and ``w_down`` is row-parallel, its partial products summed over
    the model axis (``ctx.row_parallel``; on ``fused`` inside the site, as
    the engine sums them), then ``b_down`` added
    once. x, replicated, enters the column-parallel products through
    ``copy_model`` (its gradient summed over the model axis)."""
    from ...distributed.ctx import copy_model, hint_tokens, row_parallel
    cdt = x.dtype
    # the hidden map's d_ff over the tensor-parallel axis: the columns of
    # w_gate/w_up a rank holds are already that layout
    split = p.w_up.shape[-1] != cfg.d_ff
    if split:
        x = copy_model(x)
    if cfg.act == "swiglu":
        h = silu(x @ p.w_gate.to(cdt)) * (x @ p.w_up.to(cdt))
    else:
        h = gelu(x @ p.w_up.to(cdt) + p.b_up.to(cdt))
    h = hint_tokens(h, "model", local=-1 if split else None)
    zc = _hidden_site_cfg(cfg, mode)
    if wants_fused(zc, "ffn_hidden"):
        # fused: w_down consumes the compressed hidden map (dead blocks
        # skipped); capability resolution decides legality, not a mode check
        y, zaux = zebra_site(h, zc, site="ffn_hidden", w=p.w_down.to(cdt), split=split)
    else:
        h, zaux = zebra_site(h, zc, site="ffn_hidden", tnet=getattr(p, "zebra_tnet", None),
                             split=split)
        h = checkpoint_name(h, "ffn_hidden", cfg.remat)
        w_down = _rows(p.w_down, h.shape[-1])
        # row-parallel w_down: the partial products summed over the axis
        y = row_parallel(h, w_down) if split else h @ w_down.to(cdt)
    if cfg.act == "gelu":       # once, after any reduction
        y = y + p.b_down.to(cdt)
    y, xaux = ffn_layer_out_exchange(y, cfg, mode)
    if xaux is not None:
        zaux = merge_site_aux(zaux, xaux)
    return y, zaux


def _rows(w: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``w`` this rank's ``n`` hidden columns meet: ``w`` itself
    when it has ``n`` rows, else this rank's slice over the model axis (a
    whole ``w_down`` kept for a gathered hidden map)."""
    if w.shape[0] == n:
        return w
    from ...distributed.ctx import tensor_parallel
    return w.narrow(0, tensor_parallel().model.index * n, n)


def ffn_layer_out_exchange(y: torch.Tensor, cfg: LMConfig, mode: str):
    """The sequence-parallel exchange of the FFN output.

    Inside ``distributed.ctx.comm_context`` the token rows are this rank's
    sequence shard: the output is masked at the ``layer_out`` site (by the
    constant T_obj: the wire format is the deployed comparator's, so no
    threshold net), then every shard's map is gathered over the context's
    axis in Zebra stream form (``collectives.zebra_all_gather``). Returns
    the full-sequence (B, n·S, d) output, equal to a dense all-gather of
    the masked shards bit for bit, and a SiteAux carrying the per-link
    ``ici_bytes``/``ici_dense_bytes``. Without ``layer_out`` in
    ``cfg.zebra_sites`` the map crosses unmasked (lossless).

    No comm context: ``(y, None)``, the single-process semantics. A
    capability miss (a backend without ``comms="compressed"``, a size-1
    axis, blocks that do not tile) is a dense all-gather, its reason on
    the aux's backend label."""
    from ...distributed import collectives as coll
    from ...distributed.ctx import comm_axis
    info = comm_axis()
    if info is None:
        return y, None
    n = info.size
    B, S, d = y.shape
    zc = zebra_cfg_for(cfg, mode).replace(use_tnet=False)
    if "layer_out" not in cfg.zebra_sites:
        zc = zc.replace(enabled=False)
    bs = zc.block_seq if S % zc.block_seq == 0 else 1
    bc = eff_block_ch(d, cfg)
    backend = zc.backend_for("layer_out")
    comms, reason = coll.resolve_comms(backend, rows=B * S, cols=d, bs=bs, bc=bc)
    yz, sa = zebra_site(y, zc, site="layer_out")
    if comms == "compressed":
        g, link = coll.zebra_all_gather(yz.reshape(B * S, d), info, bs=bs, bc=bc,
                                        validation=zc.validation, site="layer_out")
        sa = coll.attach_link(sa, link)
    else:
        coll.log_comm_degrade("layer_out", backend, reason)
        g = coll.gather_dense(yz, info)
        sa = coll.attach_link(sa, coll.dense_link(yz.numel() * yz.element_size(), n,
                                                  device=yz.device), reason=reason)
    return g.reshape(n, B, S, d).transpose(0, 1).reshape(B, n * S, d), sa


# ---------------------------------------------------------------------------
# MoE FFN: top-k routing, sort-based capacity dispatch
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """The reference's ``moe_init``: ``router`` (d, E) float32 whatever the
    parameter dtype (routing is computed in float32), the expert stacks
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and
    ``zebra_tnet`` for the hidden site. The stacks are drawn as the
    reference draws them: fan-in d·f for gate and up (``lecun_normal``'s
    default, every axis after the first), f for down."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(generator=generator, device=device)
        self.router = nn.Parameter(lecun_normal((d, E), dtype=torch.float32, **kw))
        self.w_gate = nn.Parameter(lecun_normal((E, d, f), dtype=dtype, **kw))
        self.w_up = nn.Parameter(lecun_normal((E, d, f), dtype=dtype, **kw))
        self.w_down = nn.Parameter(lecun_normal((E, f, d), dtype=dtype, fan_in=f, **kw))
        if cfg.zebra_enabled and "ffn_hidden" in cfg.zebra_sites and cfg.zebra_tnet:
            self.zebra_tnet = ThresholdNet(f, f // eff_block_ch(f, cfg),
                                           generator=generator, device=device)


@dataclasses.dataclass
class Routing:
    """One dispatch: ``gate`` (T, k) float32 combine weights, ``expert_idx``
    (T, k), for each of the T·k (token, choice) pairs in expert order
    ``order`` its ``dest`` slot (E·cap for a pair past its expert's
    capacity: dropped), ``slot_of`` the slot of each pair in token order,
    the capacity ``cap`` and the load-balancing loss ``router_aux``."""
    gate: torch.Tensor
    expert_idx: torch.Tensor
    order: torch.Tensor
    dest: torch.Tensor
    slot_of: torch.Tensor
    cap: int
    router_aux: torch.Tensor


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: LMConfig) -> Routing:
    """Route T tokens ``xt`` (T, d): float32 softmax over the E experts, the
    top k by a stable descending sort (``jax.lax.top_k`` keeps the lower
    expert among equal probabilities, ``torch.topk`` does not), the
    Switch-style aux ``E · Σ mean(probs) · mean(one_hot(top-1))``, and the
    capacity-bounded slots: each pair's rank among its expert's pairs in
    token order (stable argsort, then ``searchsorted`` from the left)."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)                   # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    router_aux = E * (me * ce).sum()
    cap = int(max(1, round(cfg.capacity_factor * T * k / E)))
    flat_e = expert_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * k, device=xt.device) - first
    dest = torch.where(rank < cap, sorted_e * cap + rank,
                       torch.full_like(sorted_e, E * cap))
    slot_of = torch.empty_like(dest).scatter_(0, order, dest)
    return Routing(gate, expert_idx, order, dest, slot_of, cap, router_aux)


def moe_apply(p: MoE, x: torch.Tensor, cfg: LMConfig, mode: str):
    """x (B, S, d) -> (y (B, S, d), SiteAux of the hidden site, router_aux).

    Route, scatter each (token, choice) pair into its slot of the (E·cap +
    1, d) dispatch buffer (the last row takes the dropped pairs and is cut
    off), the per-expert SwiGLU as batched GEMMs, the Zebra site on the
    (E·cap, f) hidden map, then gather each pair's output back and combine
    with the gate weights. The tokens are repeated k times by an expand
    and gathered by ``order``, a permutation: each gathered row's gradient
    lands alone in its source row, and the expand's backward sums a
    token's k copies in one reduction, in a fixed order (gathering
    ``xt[order // k]`` would add the k copies with atomic adds, in no fixed
    order). Both gathers are ``index_select``s: an indexing backward sorts
    its indices first, a third of a granite training step's device time.
    Only the dropped pairs gather one row twice, the cut-off one. The
    combine multiplies and sums in float32 and rounds once, as the
    reference's compiled combine does.

    Expert-parallel (a model cut by ``distributed.sharding``: the expert
    stacks split over the model axis): the capacity and every pair's slot
    are those of the global batch, as the reference computes them, so the
    rows are gathered over the data axis (:func:`_gather_rows`) and routed
    whole on every rank; a batch replicated over ``data`` (a layout whose
    data axis has one rank) is the global batch already, gathered from
    nowhere. A rank fills only its experts' slots, runs their
    GEMMs and the site on its rows of the hidden map
    (``zebra_site(split="rows")``), gathers every expert's output over the
    model axis and combines as one process, keeping its own rows.
    ``router_aux`` is the global batch's, the same on every rank. In
    training the gathered rows enter this rank's experts through
    ``copy_model`` (each rank's experts see only their slots, so that
    gradient is summed over the model axis), while the router, which
    every model rank runs whole, takes them as they are; the expert
    outputs' gather feeds the combine every model rank holds whole, so its
    backward keeps this rank's experts' slice."""
    from ...distributed.ctx import tensor_parallel
    tp = tensor_parallel()
    B, S, d = x.shape
    E, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff
    xs = x if tp is None else _gather_rows(x, tp)
    T = xs.shape[0] * S
    xt = xs.reshape(T, d)
    r = moe_route(p.router, xt, cfg)
    El = p.w_gate.shape[0]                  # the experts this rank holds
    n, dest = El * r.cap, r.dest
    if tp is not None:
        dest = dest - tp.model.index * n
        dest = torch.where((dest >= 0) & (dest < n), dest, torch.full_like(dest, n))
    if tp is not None:
        from ...distributed.ctx import copy_model
        xe = copy_model(xt)
    else:
        xe = xt
    rows = xe[:, None].expand(T, k, d).reshape(T * k, d).index_select(0, r.order)
    buf = x.new_zeros((n + 1, d)).index_put((dest,), rows)
    eb = buf[:n].reshape(El, r.cap, d)
    cdt = x.dtype
    h = silu(torch.bmm(eb, p.w_gate.to(cdt))) * torch.bmm(eb, p.w_up.to(cdt))
    hz, zaux = zebra_site(h.reshape(1, n, f), _hidden_site_cfg(cfg, mode),
                          site="ffn_hidden", tnet=getattr(p, "zebra_tnet", None),
                          split="rows" if tp is not None else False)
    y_e = torch.bmm(hz.reshape(El, r.cap, f), p.w_down.to(cdt))
    if tp is not None:
        from ...distributed.ctx import gather_model
        y_e = gather_model(y_e, 0)
    y_flat = torch.cat([y_e.reshape(E * r.cap, d), y_e.new_zeros((1, d))])
    per_choice = y_flat.index_select(0, r.slot_of).reshape(T, k, d)
    y = (per_choice.float() * r.gate.to(cdt).float()[..., None]).sum(dim=1).to(cdt)
    y = y.reshape(-1, S, d)
    if tp is not None:
        y = y.narrow(0, tp.data.index * B, B)
    return y, zaux, r.router_aux


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows concatenated along dim 0; the backward sums
    the global rows' gradient over the data axis and keeps this rank's
    rows. A sum, not a mean: each data rank's loss holds the global
    batch's ``router_aux`` (and its rows' share of the combine), and the
    train step's mean over ``data`` divides the summed gradient once."""

    @staticmethod
    def forward(ctx, x, axis):
        from ...distributed.collectives import tp_all_gather
        ctx.axis, ctx.n = axis, x.shape[0]
        return tp_all_gather(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        from ...distributed.collectives import tp_all_reduce
        g = tp_all_reduce(g.contiguous(), ctx.axis, backward=True)
        return g.narrow(0, ctx.axis.index * ctx.n, ctx.n), None


def _gather_rows(x: torch.Tensor, tp) -> torch.Tensor:
    """The global batch: every data rank's rows of ``x`` in data-rank
    order, the dispatch every rank of the expert-parallel MoE routes
    (:class:`_GatherRows`)."""
    if tp.data.size == 1:
        return x
    return _GatherRows.apply(x, tp.data)


def moe_apply_dp(p: MoE, x: torch.Tensor, cfg: LMConfig, mode: str, mesh,
                 dp_axes_t: tuple[str, ...]):
    """The pure data-parallel MoE (small-expert models): ``x`` is this
    rank's rows of the global batch, routed and dispatched here against
    the replicated expert stack, with no expert-parallel traffic; the
    capacity is per shard, so the dispatch buffer is 1/n_shards of the
    global one. Returns (y of the local rows, LayerAux): ``reg``, the
    zero-block count and ``router_aux`` are means over the ranks of
    ``dp_axes_t`` (``collectives.shard_mean``, every rank the same bits),
    the measured bytes their exact sum (each shard moves its own
    stream)."""
    from ...distributed.collectives import psum_exact_bytes, shard_mean
    from ...distributed.ctx import axis_of
    dp = axis_of(mesh, dp_axes_t[0] if len(dp_axes_t) == 1 else tuple(dp_axes_t))
    y, sa, raux = moe_apply(p, x, cfg, mode)
    la = LayerAux.of_site(sa)
    reg, zfb, raux = shard_mean(torch.stack([la.reg, la.zf_blocks, raux.float()]), dp)
    return y, LayerAux(reg=reg, zf_blocks=zfb, n_blocks=la.n_blocks,
                       measured_bytes=psum_exact_bytes(sa.measured_bytes, dp),
                       router_aux=raux)
