"""Layer assembly for the LM stack (``repro.models.lm.blocks``): one layer
of the pattern, an attention layer ("global" or "local"), Griffin's
recurrent block ("rglru") or Mamba-2's SSD block ("ssm"), in an
encoder-decoder also cross-attention to the encoder's output, then its
FFN (dense or MoE; none after an "ssm" block or with ``d_ff`` 0), in three
forms: the full-sequence forward (causal, or not for the encoder), the
prefill that also emits the decode cache (K/V for attention, the
recurrent state and the conv buffer otherwise), and the one-token decode
step against that cache.

Every layer returns a ``core.engine.LayerAux`` accumulated over its Zebra
sites (``kv_cache`` in prefill, ``ffn_hidden``, ``layer_out``), which all
run through the site engine, and an MoE layer's ``router_aux``.
``Layer`` is the counterpart of the reference's ``init_layer``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.engine import LayerAux, zebra_site
from ...core.zebra import ThresholdNet
from ...distributed.ctx import hint_tokens
from ..layers import Norm, lecun_normal
from . import attention as attn
from .config import LMConfig
from .ffn import (FFN, MoE, eff_block_ch, ffn_apply, moe_apply, moe_apply_dp,
                  zebra_cfg_for)
from .remat import checkpoint_name
from .rglru import RGLRU, rglru_apply, rglru_decode_step, rglru_init_cache, rglru_prefill
from .ssm import SSM, ssm_apply, ssm_decode_step, ssm_init_cache, ssm_prefill_state

LAYER_TYPES = ("global", "local", "rglru", "ssm")


class Attention(nn.Module):
    """Head-major projections as the reference stores them: ``wq`` (d, Hq,
    hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (Hq, hd, d); with
    ``cfg.qkv_bias`` also ``bq`` (Hq, hd) and ``bk``/``bv`` (Hkv, hd), zero
    at init as in the reference."""

    def __init__(self, cfg: LMConfig, *, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = nn.Parameter(lecun_normal((d, nq, hd), fan_in=d, **kw))
        self.wk = nn.Parameter(lecun_normal((d, nkv, hd), fan_in=d, **kw))
        self.wv = nn.Parameter(lecun_normal((d, nkv, hd), fan_in=d, **kw))
        self.wo = nn.Parameter(lecun_normal((nq, hd, d), fan_in=nq * hd, **kw))
        if cfg.qkv_bias:
            for name, h in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                setattr(self, name, nn.Parameter(torch.zeros(h, hd, dtype=dtype,
                                                             device=device)))


class Layer(nn.Module):
    """``norm1``, then ``attn`` ("global", "local"), ``rec`` ("rglru") or
    ``ssm`` ("ssm"), with ``cross`` also ``norm_c`` and ``cross`` (the
    cross-attention projections), then, unless the layer is "ssm" or
    ``d_ff`` is 0, ``norm2`` and ``moe`` when ``cfg.is_moe``, else ``ffn``
    (and ``zebra_out_tnet``, the layer-output site's threshold net, when
    that site trains one)."""

    def __init__(self, typ: str, cfg: LMConfig, *, cross: bool = False, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if typ not in LAYER_TYPES:
            raise ValueError(f"unknown layer type {typ!r}; known: {LAYER_TYPES}")
        self.typ = typ
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        if typ == "rglru":
            self.rec = RGLRU(cfg, **kw)
        elif typ == "ssm":
            self.ssm = SSM(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if cross:
            self.norm_c = Norm(cfg.d_model, cfg.norm, device=device)
            self.cross = Attention(cfg, **kw)
        if typ != "ssm" and cfg.d_ff > 0:
            self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
            if cfg.is_moe:
                self.moe = MoE(cfg, **kw)
            else:
                self.ffn = FFN(cfg, **kw)
        if cfg.zebra_enabled and "layer_out" in cfg.zebra_sites and cfg.zebra_tnet:
            nblk = cfg.d_model // eff_block_ch(cfg.d_model, cfg)
            self.zebra_out_tnet = ThresholdNet(cfg.d_model, nblk, generator=generator,
                                               device=device)


# ---------------------------------------------------------------------------
# Per-layer forward (full sequence)
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul in x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)``."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.to(o.dtype).reshape(h * k, d)


def _attn_out(o: torch.Tensor, p: Attention, cfg: LMConfig) -> torch.Tensor:
    """The attention output projection; under tensor parallelism with the
    heads split, ``wo`` is row-parallel (this rank's heads), so its partial
    products are summed over the model axis (``ctx.row_parallel``). Heads
    that do not split over it stay whole (the reference's specs drop the
    axis): the attention then runs replicated."""
    from ...distributed.ctx import row_parallel
    if p.wo.shape[0] == cfg.n_heads:
        return _out_proj(o, p.wo)
    h, k, d = p.wo.shape
    return row_parallel(o.reshape(*o.shape[:-2], h * k), p.wo.reshape(h * k, d))


def _kv_heads(p: Attention, cfg: LMConfig, k: torch.Tensor, v: torch.Tensor):
    """K/V for this rank's query heads. Without tensor parallelism, or with
    K/V split with the queries (``n_kv_heads`` divisible by the model
    axis), they are the heads in hand: the GQA grouping holds. Where the
    queries are split but K/V are replicated, the KV heads of this rank's
    query heads: a slice when they group evenly, else one per query
    head."""
    hq = p.wq.shape[1]
    if hq == cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        return k, v
    from ...distributed.ctx import tensor_parallel
    G = cfg.n_heads // cfg.n_kv_heads
    q0 = tensor_parallel().model.index * hq
    idx = [(q0 + i) // G for i in range(hq)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hq % n == 0 and idx == [lo + i // (hq // n) for i in range(hq)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _qkv(p: Attention, x: torch.Tensor, cfg: LMConfig, rope):
    """Q, K, V of x with RoPE. Under tensor parallelism x is replicated and
    the projections are head-sharded, so x enters them through
    ``copy_model`` (its gradient summed over the model axis); K/V
    replicated while the queries split are used only for this rank's query
    heads (:func:`_kv_heads`), so their weights' gradients are partial and
    enter the same way. Heads that do not split run replicated, and every
    gradient is whole on every rank."""
    from ...distributed.ctx import copy_model
    kv = [p.wk, p.wv, *((p.bk, p.bv) if cfg.qkv_bias else ())]
    if p.wq.shape[1] != cfg.n_heads:
        x = copy_model(x)
        if p.wk.shape[1] == cfg.n_kv_heads:
            kv = [copy_model(t) for t in kv]
    q, k, v = _proj(x, p.wq), _proj(x, kv[0]), _proj(x, kv[1])
    if cfg.qkv_bias:        # after the projection, before RoPE
        q, k, v = q + p.bq.to(x.dtype), k + kv[2].to(x.dtype), v + kv[3].to(x.dtype)
    cos, sin = rope
    return attn.apply_rope(q, cos, sin), attn.apply_rope(k, cos, sin), v


def _attend(q, k, v, typ: str, cfg: LMConfig, causal: bool = True):
    """The reference's choice of attention path for a full sequence (the
    encoder's non-causal layers attend in full, whatever their length)."""
    S = q.shape[1]
    if typ == "local" and S > cfg.window:
        local = (attn.attend_local_scanned if cfg.local_impl == "scanned"
                 else attn.attend_local)
        return local(q, k, v, window=cfg.window)
    if S <= cfg.attn_chunk or not causal:
        return attn.attend_full(q, k, v, causal=causal,
                                window=cfg.window if typ == "local" else 0)
    return attn.attend_chunked(q, k, v, chunk=cfg.attn_chunk)


def _enc_kv(p: Attention, enc_out: torch.Tensor):
    """The cross-attention's K and V of the encoder output (B, T, d)."""
    return _proj(enc_out, p.wk), _proj(enc_out, p.wv)


def _cross_attention(p: Layer, x: torch.Tensor, enc_out: torch.Tensor | None,
                     cfg: LMConfig) -> torch.Tensor:
    """x plus the cross-attention of its ``norm_c`` to the encoder output,
    when the layer has one and an encoder output is given (the reference
    adds no Q/K/V biases and no RoPE here, and recomputes K and V at every
    call, decode steps included). Under tensor parallelism the heads are
    split as self-attention's, and the replicated query input and encoder
    output enter the head-sharded projections through ``copy_model``."""
    from ...distributed.ctx import copy_model
    if not hasattr(p, "cross") or enc_out is None:
        return x
    h = p.norm_c(x)
    if p.cross.wq.shape[1] != cfg.n_heads:
        h, enc_out = copy_model(h), copy_model(enc_out)
    q = _proj(h, p.cross.wq)
    k, v = _enc_kv(p.cross, enc_out)
    o = attn.attend_full(q, *_kv_heads(p.cross, cfg, k, v), causal=False)
    return x + _attn_out(o, p.cross, cfg)


def _layer_out_zebra(p: Layer, x: torch.Tensor, cfg: LMConfig, mode: str):
    zc = zebra_cfg_for(cfg, mode)
    if "layer_out" not in cfg.zebra_sites:
        zc = zc.replace(enabled=False)
    return zebra_site(x, zc, site="layer_out", tnet=getattr(p, "zebra_out_tnet", None))


def _ffn(p: Layer, h: torch.Tensor, cfg: LMConfig, mode: str):
    """(y, SiteAux, router_aux) of the layer's dense or MoE FFN."""
    if hasattr(p, "moe"):
        return moe_apply(p.moe, h, cfg, mode)
    return (*ffn_apply(p.ffn, h, cfg, mode), 0.0)


def _ffn_residual(p: Layer, x: torch.Tensor, cfg: LMConfig, mode: str, aux: LayerAux,
                  dp_moe: bool = False):
    """x plus the layer's FFN of its ``norm2``, if it has one. With
    ``dp_moe`` an MoE layer goes through :func:`_moe` (the forward's
    dispatch, as the reference's ``apply_layer``)."""
    if not hasattr(p, "norm2"):
        return x, aux
    if dp_moe and hasattr(p, "moe"):
        y, moe_aux = _moe(p.moe, p.norm2(x), cfg, mode)
        return x + y, aux + moe_aux
    y, zaux, raux = _ffn(p, p.norm2(x), cfg, mode)
    return x + y, aux + LayerAux.of_site(zaux, raux)


def _moe(p: MoE, h2: torch.Tensor, cfg: LMConfig, mode: str) -> tuple[torch.Tensor, LayerAux]:
    """The data-parallel dispatch (``moe_apply_dp``) when the profile asks
    for it and ``distributed.ctx.sharding_hints`` declares a mesh; the
    single-process dispatch otherwise."""
    if cfg.sharding_profile == "dp":
        from ...distributed.ctx import active_mesh, dp_axes
        mesh = active_mesh()
        if mesh is not None:
            return moe_apply_dp(p, h2, cfg, mode, mesh, dp_axes())
    y, zaux, raux = moe_apply(p, h2, cfg, mode)
    return y, LayerAux.of_site(zaux, raux)


def apply_layer(p: Layer, x: torch.Tensor, typ: str, cfg: LMConfig, mode: str, rope,
                enc_out: torch.Tensor | None = None, causal: bool = True
                ) -> tuple[torch.Tensor, LayerAux]:
    aux = LayerAux.zero(x.device)
    h = p.norm1(x)
    if typ == "rglru":
        x = x + rglru_apply(p.rec, h, cfg)
    elif typ == "ssm":
        x = x + ssm_apply(p.ssm, h, cfg)
    else:
        q, k, v = _qkv(p.attn, h, cfg, rope)
        # heads over the model axis, where they split
        q = hint_tokens(q, "model", None, local=-2 if q.shape[2] != cfg.n_heads else None)
        o = checkpoint_name(_attend(q, *_kv_heads(p.attn, cfg, k, v), typ, cfg, causal),
                            "attn_out", cfg.remat)
        x = x + _attn_out(o, p.attn, cfg)
    x = _cross_attention(p, x, enc_out, cfg)
    x, aux = _ffn_residual(p, x, cfg, mode, aux, dp_moe=True)
    x, zo = _layer_out_zebra(p, x, cfg, mode)
    return x, aux + LayerAux.of_site(zo)


# ---------------------------------------------------------------------------
# Caches + prefill / decode per layer
# ---------------------------------------------------------------------------

def init_layer_cache(typ: str, cfg: LMConfig, batch: int, cache_len: int, dtype,
                     device=None) -> dict:
    """A layer's empty decode cache: K/V (B, T, Hkv, hd) in ``dtype`` for
    attention, the float32 state and the ``dtype`` conv buffers for
    "rglru" and "ssm"."""
    if typ == "rglru":
        return rglru_init_cache(cfg, batch, dtype, device)
    if typ == "ssm":
        return ssm_init_cache(cfg, batch, dtype, device)
    if typ not in LAYER_TYPES:
        raise ValueError(f"unknown layer type {typ!r}; known: {LAYER_TYPES}")
    T = min(cfg.window, cache_len) if typ == "local" else cache_len
    shape = (batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache: torch.Tensor, new: torch.Tensor, slot) -> torch.Tensor:
    """Write one token's K or V (B, 1, Hkv, hd) at ``slot``, in place: an
    ``int`` (every lane writes the same position) or a (B,) tensor of
    per-lane slots (the slotted continuous-batching decode: lane b writes
    its own position, ``cache[b, slot[b]]``). The reference's
    ``dynamic_update_slice`` and ``where(hit, new, cache)`` return a new
    cache; the port updates the one it has."""
    if isinstance(slot, torch.Tensor):
        lanes = torch.arange(cache.shape[0], device=cache.device)
        cache[lanes, slot] = new[:, 0].to(cache.dtype)
        return cache
    cache[:, slot:slot + 1] = new.to(cache.dtype)
    return cache


def apply_layer_decode(p: Layer, x: torch.Tensor, cache: dict, typ: str, cfg: LMConfig,
                       pos, rope1, enc_out: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, dict]:
    """x (B, 1, d) at position ``pos``, an ``int`` or (B,) per-lane
    positions (a local layer's ring slot is ``pos % T`` per lane). Returns
    (x, cache): an attention layer's K/V updated in place, a recurrent
    layer's new state in new tensors (the caller writes them back where the
    cache is a slice of a stack)."""
    h = p.norm1(x)
    if typ == "rglru":
        y, cache = rglru_decode_step(p.rec, h, cache, cfg)
        x = x + y
    elif typ == "ssm":
        y, cache = ssm_decode_step(p.ssm, h, cache, cfg)
        x = x + y
    else:
        q, k, v = _qkv(p.attn, h, cfg, rope1)
        T = cache["k"].shape[1]
        slot = pos % T if typ == "local" else pos
        kc = _cache_write(cache["k"], k, slot)
        vc = _cache_write(cache["v"], v, slot)
        o = attn.attend_decode(q, *_kv_heads(p.attn, cfg, kc, vc), pos,
                               window=cfg.window if typ == "local" else 0)
        x = x + _attn_out(o, p.attn, cfg)
        cache = {"k": kc, "v": vc}
    x = _cross_attention(p, x, enc_out, cfg)
    if hasattr(p, "norm2"):
        y, *_ = _ffn(p, p.norm2(x), cfg, "infer")
        x = x + y
    return x, cache


def apply_layer_prefill(p: Layer, x: torch.Tensor, typ: str, cfg: LMConfig, rope,
                        cache_len: int, enc_out: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, dict, LayerAux]:
    """Forward + the decode cache. Returns (x, cache, aux)."""
    aux = LayerAux.zero(x.device)
    h = p.norm1(x)
    if typ == "rglru":
        y, cache = rglru_prefill(p.rec, h, cfg)
        x = x + y
    elif typ == "ssm":
        # the full SSD, then the final state rebuilt from the whole sequence
        x = x + ssm_apply(p.ssm, h, cfg)
        cache = ssm_prefill_state(p.ssm, h, cfg)
    else:
        x, cache, aux = _attention_prefill(p, x, h, typ, cfg, rope, cache_len, aux)
    x = _cross_attention(p, x, enc_out, cfg)
    x, aux = _ffn_residual(p, x, cfg, "infer", aux)
    x, zo = _layer_out_zebra(p, x, cfg, "infer")
    return x, cache, aux + LayerAux.of_site(zo)


def _attention_prefill(p: Layer, x: torch.Tensor, h: torch.Tensor, typ: str, cfg: LMConfig,
                       rope, cache_len: int, aux: LayerAux):
    """The attention layer's prefill: x plus its attention of ``h``, its K/V
    cache (through the ``kv_cache`` site when Zebra runs there) and aux."""
    S = x.shape[1]
    q, k, v = _qkv(p.attn, h, cfg, rope)
    x = x + _attn_out(_attend(q, *_kv_heads(p.attn, cfg, k, v), typ, cfg), p.attn, cfg)
    if cfg.zebra_enabled and "kv_cache" in cfg.zebra_sites:
        # Zebra block-compress the cache at its write (tensor-parallel: the
        # heads this rank holds, a split map where K/V split with the queries)
        k, v, kv_auxes = attn.zebra_kv_site(k, v, zebra_cfg_for(cfg, "infer"),
                                            split=k.shape[2] != cfg.n_kv_heads)
        for a in kv_auxes:
            aux = aux + LayerAux.of_site(a)
    if typ == "local":
        T = min(cfg.window, cache_len)
        cache = {"k": k[:, -T:].to(x.dtype), "v": v[:, -T:].to(x.dtype)}
        if T > S:
            cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, T - S))
                     for n, c in cache.items()}
    else:
        cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, cache_len - S)).to(x.dtype)
                 for n, c in (("k", k), ("v", v))}
    return x, cache, aux
