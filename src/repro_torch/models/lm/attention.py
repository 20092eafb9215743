"""Attention for the LM stack (``repro.models.lm.attention``): GQA + RoPE.

* ``attend_full``    — O(S·T) attention, causal or not (short sequences;
  with ``causal=False`` whisper's encoder and cross-attention, T != S).
* ``attend_chunked`` — causal attention over (chunk, chunk) tiles with an
  online softmax: live memory O(chunk²) per step.
* ``attend_local``   — exact sliding-window attention in banded-chunk form:
  window W == chunk, each query chunk attends [prev, self] chunks with an
  in-band mask. Cost O(S·W), gemma-3's local layers.
* ``attend_local_scanned`` — the same window one chunk at a time, each
  chunk under ``torch.utils.checkpoint`` when gradients are on: one chunk's
  (B, H, G, W, 2W) scores alive at a time, recomputed in the backward.
* ``attend_decode``  — one query token against a KV cache.
* ``gather_kv_shards`` — sequence-sharded K/V gathered over the comm axis
  (``distributed.ctx.comm_context``); a no-op without one.

Plain PyTorch, with the reference's numerics: scores in float32 (the
products of the compute dtype summed in float32), softmax in float32, the
probabilities cast back to the values' dtype for the second product.

Layout: q (B, S, Hq, hd), k/v (B, S, Hkv, hd), GQA via reshape to
(B, S, Hkv, G, hd).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0 ** 30   # large-but-finite: keeps all-masked rows NaN-free


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                      exps)
    ang = positions.to(torch.float32)[..., None] * freqs          # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Full attention
# ---------------------------------------------------------------------------

def _scale(q: torch.Tensor) -> torch.Tensor:
    """q · hd**-0.5 in q's dtype (the constant rounded to it, as JAX's
    weakly typed scalar is)."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)


def attend_full(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of S queries over T keys: causal (key j visible to query i
    iff j <= i) or not (every key visible; T may differ from S); with
    ``window``, also 0 <= i - j < window."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _scale(q.reshape(B, S, Hkv, G, hd))
    s = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())   # (B,Hkv,G,S,T)
    if causal or window:
        qi = torch.arange(S, device=q.device)[:, None]
        kj = torch.arange(T, device=q.device)[None, :]
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            ok &= qi >= kj
        if window:
            ok &= qi - kj < window
        s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype), v)
    return o.reshape(B, S, Hq, hd)


# ---------------------------------------------------------------------------
# Chunked causal attention (online softmax)
# ---------------------------------------------------------------------------

def attend_chunked(q, k, v, *, chunk: int = 1024):
    """Causal attention in (chunk, chunk) tiles with the online-softmax
    recurrence, KV chunks in ascending order; never materialises S²."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    Cq, Ck = min(chunk, S), min(chunk, T)
    assert S % Cq == 0 and T % Ck == 0, (S, T, chunk)
    nq, nk = S // Cq, T // Ck
    qg = _scale(q.reshape(B, nq, Cq, Hkv, G, hd))
    kc = k.reshape(B, nk, Ck, Hkv, hd)
    vc = v.reshape(B, nk, Ck, Hkv, hd)
    dev = q.device
    outs = []
    for i in range(nq):
        qi_blk = qg[:, i].float()                                  # (B,Cq,Hkv,G,hd)
        m = torch.full((B, Hkv, G, Cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, Cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, Cq, hd), dtype=torch.float32, device=dev)
        for j in range(nk):
            s = torch.einsum("bchgd,bthd->bhgct", qi_blk, kc[:, j].float())
            qpos = i * Cq + torch.arange(Cq, device=dev)
            kpos = j * Ck + torch.arange(Ck, device=dev)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgct,bthd->bhgcd", p.to(v.dtype), vc[:, j])
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.movedim(3, 1))                               # (B,Cq,Hkv,G,hd)
    o = torch.stack(outs, dim=1).reshape(B, S, Hq, hd)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Exact sliding-window attention, banded-chunk form
# ---------------------------------------------------------------------------

def attend_local(q, k, v, *, window: int):
    """Causal sliding window: key j visible iff 0 <= qi - j < window.
    Chunk size == window over [prev, self] chunk pairs."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    W = min(window, S)
    assert S % W == 0, (S, window)
    nc = S // W
    dev = q.device
    qg = _scale(q.reshape(B, nc, W, Hkv, G, hd))
    kc = k.reshape(B, nc, W, Hkv, hd)
    vc = v.reshape(B, nc, W, Hkv, hd)
    pad = torch.zeros_like(kc[:, :1])
    k2 = torch.cat([torch.cat([pad, kc[:, :-1]], 1), kc], dim=2)     # (B,nc,2W,..)
    v2 = torch.cat([torch.cat([pad, vc[:, :-1]], 1), vc], dim=2)
    s = torch.einsum("bnchgd,bnthd->bnhgct", qg.float(), k2.float())  # (B,nc,H,G,W,2W)
    qi = torch.arange(W, device=dev)[:, None] + W                     # in-pair coords
    kj = torch.arange(2 * W, device=dev)[None, :]
    ok = (qi >= kj) & (qi - kj < W)
    ok0 = ok & (kj >= W)                                              # chunk 0: no prev
    mask = torch.where((torch.arange(nc, device=dev) == 0)[:, None, None],
                       ok0[None], ok[None])                           # (nc,W,2W)
    s = torch.where(mask[None, :, None, None], s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhgct,bnthd->bnchgd", p.to(v2.dtype), v2)
    return o.reshape(B, S, Hq, hd)


def _local_chunk(qc, k2, v2, mask):
    """One query chunk (B, W, Hkv, G, hd) of the sliding window against its
    [prev, self] keys and values (B, 2W, Hkv, hd) under ``mask`` (W, 2W)."""
    s = torch.einsum("bchgd,bthd->bhgct", qc.float(), k2.float())     # (B,H,G,W,2W)
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgct,bthd->bchgd", p.to(v2.dtype), v2)


def attend_local_scanned(q, k, v, *, window: int):
    """``attend_local``'s sliding window, one query chunk at a time: chunk i
    attends chunks [i-1, i] (chunk 0 a zero chunk before it, masked). With
    gradients on, each chunk runs under ``torch.utils.checkpoint`` (the
    reference's checkpointed ``lax.map`` body): the forward keeps no
    scores, and the backward recomputes one chunk's at a time."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    W = min(window, S)
    assert S % W == 0, (S, window)
    nc = S // W
    dev = q.device
    qg = _scale(q.reshape(B, nc, W, Hkv, G, hd))
    kc = k.reshape(B, nc, W, Hkv, hd)
    vc = v.reshape(B, nc, W, Hkv, hd)
    pad = torch.zeros_like(kc[:, :1])
    kpad = torch.cat([pad, kc], dim=1)                                # (B,nc+1,W,..)
    vpad = torch.cat([pad, vc], dim=1)
    qi = torch.arange(W, device=dev)[:, None] + W
    kj = torch.arange(2 * W, device=dev)[None, :]
    ok = (qi >= kj) & (qi - kj < W)
    ok0 = ok & (kj >= W)                                              # no prev chunk
    grad = torch.is_grad_enabled()
    outs = []
    for i in range(nc):
        args = (qg[:, i], kpad[:, i:i + 2].reshape(B, 2 * W, Hkv, hd),
                vpad[:, i:i + 2].reshape(B, 2 * W, Hkv, hd), ok0 if i == 0 else ok)
        outs.append(checkpoint(_local_chunk, *args, use_reentrant=False) if grad
                    else _local_chunk(*args))
    return torch.stack(outs, dim=1).reshape(B, S, Hq, hd)


# ---------------------------------------------------------------------------
# Zebra kv_cache site: block-compress K/V at the cache write
# ---------------------------------------------------------------------------

def zebra_kv_site(k: torch.Tensor, v: torch.Tensor, zc, split: bool = False):
    """The engine's ``kv_cache`` site over freshly computed K/V ``(B, S,
    Hkv, hd)``: heads fold onto the channel axis, so the (block_seq,
    block_ch) tiles are those of the cache layout and of the prefill ->
    decode handoff. ``split``: the heads are this rank's over the
    tensor-parallel axis. Returns (k', v', [SiteAux_k, SiteAux_v])."""
    from ...core.engine import zebra_site
    B, S = k.shape[0], k.shape[1]
    out, auxes = [], []
    for t in (k, v):
        tz, aux = zebra_site(t.reshape(B, S, -1), zc, site="kv_cache", layout="tokens",
                             split=split)
        out.append(tz.reshape(t.shape))
        auxes.append(aux)
    return out[0], out[1], auxes


def gather_kv_shards(k: torch.Tensor, v: torch.Tensor, zc):
    """Gather sequence-sharded K/V (B, S_local, Hkv, hd) into the full (B,
    n·S_local, Hkv, hd) pair over the active comm axis: in Zebra stream
    form when the ``kv_cache`` site's backend declares the ``comms``
    capability, else a dense all-gather with its reason logged and on the
    label. Heads fold onto the channel axis as in :func:`zebra_kv_site`,
    so the wire blocks are the (block_seq, block_ch) tiles the cache
    moves. Returns (k', v', [SiteAux_k, SiteAux_v]).

    No comm context: ``(k, v, [])``, the single-process semantics."""
    from ...core.engine import zebra_site
    from ...distributed import collectives as coll
    from ...distributed.ctx import comm_axis
    info = comm_axis()
    if info is None:
        return k, v, []
    n = info.size
    B, S, Hkv, hd = k.shape
    D = Hkv * hd
    bs = zc.block_seq if S % zc.block_seq == 0 else 1
    bc = zc.block_ch if D % zc.block_ch == 0 else D
    backend = zc.backend_for("kv_cache")
    comms, reason = coll.resolve_comms(backend, rows=B * S, cols=D, bs=bs, bc=bc)
    out, auxes = [], []
    for t in (k, v):
        tz, sa = zebra_site(t.reshape(B, S, D), zc, site="kv_cache", layout="tokens")
        if comms == "compressed":
            g, link = coll.zebra_all_gather(tz.reshape(B * S, D), info, bs=bs, bc=bc,
                                            validation=zc.validation, site="kv_cache")
            sa = coll.attach_link(sa, link)
        else:
            coll.log_comm_degrade("kv_cache", backend, reason)
            g = coll.gather_dense(tz, info)
            sa = coll.attach_link(sa, coll.dense_link(tz.numel() * tz.element_size(), n,
                                                      device=tz.device), reason=reason)
        out.append(g.reshape(n, B, S, D).transpose(0, 1).reshape(B, n * S, Hkv, hd))
        auxes.append(sa)
    return out[0], out[1], auxes


# ---------------------------------------------------------------------------
# Decode (single query token vs cache)
# ---------------------------------------------------------------------------

def attend_decode(q, k_cache, v_cache, pos, *, window: int = 0):
    """q (B,1,Hq,hd); caches (B,T,Hkv,hd); ``pos``: the position of the
    query, an ``int`` (the whole batch at one position) or a (B,) tensor
    (per-lane positions: the slotted continuous-batching decode, where
    every lane is another request). With ``window`` the cache is a ring of
    size T."""
    B, _, Hq, hd = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = _scale(q.reshape(B, Hkv, G, hd))
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    idx = torch.arange(T, device=q.device)
    if isinstance(pos, torch.Tensor):
        lim = torch.clamp(pos + 1, max=T) if window else pos + 1       # (B,)
        valid = (idx[None, :] < lim[:, None])[:, None, None, :]      # (B,1,1,T)
    else:
        valid = idx < min(pos + 1, T) if window else idx <= pos
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, hd)
