"""The LM (``repro.models.lm.model``): embedding, pattern runs of layers,
the vocabulary head: tied to the embedding, or with ``tie_embeddings``
off an ``lm_head`` of shape (d, vocab) applied as ``x @ lm_head``.

``cfg.layer_pattern`` is a superlayer (gemma-3: 5 local + 1 global);
``layer_runs`` groups the layers into runs of repeated superlayers, as the
reference does; with gradients on, ``cfg.remat`` checkpoints each repeat
(``remat.run_unit``). The reference stacks a run's parameters on a leading axis
and scans over it; the port keeps one module per layer (``run{ri}[c]
["sub{j}"]``) and loops, and ``convert.from_jax_params`` unstacks. The
caches keep the reference's grouping: run -> ``sub{j}`` -> the layer's
leaves (k/v; h/conv for "rglru"; H/conv_x/conv_b/conv_c for "ssm"),
stacked over the run's count when it is above one, so a cache tree has
the same leaves and dtypes as the reference's (the codec's index bytes
are counted per leaf). Decode updates K/V in place; a recurrent layer's
new state is written back into its slice of the stack.

Encoder-decoder (whisper, ``cfg.encoder_layers`` > 0): ``enc_feats`` are
the stub frontend's precomputed frame embeddings (B, enc_seq, d_model);
the encoder is a list of non-causal "global" layers (``encoder.{i}``, the
reference's stack unstacked) and ``enc_norm``, and every decoder layer
carries cross-attention to its output. With gradients on, ``cfg.remat``
checkpoints each encoder layer as one unit (the reference remats its
scan body, one layer). The serving state is ``(caches, enc_out)``; decode
passes ``enc_out`` on to every layer.

API (``forward``, ``loss``, ``prefill``, ``decode_step``, ``init_cache``)
mirrors the reference's pure functions of params, on an ``nn.Module`` that
holds them. Parameters are drawn from an explicit ``torch.Generator`` on
``device``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.engine import LayerAux, aux_unread
from ...distributed.ctx import copy_model, gather_model, hint_tokens, tensor_parallel
from ..layers import Norm
from .attention import rope_frequencies
from .blocks import (Layer, apply_layer, apply_layer_decode, apply_layer_prefill,
                     init_layer_cache)
from .config import LMConfig
from .remat import in_context, run_unit


def layer_runs(cfg: LMConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(superlayer pattern, repeat count)] covering all n_layers."""
    P = len(cfg.layer_pattern)
    runs = []
    g, r = divmod(cfg.n_layers, P)
    if g:
        runs.append((tuple(cfg.layer_pattern), g))
    if r:
        runs.append((tuple(cfg.layer_pattern[:r]), 1))
    return runs


class LM(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.runs = layer_runs(cfg)
        self.pdt = getattr(torch, cfg.param_dtype)
        self.cdt = getattr(torch, cfg.compute_dtype)
        device = torch.device(device) if device is not None else (
            generator.device if generator is not None else torch.device("cpu"))
        d = cfg.d_model
        emb = torch.randn(cfg.vocab, d, generator=generator, device=device)
        self.embed = nn.Parameter(emb.to(self.pdt) * d ** -0.5)
        del emb
        if not cfg.tie_embeddings:
            head = torch.randn(d, cfg.vocab, generator=generator, device=device)
            self.lm_head = nn.Parameter(head.to(self.pdt) * d ** -0.5)
            del head
        self.final_norm = Norm(d, cfg.norm, device=device)
        cross = cfg.encoder_layers > 0
        for ri, (pattern, count) in enumerate(self.runs):
            setattr(self, f"run{ri}", nn.ModuleList(
                nn.ModuleDict({f"sub{j}": Layer(t, cfg, cross=cross, generator=generator,
                                                dtype=self.pdt, device=device)
                               for j, t in enumerate(pattern)})
                for _ in range(count)))
        if cross:
            self.encoder = nn.ModuleList(
                Layer("global", cfg, generator=generator, dtype=self.pdt, device=device)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(d, cfg.norm, device=device)

    # ------------------------------------------------------------------
    def _layers(self):
        """(run index, repeat, sub index, layer type, layer) in order."""
        for ri, (pattern, count) in enumerate(self.runs):
            run = getattr(self, f"run{ri}")
            for c in range(count):
                for j, t in enumerate(pattern):
                    yield ri, c, j, t, run[c][f"sub{j}"]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not indexing: the CPU backward of an index sums the
        # rows of repeated tokens with atomic adds across threads, in no
        # fixed order; the embedding's backward sums each row in token order
        rows = self.embed.shape[0]
        if rows == self.cfg.vocab:
            x = F.embedding(tokens, self.embed).to(self.cdt)
        else:
            # the vocabulary's rows over the model axis: each rank looks up
            # the tokens in its range, zero elsewhere, and the sum over the
            # ranks is exact (one rank holds each row); the reference pins
            # the embedded tokens batch-sharded here
            local = tokens - tensor_parallel().model.index * rows
            inside = ((local >= 0) & (local < rows))[..., None]
            x = F.embedding(local.clamp(0, rows - 1), self.embed).to(self.cdt)
            x = hint_tokens(torch.where(inside, x, torch.zeros_like(x)), local="partial")
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.cdt, device=x.device)

    def _rope(self, positions: torch.Tensor):
        return rope_frequencies(self.cfg.head_dim, self.cfg.rope_theta, positions)

    def _project_vocab(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.t() if self.cfg.tie_embeddings else self.lm_head
        if w.shape[-1] == self.cfg.vocab:
            return x @ w.to(self.cdt)
        # this rank's vocabulary columns (the reference pins the logits
        # vocab-sharded), gathered in rank order into the whole logits; the
        # replicated x enters the column-parallel product through copy_model
        logits = copy_model(x) @ w.to(self.cdt)
        return gather_model(hint_tokens(logits, "model", local=-1), -1)

    def _unit(self, layers: nn.ModuleDict, pattern: tuple[str, ...], mode: str, rope,
              enc_out, x: torch.Tensor, aux: LayerAux):
        """One repeat of a run's pattern (the reference's ``super_fwd``):
        the unit ``cfg.remat`` checkpoints."""
        for j, t in enumerate(pattern):
            x, a = apply_layer(layers[f"sub{j}"], x, t, self.cfg, mode, rope, enc_out)
            aux = aux + a
        return x, aux

    def _enc_unit(self, layer: Layer, mode: str, rope, x: torch.Tensor, aux: LayerAux):
        """One non-causal encoder layer (the reference's scan body): the
        encoder's remat unit."""
        x, a = apply_layer(layer, x, "global", self.cfg, mode, rope, causal=False)
        return x, aux + a

    def _encode(self, enc_feats: torch.Tensor, mode: str):
        """enc_feats (B, T, d) -> (enc_norm'd encoder output, LayerAux of its
        sites)."""
        x = enc_feats.to(self.cdt)
        rope = self._rope(torch.arange(x.shape[1], device=x.device))
        aux = LayerAux.zero(x.device)
        for layer in self.encoder:
            x, aux = run_unit(functools.partial(self._enc_unit, layer, mode, rope),
                              self.cfg.remat, x, aux)
        return self.enc_norm(x), aux

    def _maybe_encode(self, enc_feats, mode: str):
        """(encoder output or None, its LayerAux): an encoder-decoder given
        frames encodes them; otherwise no encoder runs."""
        if self.cfg.encoder_layers and enc_feats is not None:
            return self._encode(enc_feats, mode)
        return None, LayerAux.zero(self.embed.device)

    def _backbone(self, tokens: torch.Tensor, mode: str, enc_out=None):
        """tokens (B, S) -> (final-normed x (B, S, d), LayerAux)."""
        x = self._embed(tokens)
        rope = self._rope(torch.arange(x.shape[1], device=x.device))
        aux = LayerAux.zero(x.device)
        for ri, (pattern, count) in enumerate(self.runs):
            run = getattr(self, f"run{ri}")
            for c in range(count):
                x, aux = run_unit(functools.partial(self._unit, run[c], pattern, mode, rope,
                                                    enc_out),
                                  self.cfg.remat, x, aux)
        return self.final_norm(x), aux

    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, mode: str = "train", enc_feats=None):
        """tokens (B, S) -> (logits (B, S, V), LayerAux); an encoder-decoder
        takes its frames ``enc_feats`` (B, enc_seq, d), whose encoder's
        LayerAux adds to the decoder's."""
        enc_out, enc_aux = self._maybe_encode(enc_feats, mode)
        x, aux = self._backbone(tokens, mode, enc_out)
        return self._project_vocab(x), aux + enc_aux

    def _nll_sum(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Σ -log_softmax(x @ head)[label] over one chunk, float32 logits."""
        lp = F.log_softmax(self._project_vocab(x).float(), dim=-1)
        return -lp.gather(-1, labels[..., None]).sum()

    def loss(self, tokens: torch.Tensor, mode: str = "train", enc_feats=None):
        """tokens (B, S+1): next-token cross-entropy of ``tokens[:, 1:]``
        from ``tokens[:, :-1]`` (an encoder-decoder's frames ``enc_feats``
        encoded first). Returns (total, metrics).

        With ``cfg.ce_chunk`` dividing S (and below it), the sequence is cut
        into chunks whose NLL sums add in chunk order and divide by B·S;
        each chunk runs under ``torch.utils.checkpoint`` (the reference's
        ``jax.checkpoint``), so one chunk's (B, chunk, V) float32 logits
        are alive at a time, in the forward and in the backward. Otherwise
        the CE is the mean over all tokens (another order of summation).
        ``total`` adds ``zebra_reg`` only with threshold nets: at a constant
        threshold it is the realised zero-block count, an observable; an MoE
        adds ``router_aux_coef · router_aux`` (summed over its layers).
        Metrics: ``ce``, ``zebra_reg``, ``zero_frac`` (block-weighted over
        the sites), ``router_aux`` and ``measured_bytes`` (the stream sites'
        bytes, one exact int64)."""
        cfg = self.cfg
        inp, lbl = tokens[:, :-1], tokens[:, 1:]
        enc_out, enc_aux = self._maybe_encode(enc_feats, mode)
        x, aux = self._backbone(inp, mode, enc_out)
        aux = aux + enc_aux
        B, S, _ = x.shape
        C = cfg.ce_chunk
        if C and S % C == 0 and S > C:
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(S // C):
                tot = tot + checkpoint(in_context(self._nll_sum), x[:, i * C:(i + 1) * C],
                                       lbl[:, i * C:(i + 1) * C], use_reentrant=False)
            ce = tot / (B * S)
        else:
            lp = F.log_softmax(self._project_vocab(x).float(), dim=-1)
            ce = -lp.gather(-1, lbl[..., None]).mean()
        total = ce + aux.reg if cfg.zebra_tnet else ce
        if cfg.is_moe:
            total = total + cfg.router_aux_coef * aux.router_aux
        metrics = {"ce": ce, "zebra_reg": aux.reg, "zero_frac": aux.zero_frac,
                   "router_aux": aux.router_aux, "measured_bytes": aux.measured_bytes}
        return total, metrics

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device=None) -> list[dict]:
        """Empty caches in the prefill's tree: K/V and conv buffers in the
        compute dtype, the recurrent states float32; on the model's device
        unless ``device`` says otherwise (``"meta"``: the shapes alone). A
        model cut for a mesh (``model.mesh``) holds this rank's K/V heads,
        as its prefill makes them (``sharding.local_kv_heads``)."""
        device = self.embed.device if device is None else torch.device(device)
        cfg = self.cfg
        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            from ...distributed.sharding import local_kv_heads
            cfg = cfg.replace(n_kv_heads=local_kv_heads(cfg, mesh))
        caches = []
        for pattern, count in self.runs:
            sub = {f"sub{j}": init_layer_cache(t, cfg, batch, cache_len, self.cdt, device)
                   for j, t in enumerate(pattern)}
            if count > 1:
                sub = {s: {n: c[None].expand(count, *c.shape).clone() for n, c in kv.items()}
                       for s, kv in sub.items()}
            caches.append(sub)
        return caches

    def prefill(self, tokens: torch.Tensor, cache_len: int, enc_feats=None):
        """tokens (B, S) -> (last logits (B, V), (caches, enc_out), LayerAux
        of the decoder's sites). An encoder-decoder encodes ``enc_feats``
        first (its sites' aux is not reported, as in the reference);
        ``enc_out`` is None otherwise."""
        enc_out, _ = self._maybe_encode(enc_feats, "infer")
        x = self._embed(tokens)
        rope = self._rope(torch.arange(x.shape[1], device=x.device))
        aux = LayerAux.zero(x.device)
        per_layer: dict[tuple[int, int], dict] = {}
        for ri, c, j, t, layer in self._layers():
            x, cache, a = apply_layer_prefill(layer, x, t, self.cfg, rope, cache_len,
                                              enc_out)
            per_layer[(ri, c, j)] = cache
            aux = aux + a
        caches = []
        for ri, (pattern, count) in enumerate(self.runs):
            run = {}
            for j in range(len(pattern)):
                cs = [per_layer.pop((ri, c, j)) for c in range(count)]
                run[f"sub{j}"] = (cs[0] if count == 1 else
                                  {n: torch.stack([cc[n] for cc in cs]) for n in cs[0]})
            caches.append(run)
        logits = self._project_vocab(self.final_norm(x[:, -1:]))
        return logits[:, 0], (caches, enc_out), aux

    def decode_step(self, token: torch.Tensor, state, pos):
        """token (B, 1) int; ``pos`` the position of that token: an ``int``
        (one for the whole batch) or a (B,) int tensor of per-lane positions
        (the slotted continuous-batching decode, each lane an independent
        request). Returns (logits (B, V), state), the caches updated in
        place: K/V where they lie, a recurrent layer's new state copied into
        its slice of a stacked run or put in its run's dict."""
        caches, enc_out = state
        x = self._embed(token)
        if isinstance(pos, torch.Tensor):
            rope1 = self._rope(pos.to(x.device)[:, None])          # (B, 1, hd/2)
        else:
            rope1 = self._rope(torch.tensor([pos], device=x.device))
        for ri, c, j, t, layer in self._layers():
            sub = caches[ri][f"sub{j}"]
            stacked = self.runs[ri][1] > 1
            lc = {n: sub[n][c] for n in sub} if stacked else sub
            with aux_unread():          # a decode step reports no site
                x, new = apply_layer_decode(layer, x, lc, t, self.cfg, pos, rope1, enc_out)
            if not stacked:
                caches[ri][f"sub{j}"] = new
                continue
            for n, leaf in new.items():
                if leaf is not lc[n]:
                    sub[n][c].copy_(leaf)
        logits = self._project_vocab(self.final_norm(x))[:, 0]
        return logits, (caches, enc_out)
