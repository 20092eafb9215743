"""The configurations of ``tests/test_torch_tp_serve_layers.py`` and the two
programs that serve them: :func:`reference_main` (the reference's
``make_prefill``/``make_generate`` at ``make_host_mesh(model=4)`` on 8
forced host devices, one JAX process a configuration) and
:func:`port_rank` (one rank of the port's 8-rank ``gloo`` world on the
CPU, a (data 2, model 4) mesh, rank = data index * 4 + model index, that
serves every configuration in turn).

The configurations are the reduced MoE, SSM, RG-LRU and encoder-decoder
architectures in float32, at thresholds that mask some blocks and leave
others live, and three that each fail one likely fault: granite with a
capacity factor low enough that pairs are dropped (a dispatch routed per
data rank computes another capacity and drops other pairs), recurrentgemma
with 6 query heads (they do not split over 4 model ranks: the attention
runs replicated beside the split RG-LRU), and mamba2 as drawn (a per-shard
``out_norm`` moves its logits).

The reference draws its parameters once a configuration, replaces every
bias, norm scale, the SSD's ``A_log``/``D``/``dt_bias`` and the RG-LRU's
``lam`` by numpy draws (the reference initialises them to constants), and
writes them as the port's dotted names before it compiles anything; the
port's ranks wait for that file. Its prefill records every site it runs
(``jax.debug.callback`` of the site's input: the keep flags, and the
site's zero fraction and bytes; on several devices the callbacks are
unordered, so the test compares the sites as a multiset). Prompts come from the numpy
``lm_batch``, whisper's frames from numpy. This module imports numpy only
at the top: the port's ranks import it without JAX.
"""
from __future__ import annotations

import os

import numpy as np

from _torch_tp_cases import _records, _wait, prompts

B, S, GEN = 4, 64, 4                 # global batch: 2 rows a data rank
MODEL, DATA = 4, 2
SEED = 0
COMMON = dict(param_dtype="float32", compute_dtype="float32")
# tag: (architecture, fields replaced, backend, T_obj, sites)
CONFIGS = {
    "granite": ("granite-moe-1b-a400m", {}, "stream", 0.025, ("ffn_hidden", "kv_cache")),
    "granite_drop": ("granite-moe-1b-a400m", dict(capacity_factor=0.5), "fused", 0.025,
                     ("ffn_hidden", "kv_cache")),
    "llama4": ("llama4-scout-17b-a16e", {}, "fused", 0.025, ("ffn_hidden", "kv_cache")),
    "mamba2": ("mamba2-2.7b", {}, "stream", 4.8, ("layer_out", "kv_cache")),
    "rgemma": ("recurrentgemma-2b", {}, "fused", 2.5, ("ffn_hidden", "kv_cache")),
    "rgemma_6h": ("recurrentgemma-2b", dict(n_heads=6), "stream", 2.5,
                  ("ffn_hidden", "kv_cache")),
    # 60 frames: not a multiple of block_seq, so the encoder's sites run
    # reference(degenerate-rows), as at whisper's 1500
    "whisper": ("whisper-medium", dict(enc_seq=60), "fused", 2.5, ("ffn_hidden", "kv_cache")),
}
# the leaves drawn from numpy: constants (or the reference's own draws) at init
BIASES = ("bq", "bk", "bv", "b_up", "b_down", "b_a", "b_x", "bias")


def config(tag: str, pkg):
    arch, fields, backend, t_obj, sites = CONFIGS[tag]
    return pkg.reduced(arch).replace(**COMMON, **fields, zebra_backend=backend,
                                     zebra_t_obj=t_obj, zebra_sites=sites)


def frames(cfg) -> np.ndarray | None:
    """whisper's frames (B, enc_seq, d) ~ N(0, 0.1²) from numpy; None for a
    decoder-only architecture."""
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng(7)
    return (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)


def draw_extras(params, seed: int = SEED + 1):
    """``params`` (a JAX tree) with every bias, every norm scale, the SSD's
    ``A_log``/``D``/``dt_bias`` and the RG-LRU's ``lam`` replaced by numpy
    draws from ``seed`` in tree order (the reference sets them to
    constants, or draws ``lam`` itself): a leaf cut or applied wrongly on a
    rank then shows."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        size = leaf.shape
        if name in BIASES:
            out = rng.normal(size=size) * 0.5
        elif name == "scale":
            out = 1.0 + rng.normal(size=size) * 0.1
        elif name in ("A_log", "dt_bias"):
            out = rng.normal(size=size) * 0.5 - (name == "dt_bias")
        elif name == "D":
            out = rng.normal(size=size)
        elif name == "lam":     # softplus^-1(-log(u) / 8), u ~ U(0.9, 0.999)
            out = np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, size=size)) / 8.0))
        else:
            return leaf
        return jax.numpy.asarray(out.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, params)


def keep_flags(x, cfg):
    """The keep flags of a tokens-layout site's map (..., S, D), as the
    engine blocks it: block max |x| >= T_obj over (block_seq, block_ch)
    blocks of its (rows, D) flattening (one row a block where S does not
    divide, one block across D where D does not)."""
    import jax.numpy as jnp
    S, D = x.shape[-2], x.shape[-1]
    bs = cfg.block_seq if S % cfg.block_seq == 0 else 1
    bc = cfg.block_ch if D % cfg.block_ch == 0 else D
    x2 = jnp.abs(x.reshape(-1, D))
    M = x2.shape[0]
    return (x2.reshape(M // bs, bs, D // bc, bc).max(axis=(1, 3)) >= cfg.t_obj).astype(jnp.int8)


def _recording_sites(log: list):
    """Patch the reference's ``zebra_site`` in every module that holds it
    with one that records (site, keep flags, zero fraction, bytes) through
    ``jax.debug.callback`` as the compiled program runs. Returns the undo."""
    import sys

    import jax

    from repro.core import engine
    orig = engine.zebra_site

    def site(x, cfg, *, site="", layout="tokens", **kw):
        y, aux = orig(x, cfg, site=site, layout=layout, **kw)
        if cfg.enabled and layout == "tokens":
            jax.debug.callback(lambda k, z, b: log.append((site, np.asarray(k), float(z),
                                                           int(b))),
                               keep_flags(x, cfg), aux.zero_frac, aux.measured_bytes)
        return y, aux
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("repro.") and getattr(m, "zebra_site", None) is orig]
    for m in mods:
        m.zebra_site = site

    def undo():
        for m in mods:
            m.zebra_site = orig
    return undo


def reference_main(out_dir: str, tag: str) -> None:
    """Configuration ``tag`` at ``make_host_mesh(model=4)`` (data 2): the
    logits, the aux's observables, every prefill site's record, the
    handoff's records and reconcile, the greedy tokens and the padded
    caches."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.compress import BandwidthMeter, compress_tree
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import model_prefill_pad
    from repro.launch.steps import make_generate, make_prefill
    from repro.models.lm import LM
    from repro_torch import configs as tconfigs
    from repro_torch.models.lm import LM as TLM
    from repro_torch.models.lm.convert import port_params

    cfg = config(tag, configs)
    model = LM(cfg)
    params = draw_extras(jax.jit(model.init)(jax.random.PRNGKey(SEED)))
    flat = port_params(TLM(config(tag, tconfigs), device="meta"),
                       jax.tree_util.tree_map(np.asarray, params))
    np.savez(f"{out_dir}/params_{tag}.tmp.npz", **flat)
    os.replace(f"{out_dir}/params_{tag}.tmp.npz", f"{out_dir}/params_{tag}.npz")
    mesh = make_host_mesh(model=MODEL)
    p = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: jax.sharding.NamedSharding(mesh, s), shd.param_specs(params, cfg, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    toks = jnp.asarray(prompts())
    enc = frames(cfg)
    enc = None if enc is None else jnp.asarray(enc)
    sites: list = []
    undo = _recording_sites(sites)
    try:
        logits, (caches, enc_out), aux = model_prefill_pad(
            jax.jit(make_prefill(model, mesh)), p, toks, S + GEN, enc)
        jax.block_until_ready(logits)
        jax.effects_barrier()
    finally:
        undo()
    meter = BandwidthMeter()
    cc = compress_tree(caches, bs=cfg.zebra_block_seq, bc=cfg.zebra_block_ch, meter=meter,
                       site="kv")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    rest, _ = jax.jit(make_generate(model, mesh, GEN - 1))(p, tok, (cc, enc_out),
                                                           jnp.int32(S))
    leaves = jax.tree_util.tree_leaves(caches)
    out = {"logits": np.asarray(logits),
           "tokens": np.concatenate([np.asarray(tok), np.asarray(rest)], 1),
           "zero_frac": np.asarray(aux.zero_frac), "n_blocks": np.asarray(aux.n_blocks),
           "measured": np.asarray(aux.measured_bytes_exact()),
           "records": np.asarray(_records(meter), dtype=object),
           "deltas": np.asarray(sorted(meter.reconcile()["deltas"].items()), dtype=object),
           "sites": np.asarray(sites, dtype=object), "n_cache": np.asarray(len(leaves))}
    for i, leaf in enumerate(leaves):
        out[f"cache{i}"] = np.asarray(leaf)
    np.savez(f"{out_dir}/ref_{tag}.npz", **out)


def port_rank(rank: int, out_dir: str) -> None:
    """One rank: every configuration served tensor-parallel from the
    reference's parameters, the sites recorded with their keep flags,
    every MoE dispatch's token count, capacity and dropped pairs, and the
    caches as prefill left them (decode updates a leaf handed over dense
    in place);
    mamba2 again with ``--validate checksum``'s level. Saves
    ``rank<r>.pt``."""
    import torch

    from repro_torch import configs
    from repro_torch.core.engine import record_tp_sites, tp_sites_on_host
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ffn

    routes: list = []                   # (tokens routed, capacity, pairs dropped)
    route = ffn.moe_route

    def recorded(router, xt, cfg):
        r = route(router, xt, cfg)
        routes.append((xt.shape[0], r.cap, int((r.dest == cfg.n_experts * r.cap).sum())))
        return r
    ffn.moe_route = recorded
    prefilled: list = []                # the caches as prefill left them
    transport = serve.transport_state_compressed

    def kept(state, *a, **k):
        prefilled[:] = [(str(path[-1]), leaf.clone()) for path, leaf in _leaves(state[0])]
        return transport(state, *a, **k)
    serve.transport_state_compressed = kept
    torch.set_num_threads(1)            # 8 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = slice(di * (B // DATA), (di + 1) * (B // DATA))
    toks = torch.from_numpy(prompts()).long()[rows]
    res = {"data_index": di, "model_index": mi}
    for tag in CONFIGS:
        path = f"{out_dir}/params_{tag}.npz"
        _wait(path)
        flat = dict(np.load(path))
        cfg = config(tag, configs)
        model = LM(cfg).requires_grad_(False)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(torch.from_numpy(flat[name]))
        shard_model_(model, mesh)
        enc = frames(cfg)
        enc = None if enc is None else torch.from_numpy(enc[rows])
        routes.clear()
        with record_tp_sites(bitmaps=True) as sites:
            out = serve.serve_one_shot(model, toks, GEN, log=lambda *_: None, enc_feats=enc)
        aux = out["aux"]
        res[tag] = {"logits": out["logits"], "tokens": out["tokens"],
                    "zero_frac": aux.zero_frac, "n_blocks": float(aux.n_blocks),
                    "measured": aux.measured_bytes_exact(), "records": _records(out["meter"]),
                    "deltas": sorted(out["reconcile"]["deltas"].items()),
                    "cache": list(prefilled),
                    "sites": tp_sites_on_host(sites), "routes": list(routes),
                    "params": {n: tuple(t.shape) for n, t in model.named_parameters()}}
        if tag == "mamba2":
            model.cfg = cfg.replace(zebra_validation="checksum")
            checked = serve.serve_one_shot(model, toks, GEN, log=lambda *_: None)
            res[tag]["checked"] = (checked["tokens"], checked["ingest_recovered"],
                                   checked["meter"].measured_bytes(),
                                   checked["aux"].measured_bytes_exact())
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _leaves(tree) -> list:
    """(path, leaf) of every leaf of a cache tree, in the reference's order."""
    from repro_torch.utils import map_tree
    out: list = []
    map_tree(lambda path, leaf: out.append((path, leaf)), tree)
    return out
