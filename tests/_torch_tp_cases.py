"""The configurations of ``tests/test_torch_tp_serve.py`` and the two
programs that serve them: :func:`reference_main` (the reference's
``make_prefill``/``make_generate`` on 8 forced host devices, one JAX
process a configuration) and :func:`port_rank` (one rank of the port's 8-rank ``gloo``
world on the CPU, a (data 2, model 4) mesh, rank = data index * 4 + model
index).

The reference draws its parameters once a configuration and writes them
(as the port's dotted names, ``models.lm.convert.port_params``) before it
compiles anything, every bias drawn anew (:func:`draw_biases`: the
reference's init sets them to zero, which would hide a bias added on every
rank or cut wrongly); the port's ranks wait for that file, build the model
whole, load the reference's values and cut their shards
(``distributed.sharding.shard_model_``). Prompts come from the numpy
``lm_batch``. This module imports numpy only at the top: the port's ranks
import it without JAX.
"""
from __future__ import annotations

import os
import time

import numpy as np

B, S, GEN = 4, 64, 4                 # global batch: 2 rows a data rank
MODEL, DATA = 4, 2
T_OBJ = 2.45
COMMON = dict(param_dtype="float32", compute_dtype="float32",
              zebra_sites=("ffn_hidden", "kv_cache"), zebra_t_obj=T_OBJ)
# (a) the reduced gemma3-4b as it is: d_ff/4 = 64 and the K/V width 64 cut
# the 8x128 blocks, and its 2 KV heads replicate over 4 model ranks;
# (b) the reduced starcoder2-15b widened so every shard falls on a block
# edge: head_dim 128, 4 KV heads (one a rank), d_ff 512 (128 a rank); its
# GELU biases and QKV bias cross the row-parallel sums
CONFIGS = {"gemma3": ("gemma3-4b", {}),
           "starcoder2": ("starcoder2-15b", dict(head_dim=128, n_kv_heads=4, d_ff=512))}
BACKENDS = ("fused", "stream")
SEED = 0
# the biases (zero at init, as in the reference) are drawn anew so that both
# sides serve nonzero ones: QKV and GELU biases through the shards and the
# row-parallel sums, ``b_down`` once after them
BIASES = ("bq", "bk", "bv", "b_up", "b_down", "bias")
BIAS_STD = 0.5


def config(tag: str, backend: str, pkg):
    arch, widen = CONFIGS[tag]
    return pkg.reduced(arch).replace(**COMMON, **widen, zebra_backend=backend)


def prompts() -> np.ndarray:
    from repro_torch.data import LMDatasetConfig, lm_batch
    return lm_batch(LMDatasetConfig(vocab=512), B, S, 0)[:, :S]


def _records(meter) -> list:
    return [(r.site, r.payload_bytes, r.index_bytes, r.dense_bytes, r.n_live, r.n_blocks)
            for r in meter.records]


def draw_biases(params, seed: int = SEED + 1):
    """``params`` (a JAX tree) with every bias leaf (named in BIASES)
    replaced by a numpy draw N(0, BIAS_STD) from ``seed``, in tree order."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if getattr(path[-1], "key", None) not in BIASES:
            return leaf
        return jnp.asarray(rng.normal(0.0, BIAS_STD, leaf.shape), dtype=leaf.dtype)
    return jax.tree_util.tree_map_with_path(one, params)


def reference_main(out_dir: str, tag: str) -> None:
    """Configuration ``tag`` on every backend at ``make_host_mesh(model=4)`` (data
    2) and at ``model=1`` (data 8): logits, the aux's observables, the
    handoff's records and reconcile and, at model 4, the greedy tokens and
    the padded caches."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.compress import BandwidthMeter, compress_tree
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import model_prefill_pad
    from repro.launch.steps import make_generate, make_prefill
    from repro.models.lm import LM
    from repro_torch.models.lm import LM as TLM
    from repro_torch import configs as tconfigs
    from repro_torch.models.lm.convert import port_params

    toks = jnp.asarray(prompts())
    out = {}
    for tag in (tag,):
        cfg = config(tag, BACKENDS[0], configs)
        params = draw_biases(jax.jit(LM(cfg).init)(jax.random.PRNGKey(SEED)))
        flat = port_params(TLM(config(tag, BACKENDS[0], tconfigs)),
                           jax.tree_util.tree_map(np.asarray, params))
        np.savez(f"{out_dir}/params_{tag}.tmp.npz", **flat)
        os.replace(f"{out_dir}/params_{tag}.tmp.npz", f"{out_dir}/params_{tag}.npz")
        for backend in BACKENDS:
            model = LM(config(tag, backend, configs))
            for m in (MODEL, 1):
                mesh = make_host_mesh(model=m)
                pshard = jax.tree_util.tree_map(
                    lambda s: jax.sharding.NamedSharding(mesh, s),
                    shd.param_specs(params, model.cfg, mesh),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
                p = jax.device_put(params, pshard)
                logits, (caches, enc), aux = model_prefill_pad(
                    jax.jit(make_prefill(model, mesh)), p, toks, S + GEN)
                meter = BandwidthMeter()
                cc = compress_tree(caches, bs=cfg.zebra_block_seq, bc=cfg.zebra_block_ch,
                                   meter=meter, site="kv")
                k = f"{tag}_{backend}_m{m}"
                out[f"{k}_logits"] = np.asarray(logits)
                if m == MODEL:                  # model 1 holds the prefill's observables
                    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
                    rest, _ = jax.jit(make_generate(model, mesh, GEN - 1))(
                        p, tok, (cc, enc), jnp.int32(S))
                    out[f"{k}_tokens"] = np.concatenate([np.asarray(tok), np.asarray(rest)], 1)
                out[f"{k}_zero_frac"] = np.asarray(aux.zero_frac)
                out[f"{k}_n_blocks"] = np.asarray(aux.n_blocks)
                out[f"{k}_measured"] = np.asarray(aux.measured_bytes_exact())
                out[f"{k}_records"] = np.asarray(_records(meter), dtype=object)
                out[f"{k}_deltas"] = np.asarray(sorted(meter.reconcile()["deltas"].items()),
                                                dtype=object)
                if m == MODEL:
                    leaves = jax.tree_util.tree_leaves(caches)
                    for i, leaf in enumerate(leaves):
                        out[f"{k}_cache{i}"] = np.asarray(leaf)
                    out[f"{k}_n_cache"] = np.asarray(len(leaves))
    np.savez(f"{out_dir}/ref_{tag}.npz", **out)


def _wait(path: str, timeout: float = 600.0) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def port_rank(rank: int, out_dir: str) -> None:
    """One rank: every configuration and backend served tensor-parallel
    from the reference's parameters; the stream one again with
    ``--validate checksum``'s level. Saves ``rank<r>.pt``."""
    import torch

    from repro_torch import configs
    from repro_torch.core.engine import record_tp_sites, tp_sites_on_host
    from repro_torch.distributed.sharding import shard_model_
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.utils import map_tree

    torch.set_num_threads(1)            # 8 ranks share the host's cores
    mesh = make_host_mesh(model=MODEL, device="cpu")
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = torch.from_numpy(prompts()).long()[di * (B // DATA):(di + 1) * (B // DATA)]
    res = {"data_index": di, "model_index": mi}
    for tag in CONFIGS:
        path = f"{out_dir}/params_{tag}.npz"
        _wait(path)
        flat = dict(np.load(path))
        for backend in BACKENDS:
            cfg = config(tag, backend, configs)
            model = LM(cfg).requires_grad_(False)
            with torch.no_grad():
                for name, t in model.state_dict().items():
                    t.copy_(torch.from_numpy(flat[name]))
            shard_model_(model, mesh)
            with record_tp_sites() as sites:
                out = serve.serve_one_shot(model, rows, GEN, log=lambda *_: None)
            k = f"{tag}_{backend}"
            leaves = []
            map_tree(lambda _, leaf: leaves.append(leaf), out["dense_state"][0])
            aux = out["aux"]
            res.update({f"{k}_logits": out["logits"], f"{k}_tokens": out["tokens"],
                        f"{k}_zero_frac": aux.zero_frac, f"{k}_n_blocks": float(aux.n_blocks),
                        f"{k}_measured": aux.measured_bytes_exact(),
                        f"{k}_records": _records(out["meter"]),
                        f"{k}_deltas": sorted(out["reconcile"]["deltas"].items()),
                        f"{k}_cache": leaves, f"{k}_sites": tp_sites_on_host(sites),
                        f"{k}_heads": [leaf.shape[-2] for leaf in leaves],
                        f"{k}_w_down": tuple(model.run0[0]["sub0"].ffn.w_down.shape)})
            if backend == "stream":
                model.cfg = cfg.replace(zebra_validation="checksum")
                checked = serve.serve_one_shot(model, rows, GEN, log=lambda *_: None)
                res[f"{k}_checked"] = (checked["tokens"], checked["ingest_recovered"],
                                       checked["meter"].measured_bytes(),
                                       checked["aux"].measured_bytes_exact())
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def unported_rank(rank: int, argv: list, out_dir: str) -> None:
    """One rank of a world that runs ``launch.serve.main(argv)`` and writes
    what it raised (``NotImplementedError``'s text, or "" if nothing) to
    ``raised<r>.txt``."""
    from repro_torch.launch import serve
    try:
        serve.main(argv)
        text = ""
    except NotImplementedError as e:
        text = str(e)
    with open(f"{out_dir}/raised{rank}.txt", "w") as f:
        f.write(text)
