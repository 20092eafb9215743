"""Tensor-parallel one-shot serving of the remaining layer kinds (the MoE's
expert parallelism, Mamba-2's SSD, Griffin's RG-LRU beside replicated
attention, whisper's encoder-decoder) against the reference's GSPMD run,
on the CPU.

One module fixture runs both sides at once: the reference's
``make_prefill``/``make_generate`` at ``make_host_mesh(model=4)`` on 8
forced host devices (one JAX subprocess a configuration,
``tests/_torch_tp_layers_cases.py::reference_main``), and the port as one
8-rank ``gloo`` world on a (data 2, model 4) mesh that serves every
configuration in turn (``port_rank``), each rank holding the shards
``distributed.sharding.shard_model_`` cuts from the reference's
parameters. The configurations, in float32: the reduced granite (its
pairs dropped in a second case), llama4, mamba2, recurrentgemma (with 6
query heads in a second case) and whisper (60 frames), each on the
backend it is served on.

Exact: every prefill site's keep flags (the whole map's, a data rank's
rows concatenated), zero fraction and bytes; the aux's bytes, zero
fraction and block count; the handoff's per-leaf records, total and
reconcile; the greedy tokens; every model rank's logits against its data
rank's first rank's. allclose at 1e-4 (the repo's float32 LM tolerance:
the row-parallel sums add in another order): logits, and each rank's
cache part against its rows and heads or channels of the reference's
cache. The fixture takes ~60-90 s, the JAX compiles most of it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_layers_cases as C
from _torch_parity import bits
from repro_torch import configs
from repro_torch.launch.serve import CACHE_AXES

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(C.MODEL * C.DATA)
TAGS = list(C.CONFIGS)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({config tag: reference outputs}, the port's 8 rank outputs)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("tp_serve_layers")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    refs = {tag: subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp_layers_cases as C; "
         "C.reference_main(sys.argv[1], sys.argv[2])", str(d), tag],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in TAGS}
    try:
        spawn(C.port_rank, len(RANKS), (str(d),), device="cpu")
    finally:
        errs = {tag: p.communicate(timeout=600)[1] for tag, p in refs.items()}
    for tag, p in refs.items():
        assert p.returncode == 0, errs[tag][-3000:]
    ref = {tag: dict(np.load(d / f"ref_{tag}.npz", allow_pickle=True),
                     params=d / f"params_{tag}.npz") for tag in TAGS}
    return ref, [torch.load(d / f"rank{i}.pt", weights_only=False) for i in RANKS]


def rows(p):
    n = C.B // C.DATA
    return slice(p["data_index"] * n, (p["data_index"] + 1) * n)


def test_ranks_lay_out_as_the_reference_mesh(runs):
    _, port = runs
    for rank, p in enumerate(port):
        assert (p["data_index"], p["model_index"]) == divmod(rank, C.MODEL)


@pytest.mark.parametrize("tag", TAGS)
def test_aux_observables_equal_the_reference(runs, tag):
    ref, port = runs
    r = ref[tag]
    for p in port:
        got = p[tag]
        assert np.array_equal(bits(got["zero_frac"]), bits(r["zero_frac"]))
        assert got["n_blocks"] == float(r["n_blocks"]) > 0
        assert got["measured"] == int(r["measured"])
        assert 0.0 < float(got["zero_frac"]) < 1.0


def _site_key(site, keep, zf, mb):
    return site, bits(np.float32(zf)).item(), mb, keep.shape, keep.tobytes()


@pytest.mark.parametrize("tag", TAGS)
def test_every_site_equals_the_reference(runs, tag):
    """Every prefill site (whisper's encoder's too): its kind, the whole
    map's keep flags (the expert-split MoE map is the same on every data
    rank; any other holds this data rank's rows, concatenated here in data
    order), its zero fraction and bytes, bit for bit, as a multiset of
    sites (the reference's callbacks on 8 devices come in no fixed order);
    some block masked and some live."""
    ref, port = runs
    want = sorted(_site_key(*s) for s in ref[tag]["sites"])
    assert want
    for p in port:
        got = p[tag]["sites"]
        other = port[(1 - p["data_index"]) * C.MODEL + p["model_index"]][tag]["sites"]
        assert len(got) == len(other) == len(want)
        keys = []
        for s, o in zip(got, other):
            k = s["keep"].numpy()
            if s["split"] != "rows":        # the data ranks' rows, in order
                pair = [k, o["keep"].numpy()]
                k = np.concatenate(pair if p["data_index"] == 0 else pair[::-1])
            keys.append(_site_key(s["site"], k, s["zero_frac"], s["measured_bytes"]))
        assert sorted(keys) == want
    flags = np.concatenate([s[1].ravel() for s in ref[tag]["sites"]])
    assert 0 < flags.sum() < flags.size


@pytest.mark.parametrize("tag", TAGS)
def test_handoff_bytes_and_reconcile_equal_the_reference(runs, tag):
    ref, port = runs
    want = [tuple(x) for x in ref[tag]["records"]]
    deltas = [tuple(x) for x in ref[tag]["deltas"]]
    assert want and any(x[5] for x in want)               # some leaf was compressed
    for p in port:
        assert [tuple(x) for x in p[tag]["records"]] == want
        assert [tuple(x) for x in p[tag]["deltas"]] == deltas


@pytest.mark.parametrize("tag", TAGS)
def test_logits_tokens_and_caches_match_the_reference(runs, tag):
    """The greedy tokens equal; logits allclose; each cache leaf is this
    rank's rows and, where the reference's cache specs split it over the
    model axis, its heads or channels of the reference's leaf."""
    ref, port = runs
    r = ref[tag]
    cfg = C.config(tag, configs)
    for p in port:
        got = p[tag]
        np.testing.assert_allclose(got["logits"].numpy(), r["logits"][rows(p)], **TOL)
        assert np.array_equal(got["tokens"].numpy(), r["tokens"][rows(p)])
        assert len(got["cache"]) == int(r["n_cache"])
        for i, (name, leaf) in enumerate(got["cache"]):
            want = r[f"cache{i}"]
            bd, sd, whole = CACHE_AXES[name]
            want = np.take(want, range(rows(p).start, rows(p).stop), axis=bd)
            if sd is not None and leaf.shape[sd] != getattr(cfg, whole):
                n = leaf.shape[sd]
                want = np.take(want, range(p["model_index"] * n, (p["model_index"] + 1) * n),
                               axis=sd)
            np.testing.assert_allclose(leaf.numpy(), want, **TOL, err_msg=f"{name} leaf {i}")


@pytest.mark.parametrize("tag", TAGS)
def test_model_ranks_agree_bit_for_bit(runs, tag):
    _, port = runs
    for p in port:
        first = port[p["data_index"] * C.MODEL][tag]
        assert np.array_equal(bits(p[tag]["logits"]), bits(first["logits"]))
        assert torch.equal(p[tag]["tokens"], first["tokens"])


# the rule and the axis each site kind ran by, and the shape of a parameter
# on a rank beside its whole shape (None: whole on every rank)
LAYOUTS = {
    "granite": ({"ffn_hidden": ("blocks", "rows"), "kv_cache": ("whole", "cols")},
                {"run0.0.sub0.moe.w_up": 0, "run0.0.sub0.attn.wq": 1, "embed": 0}),
    "llama4": ({"ffn_hidden": ("blocks", "rows"), "kv_cache": ("whole", "cols")},
               {"run0.0.sub0.moe.w_down": 0, "run0.0.sub0.moe.router": None}),
    "mamba2": ({"layer_out": ("whole", "cols")},
               {"run0.0.sub0.ssm.x_proj": 1, "run0.0.sub0.ssm.A_log": 0,
                "run0.0.sub0.ssm.out_norm.scale": 0, "run0.0.sub0.ssm.out_proj": 0,
                "run0.0.sub0.ssm.b_proj": None, "run0.0.sub0.ssm.conv_c": None}),
    "rgemma": ({"ffn_hidden": ("gather", "cols"), "kv_cache": ("whole", "cols")},
               {"run0.0.sub0.rec.w_a": 1, "run0.0.sub0.rec.w_out": 0,
                "run0.0.sub2.attn.wq": 1, "run0.0.sub2.attn.wk": None}),
    "rgemma_6h": ({"ffn_hidden": ("gather", "cols"), "kv_cache": ("whole", "cols")},
                  {"run0.0.sub0.rec.conv_w": 1, "run0.0.sub2.attn.wq": None,
                   "run0.0.sub2.attn.wo": None}),
    "whisper": ({"ffn_hidden": ("gather", "cols"), "kv_cache": ("gather", "cols")},
                {"encoder.0.attn.wq": 1, "run0.0.sub0.cross.wk": 1,
                 "run0.0.sub0.cross.wo": 0, "run0.0.sub0.ffn.w_down": None}),
}
LAYOUTS["granite_drop"] = LAYOUTS["granite"]


@pytest.mark.parametrize("tag", TAGS)
def test_sites_and_parameters_follow_the_specs(runs, tag):
    """The MoE map runs split by rows on block edges; mamba2's layer_out
    is on the replicated residual; the reduced d_ff shards cut a block and
    gather; K/V replicate where their heads do not split; the named
    parameters are split on the dimension the reference's specs name, or
    whole (recurrentgemma's 6 heads and its single KV head)."""
    from repro_torch.models.lm import LM
    _, port = runs
    rules, params = LAYOUTS[tag]
    whole = {n: tuple(t.shape) for n, t in LM(C.config(tag, configs),
                                              device="meta").named_parameters()}
    for p in port:
        got = {(s["site"], s["rule"], s["split"]) for s in p[tag]["sites"]}
        assert got == {(k, *v) for k, v in rules.items()}
        for name, dim in params.items():
            want = list(whole[name])
            if dim is not None:
                want[dim] //= C.MODEL
            assert p[tag]["params"][name] == tuple(want), name


@pytest.mark.parametrize("tag,dropped", [("granite", None), ("granite_drop", True)])
def test_moe_routes_the_global_batch(runs, tag, dropped):
    """Every dispatch routes the global batch's tokens with the capacity
    they give; with capacity_factor 0.5 the prefill drops pairs, and a data
    rank's own rows would give another capacity."""
    _, port = runs
    cfg = C.config(tag, configs)
    for p in port:
        routes = p[tag]["routes"]
        assert routes and routes[0][0] == C.B * C.S
        for T, cap, _ in routes:
            assert cap == max(1, round(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
        if dropped:
            T = C.B * C.S // C.DATA
            assert routes[0][2] > 0
            assert routes[0][1] != round(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts)


def test_validated_handoff_serves_the_same(runs):
    """``--validate checksum`` on mamba2's stream sites and handoff: the
    same tokens and bytes, nothing recovered."""
    _, port = runs
    for p in port:
        tokens, recovered, handoff, measured = p["mamba2"]["checked"]
        assert torch.equal(tokens, p["mamba2"]["tokens"]) and recovered == 0
        assert handoff == sum(x[1] + x[2] for x in p["mamba2"]["records"])
        assert measured == p["mamba2"]["measured"]


def test_a_per_shard_out_norm_would_move_mamba2_logits(runs, monkeypatch):
    """The mamba2 case tells a norm over the whole d_inner from one per
    model shard: served in one process with each quarter of d_inner
    normed by its own RMS, its logits leave TOL of the reference's."""
    from repro_torch.launch import serve
    from repro_torch.models.layers import rmsnorm_apply
    from repro_torch.models.lm import LM, ssm
    ref, port = runs
    cfg = C.config("mamba2", configs)
    model = LM(cfg).requires_grad_(False)
    model.load_state_dict({n: torch.from_numpy(a)
                           for n, a in np.load(ref["mamba2"]["params"]).items()})

    def per_shard(p, y, z, cfg):
        y = y * ssm.silu(z)
        parts = [rmsnorm_apply(s, c) for s, c in zip(p.out_norm.scale.chunk(C.MODEL),
                                                      y.chunk(C.MODEL, dim=-1))]
        return torch.cat(parts, dim=-1) @ p.out_proj.to(y.dtype)
    toks = torch.from_numpy(C.prompts()).long()
    whole = serve.serve_one_shot(model, toks, 1, log=lambda *_: None)["logits"]
    np.testing.assert_allclose(whole.numpy(), ref["mamba2"]["logits"], **TOL)
    monkeypatch.setattr(ssm, "_gated_out", per_shard)
    cut = serve.serve_one_shot(model, toks, 1, log=lambda *_: None)["logits"]
    assert float((cut - whole).abs().max()) > 100 * TOL["atol"]

