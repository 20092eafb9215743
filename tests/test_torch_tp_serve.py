"""Tensor-parallel one-shot serving of the port (``--model-parallel``)
against the reference's GSPMD run, on the CPU.

One module fixture runs both sides at once: the reference's
``make_prefill``/``make_generate`` on 8 forced host devices, at
``make_host_mesh(model=4)`` and at ``model=1`` (one JAX subprocess a
configuration, ``tests/_torch_tp_cases.py::reference_main``), and the
port as an 8-rank ``gloo`` world on a (data 2, model 4) mesh spawned with
``launch.mesh.spawn`` (``port_rank``), each rank holding the shards
``distributed.sharding.shard_model_`` cuts from the reference's
parameters. Two configurations in float32 compute, each on ``fused`` and
``stream``: (a) the reduced gemma3-4b, whose d_ff and K/V shards cut the
8x128 blocks (the sites gather their maps) and whose 2 KV heads replicate
over 4 ranks; (b) the reduced starcoder2-15b widened so every shard falls
on a block edge (the sites run shard by shard, K/V split by head).

Exact: the aux's bytes, zero fraction and block count, the handoff's
per-leaf records, total and reconcile, the reference at model 4 against
itself at model 1, and every model rank's logits against its data rank's
first rank's, bit for bit. allclose at 1e-4 (the repo's float32 LM
tolerance: the row-parallel sums add in another order): logits, and each
rank's cache shard against its rows and heads of the reference's cache.
Equal: the greedy tokens. The fixture takes ~60 s, the JAX compiles most
of it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_cases as C
from _torch_parity import bits
from repro_torch import configs

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(C.MODEL * C.DATA)
CASES = [(t, b) for t in C.CONFIGS for b in C.BACKENDS]
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)       # the repo's bf16 LM tolerance


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({config tag: reference outputs}, the port's 8 rank outputs)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("tp_serve")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    refs = {tag: subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp_cases as C; "
         "C.reference_main(sys.argv[1], sys.argv[2])", str(d), tag],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in C.CONFIGS}
    try:
        spawn(C.port_rank, len(RANKS), (str(d),), device="cpu")
    finally:
        errs = {tag: p.communicate(timeout=600)[1] for tag, p in refs.items()}
    for tag, p in refs.items():
        assert p.returncode == 0, errs[tag][-3000:]
    ref = {tag: dict(np.load(d / f"ref_{tag}.npz", allow_pickle=True)) for tag in C.CONFIGS}
    return ref, [torch.load(d / f"rank{i}.pt", weights_only=False) for i in RANKS]


def rows(p):
    n = C.B // C.DATA
    return slice(p["data_index"] * n, (p["data_index"] + 1) * n)


def test_ranks_lay_out_as_the_reference_mesh(runs):
    _, port = runs
    for rank, p in enumerate(port):
        assert (p["data_index"], p["model_index"]) == divmod(rank, C.MODEL)


@pytest.mark.parametrize("tag,backend", CASES)
def test_reference_is_the_same_at_model_4_and_model_1(runs, tag, backend):
    """The precondition: GSPMD's partition changes no observable."""
    r = runs[0][tag]
    a, b = f"{tag}_{backend}_m{C.MODEL}", f"{tag}_{backend}_m1"
    for key in ("zero_frac", "n_blocks", "measured"):
        assert np.array_equal(r[f"{a}_{key}"], r[f"{b}_{key}"]), key
    assert [tuple(x) for x in r[f"{a}_records"]] == [tuple(x) for x in r[f"{b}_records"]]
    np.testing.assert_allclose(r[f"{a}_logits"], r[f"{b}_logits"], **TOL)


@pytest.mark.parametrize("tag,backend", CASES)
def test_site_observables_equal_the_reference(runs, tag, backend):
    ref, port = runs
    r, k = ref[tag], f"{tag}_{backend}"
    rk = f"{k}_m{C.MODEL}"
    for p in port:
        assert np.array_equal(bits(p[f"{k}_zero_frac"]), bits(r[f"{rk}_zero_frac"]))
        assert p[f"{k}_n_blocks"] == float(r[f"{rk}_n_blocks"]) > 0
        assert p[f"{k}_measured"] == int(r[f"{rk}_measured"]) > 0
        assert 0.0 < float(p[f"{k}_zero_frac"]) < 1.0


@pytest.mark.parametrize("tag,backend", CASES)
def test_handoff_bytes_and_reconcile_equal_the_reference(runs, tag, backend):
    ref, port = runs
    r, k = ref[tag], f"{tag}_{backend}"
    want = [tuple(x) for x in r[f"{k}_m{C.MODEL}_records"]]
    deltas = [tuple(x) for x in r[f"{k}_m{C.MODEL}_deltas"]]
    assert want and any(x[4] < x[5] for x in want)        # some block was dead
    for p in port:
        assert [tuple(x) for x in p[f"{k}_records"]] == want
        assert [tuple(x) for x in p[f"{k}_deltas"]] == deltas


@pytest.mark.parametrize("tag,backend", CASES)
def test_logits_tokens_and_caches_match_the_reference(runs, tag, backend):
    ref, port = runs
    r, k = ref[tag], f"{tag}_{backend}"
    rk = f"{k}_m{C.MODEL}"
    n_cache = int(r[f"{rk}_n_cache"])
    for p in port:
        np.testing.assert_allclose(p[f"{k}_logits"].numpy(), r[f"{rk}_logits"][rows(p)], **TOL)
        assert np.array_equal(p[f"{k}_tokens"].numpy(), r[f"{rk}_tokens"][rows(p)])
        assert len(p[f"{k}_cache"]) == n_cache
        for i, leaf in enumerate(p[f"{k}_cache"]):
            want = r[f"{rk}_cache{i}"][..., rows(p), :, :, :]
            h = leaf.shape[-2]
            if h != want.shape[-2]:                           # this rank's KV heads
                want = want[..., p["model_index"] * h:(p["model_index"] + 1) * h, :]
            np.testing.assert_allclose(leaf.numpy(), want, **TOL)


@pytest.mark.parametrize("tag,backend", CASES)
def test_model_ranks_agree_bit_for_bit(runs, tag, backend):
    _, port = runs
    k = f"{tag}_{backend}"
    for p in port:
        first = port[p["data_index"] * C.MODEL]
        assert np.array_equal(bits(p[f"{k}_logits"]), bits(first[f"{k}_logits"]))
        assert torch.equal(p[f"{k}_tokens"], first[f"{k}_tokens"])


@pytest.mark.parametrize("tag,backend", CASES)
def test_sites_run_by_the_engine_rules(runs, tag, backend):
    """(a) gathers its d_ff map and keeps w_down whole, K/V whole (counted
    once); (b) runs every map shard by shard, K/V split by head; the labels
    are the backend's, as in one process."""
    _, port = runs
    k = f"{tag}_{backend}"
    want = ({"ffn_hidden": "gather", "kv_cache": "whole"} if tag == "gemma3"
            else {"ffn_hidden": "blocks", "kv_cache": "blocks"})
    cfg = C.config(tag, backend, configs)
    for p in port:
        sites = p[f"{k}_sites"]
        assert {(s["site"], s["rule"]) for s in sites} == set(want.items())
        assert {s["backend"] for s in sites} == {backend}
        assert sum(s["site"] == "ffn_hidden" for s in sites) == cfg.n_layers
        heads = set(p[f"{k}_heads"])
        assert heads == ({cfg.n_kv_heads} if tag == "gemma3"
                         else {cfg.n_kv_heads // C.MODEL})
        rows_w = cfg.d_ff if tag == "gemma3" else cfg.d_ff // C.MODEL
        assert p[f"{k}_w_down"] == (rows_w, cfg.d_model)


@pytest.mark.parametrize("tag", list(C.CONFIGS))
def test_validated_handoff_serves_the_same(runs, tag):
    """``--validate checksum``: the stream sites and the handoff checked,
    the same tokens and bytes, nothing recovered."""
    _, port = runs
    k = f"{tag}_stream"
    for p in port:
        tokens, recovered, handoff, measured = p[f"{k}_checked"]
        assert torch.equal(tokens, p[f"{k}_tokens"]) and recovered == 0
        assert handoff == sum(x[1] + x[2] for x in p[f"{k}_records"])
        assert measured == p[f"{k}_measured"]


def test_placements_and_shard_cut_follow_the_specs():
    """In one process, on a stand-in (data 2, model 4) mesh: every
    parameter's placements name the dimension its Spec splits over each
    axis, and the shard cut at coordinates (data 1, model 2) is that part of
    the whole tensor. A vocabulary of 510 does not split over 4, so
    ``_axis_ok`` drops the axis and the embedding stays whole; serving keeps
    every parameter whole over ``data`` and, where the hidden map is
    gathered, ``w_down`` whole over ``model`` too."""
    import types

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm import LM
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    coords = {"data": 1, "model": 2}
    cfg = configs.reduced("gemma3-4b").replace(vocab=510)
    sd = LM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    specs = sh.param_specs(sd, cfg, mesh)
    places = sh.param_shardings(sd, cfg, mesh)
    assert specs["embed"] == sh.Spec(None, None)            # 510 % 4: dropped
    assert places["embed"] == (Replicate(), Replicate())
    assert places["run0.0.sub0.attn.wq"] == (Shard(0), Shard(1))
    assert sh.to_shardings(specs["run0.0.sub0.attn.wq"], mesh) == (Shard(0), Shard(1))
    split = 0
    for name, t in sd.items():
        for axis, pl in zip(("data", "model"), places[name]):
            dims = [d for d, a in enumerate(specs[name])
                    if axis == a or (isinstance(a, tuple) and axis in a)]
            assert pl == (Shard(dims[0]) if dims else Replicate()), name
        got = sh.local_shard(t, places[name], mesh, coords)
        want = t
        for axis, pl in zip(("data", "model"), places[name]):
            if isinstance(pl, Shard):
                n = want.shape[pl.dim] // mesh.shape[axis]
                want = want.narrow(pl.dim, coords[axis] * n, n)
        assert torch.equal(got, want), name
        split += got.numel() < t.numel()
    assert split > 0
    serving = sh.serving_shardings(sd, cfg, mesh)
    assert all(isinstance(p[0], Replicate) for p in serving.values())
    assert serving["run0.0.sub0.ffn.w_down"] == (Replicate(), Replicate())
    assert serving["run0.0.sub0.ffn.w_up"] == (Replicate(), Shard(1))
    model = sh.shard_model_(LM(cfg, generator=torch.Generator().manual_seed(0)), mesh,
                            coords)
    assert model.mesh is mesh and tuple(model.embed.shape) == (510, cfg.d_model)
    assert tuple(model.run0[0]["sub0"].attn.wq.shape) == (cfg.d_model, 1, cfg.head_dim)
    assert torch.equal(model.run0[0]["sub0"].ffn.w_up,
                       sd["run0.0.sub0.ffn.w_up"][:, 2 * 64:3 * 64])


@pytest.mark.parametrize("tag", list(C.CONFIGS))
def test_sharded_build_equals_building_whole_and_cutting(tag):
    """``sharding.build_sharded`` draws each parameter whole and cuts it at
    once: at every coordinate of a stand-in (data 2, model 4) mesh its
    shards are those ``shard_model_`` cuts from the model built whole from
    the same generator, bit for bit, and no parameter is left whole that
    the cut splits."""
    import types

    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm import LM
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    cfg = C.config(tag, "fused", configs)
    for mi in range(C.MODEL):
        coords = {"data": 1, "model": mi}
        want = sh.shard_model_(LM(cfg, generator=torch.Generator().manual_seed(3)), mesh,
                               coords).state_dict()
        got = sh.build_sharded(cfg, mesh, generator=torch.Generator().manual_seed(3),
                               coords=coords)
        assert got.mesh is mesh and list(got.state_dict()) == list(want)
        for name, t in got.state_dict().items():
            assert np.array_equal(bits(t), bits(want[name])), (mi, name)
    whole = dict(LM(cfg).named_parameters())
    assert any(t.shape != whole[n].shape for n, t in got.named_parameters())


def test_cli_params_load_over_the_draws_on_every_rank(tmp_path):
    """``--params``: nonzero biases (zero at init) for the reduced
    starcoder2-15b, loaded over the seed-0 draws by one process and by 2
    spawned ranks that each keep their shard (``b_up`` and the QKV biases
    split, ``b_down`` whole and added once): the same greedy tokens,
    logits within BF16 (the served weights are bf16, and the row-parallel
    sums add in another order), and logits that the biases moved by more
    than ten times that."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    argv = ["--arch", "starcoder2-15b", "--reduced", "--device", "cpu", "--backend",
            "stream", "--batch", "2", "--prompt-len", "32", "--gen", "3", "--t-obj", "2.45"]
    cfg = serve.build_config("starcoder2-15b", reduced=True)
    rng = np.random.default_rng(1)
    biases = {n: torch.from_numpy(rng.normal(0.0, C.BIAS_STD, tuple(t.shape))).float()
              for n, t in LM(cfg, device="meta").named_parameters()
              if n.rsplit(".", 1)[-1] in C.BIASES}
    assert any(n.endswith("b_down") for n in biases) and any(n.endswith("bq") for n in biases)
    torch.save(biases, tmp_path / "biases.pt")
    plain = serve.main(argv)
    one = serve.main([*argv, "--params", str(tmp_path / "biases.pt")])
    tp = serve.main([*argv, "--params", str(tmp_path / "biases.pt"), "--model-parallel", "2"])
    assert float((one["logits"] - plain["logits"]).abs().max()) > 10 * BF16["atol"]
    assert torch.equal(tp["tokens"], one["tokens"].cpu())
    for r in tp["ranks"]:
        torch.testing.assert_close(r["logits"], one["logits"].float(), **BF16)
    assert np.array_equal(bits(tp["ranks"][0]["logits"]), bits(tp["ranks"][1]["logits"]))


@pytest.mark.parametrize("argv,match", [
    (["--requests", "2", "--slots", "2", "--prompt-len", "32", "--gen", "4"],
     "continuous serving")])
def test_unported_configurations_raise_before_launch(argv, match, tmp_path):
    """What tensor-parallel serving refused before the model was built
    now serves: continuous serving in a joined world of 4 ranks at
    ``--model-parallel 2`` (data 2) raises nothing on any rank, and every
    rank, one a (data, model) coordinate, serves the same requests and
    meters the same pages, its hot set of 2 lanes split one a data rank."""
    from repro_torch.launch.mesh import spawn
    spawn(C.unported_rank, 4, (["--reduced", "--device", "cpu", "--model-parallel", "2",
                                *argv, "--save", str(tmp_path)], str(tmp_path)), device="cpu")
    reps = []
    for r in range(4):
        assert (tmp_path / f"raised{r}.txt").read_text() == "", match
        reps.append(torch.load(tmp_path / f"rank{r}.pt", weights_only=False))
    assert sorted((p["data_index"], p["model_index"]) for p in reps) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert reps[0]["report"]["n_requests"] == 2 and reps[0]["records"]
    for p in reps:
        assert p["requests"] == reps[0]["requests"] and p["records"] == reps[0]["records"]
        assert p["hot_lanes"][2] == 1


@pytest.mark.parametrize("arch,backend,n,t_obj", [
    ("gemma3-4b", "fused", 2, 2.45), ("chameleon-34b", "stream", 2, 2.45),  # the untied head
    ("qwen2.5-14b", "pallas", 2, 2.45), ("command-r-35b", "reference", 2, 2.45),
    # the other layer kinds at --model-parallel 4
    ("granite-moe-1b-a400m", "stream", 4, 0.025), ("llama4-scout-17b-a16e", "fused", 4, 0.025),
    ("mamba2-2.7b", "stream", 4, 4.8), ("recurrentgemma-2b", "pallas", 4, 2.5),
    ("whisper-medium", "reference", 4, 2.5)])
def test_cli_spawns_the_ranks_and_serves_like_one_process(arch, backend, n, t_obj):
    """``serve.main([..., "--model-parallel", n])`` from a plain process:
    n ranks spawned on this host (data 1), the same greedy tokens as one
    process, the handoff's bytes equal, every rank's logits bit for bit;
    the other dense architectures on every backend, and the MoE, SSM,
    RG-LRU and encoder-decoder ones on 4 ranks."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--backend", backend,
            "--batch", "2", "--prompt-len", "32", "--gen", "3", "--t-obj", str(t_obj)]
    one = serve.main(argv)
    tp = serve.main([*argv, "--model-parallel", str(n)])
    assert len(tp["ranks"]) == n and tp["wire"] == "gloo (host copies)"
    assert torch.equal(tp["tokens"], one["tokens"].cpu())
    assert all(np.array_equal(bits(r["logits"]), bits(tp["ranks"][0]["logits"]))
               for r in tp["ranks"])
    if one["meter"] is not None:
        assert sum(r["payload_bytes"] + r["index_bytes"] for r in tp["records"]) == \
            one["meter"].measured_bytes()
    assert tp["phases"]["prefill"]["tp_calls"] > 0
