"""The sharded train step of the other layer kinds (``launch.train
--model-parallel``: the MoE by expert parallelism, Mamba-2's SSD, the
RG-LRU, the encoder-decoder, and the MoE under the "dp" profile) against
the reference's, on the CPU.

One module fixture runs both sides at once: the reference's
``jax.jit(make_train_step)`` with ``train_state_specs`` on 8 forced host
devices at ``make_host_mesh(model=4)`` (data 2; one JAX subprocess a
configuration, ``tests/_torch_tp_train_layers_cases.py::reference_main``)
and the port as one 8-rank ``gloo`` world on a (data 2, model 4) mesh
(``port_rank``) that trains the nine configurations of the cases module in
turn, two float32 steps each at ``warmup_cosine(1e-3, 1, 10)`` on 8 x 64
tokens.

Tolerances, those of ``tests/test_torch_tp_train.py``: losses,
``grad_norm`` and ``router_aux`` at rtol 1e-5; the stream bytes and, at a
constant threshold, ``zebra_reg`` (a block count) exact, with threshold
nets the Eq. 1 term at rtol 1e-5; every rank's shard of the first AdamW
moment after step 1 at atol 1e-7; every rank's parameter shards after
step 2 at atol 1e-4; a leaf two ranks both hold, bit for bit alike on
both. Three readings need more than that module states, each bounded and
checked for its cause: ``zero_frac``, a block-weighted sum over the sites
that XLA contracts into fused multiply-adds, at rtol 1e-6 (one float32
ulp apart on recurrentgemma, as in one process,
``tests/test_torch_lm_train.py``); with compression an element one wire
level apart must have entered the wire format within ``GRAD_NOISE`` of a
rounding boundary in the gradient's units (the MoE's gradients sit ~1e-8
apart whatever the element's size, so a share of a level does not bound
them); without compression a parameter beyond 1e-4 after step 2 must have
a first moment under ``TINY_MOMENT`` on both sides (one mamba2 element,
moments 5e-10 and 1e-9 of opposite sign: Adam's step follows the sign).

Fault readings (each repair of the sharded backward undone in a scratch
copy of the port, this module run on the configurations it concerns; the
first leaf the first-moment check meets, the embedding, is off by, against
its 1e-7):

* Mamba-2's norm sum through ``psum_model`` (the gradient passed through,
  not summed over ``model``): ``mamba2`` 2.3e-3; losses, first moment and
  parameters fail;
* Mamba-2's B and C without ``copy_model``: ``mamba2`` 2.6e-3, and the
  shared ``b_proj``/``c_proj``/``conv_b``/``conv_c`` differ across ranks;
* the RG-LRU's gate input through ``gather_model`` (this rank's slice
  kept, not summed): ``rgemma`` 1.7e-4, ``rgemma_6h`` 1.8e-4;
* the expert-parallel row gather keeping this rank's rows of the
  gradient without summing them over ``data``: ``granite`` 6.7e-6,
  ``granite_drop`` 3.5e-6, ``granite_tnet`` 3.5e-6, ``llama4`` 1.3e-5;
  with a mean over ``data`` in place of the sum, ``granite`` and
  ``granite_drop`` fail the losses, first moment and parameters too;
* the experts' input without ``copy_model``: 6.6e-6, 3.0e-6, 5.3e-6 and
  1.3e-5, and the shared leaves differ across ranks;
* the dispatch map gathered for its threshold net by ``gather_model``
  (no sum over ``model``): ``granite_tnet`` 1.7e-7;
* the "dp" profile's ``shard_mean`` without a gradient: ``granite_dp``
  1.7e-5.

The fixture takes ~60 s on 8 cores, the nine JAX compiles most of it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_train_layers_cases as C
from _torch_parity import bits
from test_torch_tp_train import StandIn, allowed, one_rank_group, shard, wire_level  # noqa: F401

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(C.MODEL * C.DATA)
CASES = list(C.CASES)
MOE = [c for c in CASES if C.CASES[c][0] in (C.GRANITE, "llama4-scout-17b-a16e")]
TOL = dict(rtol=1e-5, atol=0)
# where an element whose two sides' gradients round to neighbouring levels of
# the wire format may lie: within GRAD_NOISE of the rounding boundary, in the
# gradient's units. The two sides' float32 gradients sit up to ~3e-8 apart in
# the uncompressed runs (the first moments 1.4e-9 apart in granite, 3.3e-8
# in mamba2's embedding), whatever the element's size, so this is absolute,
# not a share of a level as in ``tests/test_torch_tp_train.py`` (seen: 1.2e-9)
GRAD_NOISE = 1e-7
B1 = 0.9                # AdamW's b1: the first moment after step 1 is (1 - b1) g
# the first moment below which an element's sign is below the resolution
# of the two sides' float32 sums (seen: 5e-10 and 1e-9 on either side of 0
# for one mamba2 out_proj element); Adam's second step moves such an
# element by up to ~lr in the sign's direction
TINY_MOMENT = 1e-8


def levels(case: str, name: str, ref: dict, want: np.ndarray) -> np.ndarray:
    """One level of the wire format at each element of ``want`` (a shard of
    the reference's first moment of ``name``), in the moment's units: a
    bf16 ulp is at most 2**-7 of the value; an int8 level is the max over
    the reference's whole leaf (every slice of a stacked run,
    ``steps.stacked_leaves``) over 127."""
    mode = C.compress_mode(case)
    if mode != "int8":
        return np.broadcast_to(wire_level(mode, ref[f"mom.{name}"], want), want.shape)
    from repro_torch import configs
    from repro_torch.launch.steps import stacked_leaves
    from repro_torch.models.lm import LM
    stacks = stacked_leaves(LM(C.config(case, configs), device="meta"))
    group = [n for n in stacks if stacks[n] == stacks.get(name)] or [name]
    top = max(np.abs(ref[f"mom.{n}"]).max() for n in group)
    return np.full(want.shape, top / 127.0 * (1 + 1e-3))


def near_boundary(pos: np.ndarray, level: np.ndarray) -> bool:
    """Every element at ``pos`` (its ``level_position``) of a level of
    ``level`` (moment units) within GRAD_NOISE of the rounding boundary, in
    the gradient's units."""
    return bool(np.all(np.abs(pos - 0.5) * level / (1 - B1) <= GRAD_NOISE))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: reference outputs}, the port's 8 rank outputs)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("tp_train_layers")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    refs = {case: subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp_train_layers_cases as C; "
         "C.reference_main(sys.argv[1], sys.argv[2])", str(d), case],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case in CASES}
    try:
        spawn(C.port_rank, len(RANKS), (str(d),), device="cpu")
    finally:
        errs = {case: p.communicate(timeout=900)[1] for case, p in refs.items()}
    for case, p in refs.items():
        assert p.returncode == 0, errs[case][-3000:]
    ref = {case: dict(np.load(d / f"ref_{case}.npz")) for case in CASES}
    return ref, [torch.load(d / f"rank{i}.pt", weights_only=False) for i in RANKS]


@pytest.mark.parametrize("case", CASES)
def test_site_observables_exact(case, runs):
    """Each step's stream bytes, and at a constant threshold the realised
    zero-block count, equal the reference's on every rank, and its zero
    fraction to the last bit of its sum over the sites: each site's live
    blocks are counted once over the mesh (an MoE dispatch map once over
    ``data`` and ``model``; under the "dp" profile averaged over the
    ranks)."""
    ref, port = runs
    r = ref[case]
    tnet = C.CASES[case][5]
    for p in port:
        for i in range(C.STEPS):
            m = p[f"{case}_m{i}"]
            # the block-weighted sum over the sites: XLA contracts its
            # products and sums into fused multiply-adds, so the last bit
            # may differ (as in one process: tests/test_torch_lm_train.py)
            np.testing.assert_allclose(float(m["zero_frac"]), r[f"m{i}_zero_frac"], rtol=1e-6,
                                       atol=0, err_msg=f"{case} {i}")
            assert m["bytes"] == int(r[f"m{i}_bytes"]), (case, i)
            if tnet:
                np.testing.assert_allclose(float(m["zebra_reg"]), r[f"m{i}_zebra_reg"], **TOL)
            else:
                assert float(m["zebra_reg"]) == float(r[f"m{i}_zebra_reg"]), (case, i)
    zf = float(port[0][f"{case}_m0"]["zero_frac"])
    assert (zf >= 0.0) if tnet else (0.05 < zf < 0.95), (case, zf)
    assert (port[0][f"{case}_m0"]["bytes"] > 0) == (C.CASES[case][2] == "stream")


@pytest.mark.parametrize("case", CASES)
def test_losses_and_grad_norm_match(case, runs):
    """The global batch's loss, ce and ``router_aux`` and the global
    gradient norm of each step, equal on every rank, at rtol 1e-5 of the
    reference's."""
    ref, port = runs
    for i in range(C.STEPS):
        for k in ("loss", "ce", "grad_norm", "router_aux"):
            got = [float(p[f"{case}_m{i}"][k]) for p in port]
            assert len(set(got)) == 1, (case, i, k, got)
            np.testing.assert_allclose(got[0], ref[case][f"m{i}_{k}"], err_msg=f"{case} {i} {k}",
                                       **TOL)


@pytest.mark.parametrize("case", CASES)
def test_first_moment_shards_match(case, runs):
    """After step 1 every rank's shard of the first AdamW moment ((1 - b1)
    times the reduced, compressed and clipped gradient) is within 1e-7 of
    its shard of the reference's: the per-shard gradient check that each
    repair of the sharded backward passes and its fault fails (module
    docstring). A compressed gradient may sit one wire level apart where
    it entered the wire format at a rounding boundary."""
    ref, port = runs
    mode = C.compress_mode(case)
    for p in port:
        places = p[f"{case}_places"]
        for name, got in p[f"{case}_mom"].items():
            whole = ref[case][f"mom.{name}"]
            want = shard(whole, places[name], p)
            assert got.shape == want.shape, (name, got.shape, want.shape)
            diff = np.abs(got.numpy() - want)
            off = diff > 1e-7
            where = f"{case} rank {p['data_index']},{p['model_index']} {name}"
            assert off.sum() <= (allowed(off.size) if mode != "none" else 0), (where, diff.max())
            level = levels(case, name, ref[case], want)
            assert np.all(diff[off] <= level[off] + 1e-7), (where, diff[off], level[off])
            if off.any():
                pos = p[f"{case}_edge"][0][name].numpy()[off]
                assert near_boundary(pos, level[off]), (where, pos, level[off])


@pytest.mark.parametrize("case", CASES)
def test_parameter_shards_after_two_steps(case, runs):
    """Every rank's master shards after step 2 at atol 1e-4 of the
    reference's (with compression, the wire-level allowance of
    ``tests/test_torch_tp_train.py``); without compression an element may
    lie beyond it (at most 0.1 % of a leaf, within 2.5 times the lr)
    only where its first moment after step 1 is below ``TINY_MOMENT`` on
    both sides: Adam's second step moves it by ~lr in the direction of a
    sign the two float32 sums do not pin down. The module's parameters,
    gathered over ``data``, are this rank's model shards of the same
    values."""
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.optim import warmup_cosine
    ref, port = runs
    mode = C.compress_mode(case)
    lr = warmup_cosine(*C.LR)(C.STEPS - 1)
    for p in port:
        places = p[f"{case}_places"]
        coords = {"data": p["data_index"], "model": p["model_index"]}
        for name, got in p[f"{case}_params"].items():
            want = shard(ref[case][f"param.{name}"], places[name], p)
            diff = np.abs(got.numpy() - want)
            off = diff > 1e-4 + 1e-4 * np.abs(want)
            assert off.sum() <= allowed(off.size), (case, name)
            assert np.all(diff <= 2.5 * lr), (case, name, diff.max())
            if off.any() and mode == "none":
                m_ref = shard(ref[case][f"mom.{name}"], places[name], p)[off]
                m_port = p[f"{case}_mom"][name].numpy()[off]
                assert np.all(np.maximum(np.abs(m_ref), np.abs(m_port)) <= TINY_MOMENT), \
                    (case, name, m_ref, m_port)
            elif off.any():     # step 1's lr is 0: step 2's gradient is step 1's, near enough
                level = levels(case, name, ref[case],
                               shard(ref[case][f"mom.{name}"], places[name], p))[off]
                gap = np.min([np.abs(e[name].numpy()[off] - 0.5) for e in p[f"{case}_edge"]],
                             axis=0)
                assert near_boundary(0.5 + gap, level), (case, name, gap)
            cut = local_shard(p[f"{case}_module"][name], places[name], StandIn(), coords,
                              axes=("data",))
            assert np.array_equal(bits(cut), bits(got)), name


@pytest.mark.parametrize("case", CASES)
def test_shared_leaves_bitwise_alike(case, runs):
    """A leaf shard two ranks both hold (a router or a norm on every model
    rank, Mamba-2's ``b_proj``/``conv_b``, a replicated attention's
    weights, everything under the "dp" profile) is bit for bit the same on
    each, in the parameters and in the first moment."""
    _, port = runs
    for kind in ("params", "mom", "module"):
        held = {}
        for p in port:
            places = p[f"{case}_places"]
            for name, t in p[f"{case}_{kind}"].items():
                key = (name,) + tuple(
                    p[f"{a}_index"] if getattr(pl, "dim", None) is not None else None
                    for a, pl in zip(("data", "model"), places[name])
                    if kind != "module" or a == "model")
                held.setdefault(key, []).append(bits(t))
        shared = [v for v in held.values() if len(v) > 1]
        assert shared, (case, kind)
        for v in shared:
            assert all(np.array_equal(v[0], x) for x in v[1:]), (case, kind)


def test_backward_collectives_ran(runs):
    """The tensor-parallel cases summed gradients over an axis in their
    backward on every rank, the same number of times; the "dp" profile ran
    none (no layer is tensor-parallel)."""
    _, port = runs
    for case in CASES:
        calls = {p[f"{case}_bwd_calls"] for p in port}
        assert len(calls) == 1, (case, calls)
        assert (calls.pop() > 0) == (case != "granite_dp"), case


@pytest.mark.parametrize("case", MOE)
def test_moe_dispatch_is_the_reference_batch(case, runs):
    """Expert parallelism routes the global microbatch on every rank (the
    reference's capacity, and the same pairs dropped on every rank: some at
    capacity factor 0.5); the "dp" profile routes each rank's own rows at
    its own capacity; a remat recompute is not recorded."""
    _, port = runs
    cfg = C.config(case, __import__("repro_torch.configs", fromlist=["configs"]))
    K = max(cfg.grad_accum, 1)
    pure_dp = cfg.sharding_profile == "dp"
    T = C.B // K * C.S // (len(RANKS) if pure_dp else 1)
    cap = int(max(1, round(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts)))
    routes = [p[f"{case}_routes"] for p in port]
    assert len(routes[0]) == C.STEPS * K * cfg.n_layers, (case, len(routes[0]))
    for r in routes:
        assert all(t == T and c == cap for t, c, _ in r), (case, r[:2])
        if not pure_dp:
            assert r == routes[0]
    if case == "granite_drop":
        assert sum(d for _, _, d in routes[0]) > 0


@pytest.mark.parametrize("profile,sites,refused", [
    ("dp", ("ffn_hidden",), False),
    ("dp", ("ffn_hidden", "layer_out"), True),
    ("tp", ("ffn_hidden", "layer_out"), False),
])
def test_dp_profile_takes_only_the_moe_sites(profile, sites, refused):
    """Under the "dp" profile the sharded train step takes granite only
    with its Zebra sites inside the MoE (whose observables
    ``moe_apply_dp`` averages over the ranks): a ``layer_out`` site there
    would report each rank's own rows, so it raises before any launch; the
    "tp" profile takes it."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import check_tp, tp_unported
    cfg = configs.reduced(C.GRANITE).replace(sharding_profile=profile, zebra_sites=sites)
    assert (tp_unported(cfg) is not None) == refused
    if refused:
        with pytest.raises(NotImplementedError, match="outside the MoE"):
            check_tp(cfg, 4, train=True)
    else:
        check_tp(cfg, 4, train=True)


def test_split_consumer_collectives_on_one_rank(one_rank_group):
    """The sum and the gather for a consumer split over the model axis
    against their whole-tensor forms on a 1-rank group: the identity
    forward, and a backward that sums the gradient over the group (the
    gradient itself) before the gather keeps this rank's slice (the
    whole), each backward counted in ``TP_TRAFFIC``; the row gather of the
    expert-parallel MoE the same over its axis."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.collectives import TP_TRAFFIC
    from repro_torch.models.lm import ffn
    axis = ctx.CommAxis("model", 1, one_rank_group, 0)
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    g = torch.randn(3, 4, dtype=torch.float64)
    before = dict(TP_TRAFFIC)
    for fn in (lambda t: ctx._SumModelSplit.apply(t, axis),
               lambda t: ctx._GatherModelSplit.apply(t, axis, 1),
               lambda t: ffn._GatherRows.apply(t, axis)):
        y = fn(x)
        assert torch.equal(y, x)
        (dx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(dx, g)
    assert TP_TRAFFIC["calls"] - before["calls"] == 3
    assert TP_TRAFFIC["bwd_calls"] - before["bwd_calls"] == 3
    assert TP_TRAFFIC["bwd_bytes"] - before["bwd_bytes"] == 3 * g.numel() * g.element_size()
