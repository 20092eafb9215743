"""The sharded train step of the port (``launch.train --model-parallel``)
against the reference's, on the CPU.

One module fixture runs both sides at once: the reference's
``jax.jit(make_train_step)`` with ``train_state_specs`` on 8 forced host
devices at ``make_host_mesh(model=4)`` (data 2; one JAX subprocess a
configuration, ``tests/_torch_tp_train_cases.py::reference_main``), and
the port as one 8-rank ``gloo`` world on a (data 2, model 4) mesh
(``port_rank``): each rank holds its model shards whole over data in the
module and its (data, model) shards of the master parameters, both AdamW
moments and the int8 residual in the state. Three configurations in
float32, two steps each at ``warmup_cosine(1e-3, 1, 10)`` on 8 x 64
tokens: (a) the reduced gemma3-4b on ``stream``, K 2, int8 (the site
gathers its map, the KV heads replicate); (b) the widened starcoder2-15b on
``stream``, K 1, bf16 (every map on block edges, biases drawn N(0, 0.5));
(c) the reduced gemma3-4b on ``reference`` with threshold nets, K 1, no
compression.

Tolerances, those of ``tests/test_torch_lm_train.py``: the site
observables exact (``zero_frac``, ``measured_bytes``, and ``zebra_reg``
at a constant threshold, a block count; with threshold nets it is the Eq. 1
loss term, at rtol 1e-5); losses and ``grad_norm`` at rtol 1e-5; every
rank's shard of the first AdamW moment after step 1 ((1 - b1) times the
clipped gradient: the per-shard gradient check) at atol 1e-7; every rank's
parameter shards after step 2 at atol 1e-4; a leaf two ranks both hold,
bit for bit alike on both. With compression, the two sides' gradients,
equal to the last bits, can round an element at a rounding boundary of
the wire format to neighbouring levels: at most 0.1 % of a leaf's
elements (at least one) may then sit one bf16 ulp or one int8 level apart
in the first moment, and beyond 1e-4 (within 2.5 times the lr, Adam's
bound) in the parameters (1 to 2 elements of a leaf in these runs), and
each such element's gradient, as this rank handed it to the wire format,
must lie within ``EDGE`` (2**-12) of a level of a rounding boundary (seen:
at most 7.6e-5); without compression none. The fixture takes ~45 s, the JAX compiles most
of it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_train_cases as C
from _torch_parity import bits

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(C.MODEL * C.DATA)
CASES = list(C.CASES)
TOL = dict(rtol=1e-5, atol=0)
SHARE = 1e-3        # of a leaf's elements: one wire level apart (compressed cases)
# of a level, from its rounding boundary: where a pre-wire value that
# differs from the reference's in the last bits may round either way (the
# worst seen 7.6e-5, 5 float32 ulps of a bf16 level; an element lands this
# close by chance with probability 2 * EDGE)
EDGE = 2.0 ** -12


class StandIn:
    """A mesh as the sharding rules read it: axis sizes and names."""
    shape = {"data": C.DATA, "model": C.MODEL}
    axis_names = ("data", "model")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: reference outputs}, the port's 8 rank outputs)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("tp_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    refs = {case: subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp_train_cases as C; "
         "C.reference_main(sys.argv[1], sys.argv[2])", str(d), case],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case in CASES}
    try:
        spawn(C.port_rank, len(RANKS), (str(d),), device="cpu")
    finally:
        errs = {case: p.communicate(timeout=600)[1] for case, p in refs.items()}
    for case, p in refs.items():
        assert p.returncode == 0, errs[case][-3000:]
    ref = {case: dict(np.load(d / f"ref_{case}.npz")) for case in CASES}
    return ref, [torch.load(d / f"rank{i}.pt", weights_only=False) for i in RANKS]


def shard(whole: np.ndarray, places, p) -> np.ndarray:
    """Rank ``p``'s shard of a whole reference array under ``places``."""
    from repro_torch.distributed.sharding import local_shard
    coords = {"data": p["data_index"], "model": p["model_index"]}
    return local_shard(torch.from_numpy(whole), places, StandIn(), coords).numpy()


def test_ranks_lay_out_as_the_reference_mesh(runs):
    _, port = runs
    for rank, p in enumerate(port):
        assert (p["data_index"], p["model_index"]) == divmod(rank, C.MODEL)


@pytest.mark.parametrize("case", CASES)
def test_site_observables_exact(case, runs):
    """Each step's zero fraction and stream bytes, and at a constant
    threshold the realised zero-block count, equal the reference's on
    every rank: each site's live blocks are summed over the mesh."""
    ref, port = runs
    r = ref[case]
    for p in port:
        for i in range(C.STEPS):
            m = p[f"{case}_m{i}"]
            assert np.array_equal(bits(m["zero_frac"]), bits(r[f"m{i}_zero_frac"])), (case, i)
            assert m["bytes"] == int(r[f"m{i}_bytes"]), (case, i)
            if C.CASES[case][1]["zebra_tnet"]:
                np.testing.assert_allclose(float(m["zebra_reg"]), r[f"m{i}_zebra_reg"], **TOL)
            else:
                assert float(m["zebra_reg"]) == float(r[f"m{i}_zebra_reg"]), (case, i)
    zf = float(port[0][f"{case}_m0"]["zero_frac"])
    if C.CASES[case][1]["zebra_tnet"]:
        assert zf >= 0.0
    else:
        assert 0.2 < zf < 0.9, zf
    assert (port[0][f"{case}_m0"]["bytes"] > 0) == (C.CASES[case][1]["zebra_backend"] == "stream")


@pytest.mark.parametrize("case", CASES)
def test_losses_and_grad_norm_match(case, runs):
    """The global batch's loss and ce and the global gradient norm of each
    step, equal on every rank, at rtol 1e-5 of the reference's."""
    ref, port = runs
    for i in range(C.STEPS):
        for k in ("loss", "ce", "grad_norm"):
            got = [float(p[f"{case}_m{i}"][k]) for p in port]
            assert len(set(got)) == 1, (case, i, k, got)
            np.testing.assert_allclose(got[0], ref[case][f"m{i}_{k}"], err_msg=f"{case} {i} {k}",
                                       **TOL)


def wire_level(mode: str, whole: np.ndarray, want: np.ndarray):
    """One level of the gradient's wire format at the first moment's
    values ``want`` (a shard of ``whole``): a bf16 ulp is at most 2**-7 of
    the value; an int8 level is the tensor's max over 127 (its largest
    element decodes to exactly 127 levels); none has no levels."""
    if mode == "bf16":
        return np.abs(want) * 2.0 ** -7
    if mode == "int8":
        return np.abs(whole).max() / 127.0 * (1 + 1e-3)
    return 0.0


def allowed(n: int) -> int:
    """Elements of a leaf of n that may sit one wire level apart."""
    return int(np.ceil(n * SHARE))


@pytest.mark.parametrize("case", CASES)
def test_first_moment_shards_match(case, runs):
    """After step 1 the first AdamW moment is (1 - b1) times the reduced,
    compressed and clipped gradient: every rank's shard of every leaf at
    atol 1e-7 of its shard of the reference's. This is the per-shard
    gradient check: a replicated K/V weight whose partial gradients were
    not summed over ``model``, or a norm's that was, is off everywhere.
    A compressed gradient may round an element to the neighbouring level
    of its wire format (the two sides' gradients differ in the last bits,
    and a value at a rounding boundary goes either way): at most
    ``SHARE`` of a leaf's elements (at least one), each at most one level
    apart, and only one whose gradient shard entered the wire format
    within ``EDGE`` of a level of its rounding boundary (this rank's
    ``level_position``): the cause, checked on each element. Without
    compression none."""
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
            level = np.broadcast_to(wire_level(mode, whole, want), want.shape)
            assert np.all(diff[off] <= level[off] + 1e-7), (where, diff[off], level[off])
            if off.any():
                edge = np.abs(p[f"{case}_edge"][0][name].numpy()[off] - 0.5)
                assert np.all(edge <= EDGE), (where, edge)


@pytest.mark.parametrize("case", CASES)
def test_parameter_shards_after_two_steps(case, runs):
    """Every rank's master shards after step 2 at atol 1e-4 of the
    reference's (the second step moves them). Adam's normalised update
    turns a wire level that an element's gradient took on one side only
    into a visible step: with compression, at most ``SHARE`` of a leaf's
    elements (at least one) lie beyond 1e-4, each within 2.5 times the
    step's lr, and only one whose gradient entered the wire format within
    ``EDGE`` of a rounding boundary in step 1 or step 2. The module's
    parameters, gathered over ``data``, are this rank's model shards of the
    same values."""
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
            assert off.sum() <= (allowed(off.size) if mode != "none" else 0), (case, name)
            assert np.all(diff <= 2.5 * lr), (case, name, diff.max())
            if off.any():
                edge = np.min([np.abs(e[name].numpy()[off] - 0.5) for e in p[f"{case}_edge"]],
                              axis=0)
                assert np.all(edge <= EDGE), (case, name, edge)
            cut = local_shard(p[f"{case}_module"][name], places[name], StandIn(), coords,
                              axes=("data",))
            assert np.array_equal(bits(cut), bits(got)), name


@pytest.mark.parametrize("case", CASES)
def test_shared_leaves_bitwise_alike(case, runs):
    """A leaf shard two ranks both hold (a norm on every rank, K/V weights
    replicated over ``model``, a bias whole over ``data``) is bit for bit
    the same on each, in the parameters and in the first moment."""
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
    """The copies into the tensor-parallel region summed their gradients
    over ``model`` on every rank, the same number of times."""
    _, port = runs
    for case in CASES:
        calls = {p[f"{case}_bwd_calls"] for p in port}
        assert len(calls) == 1 and calls.pop() > 0, case


# ---------------------------------------------------------------------------
# Checkpoints of the sharded state (configuration CKPT_CASE, int8)
# ---------------------------------------------------------------------------

def stand_in(shape: dict):
    """A mesh as ``local_shard`` reads it, of the given axis sizes."""
    class Mesh:
        axis_names = tuple(shape)
    Mesh.shape = dict(shape)
    return Mesh()


def file_leaves(path) -> dict:
    with np.load(Path(path) / "shard_0.npz") as data:
        return {k: data[k] for k in data.files}


def manifest(path) -> dict:
    return json.loads((Path(path) / "manifest.json").read_text())


def ref_ckpt_as_port(model, flat: dict) -> dict:
    """The reference's checkpoint leaves under the port's flat names: each
    parameter-shaped subtree (``params``, ``opt/m``, ``opt/v``,
    ``compress/error``) through ``convert.port_params``, its stacked leaves
    split into the port's layers."""
    from repro_torch.models.lm.convert import port_params
    out = {"step": flat["step"]}
    for prefix in ("params", "opt/m", "opt/v", "compress/error"):
        tree = {}
        for k, v in flat.items():
            if k.startswith(prefix + "/"):
                *path, leaf = k[len(prefix) + 1:].split("/")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = v
        out.update({f"{prefix}/{k}": v for k, v in port_params(model, tree).items()})
    return out


def test_checkpoint_against_the_reference(runs):
    """The port's 8-rank save after step 2 at (data 2, model 4) against the
    reference's ``CheckpointManager.save`` of its sharded state there: the
    same whole leaves (the reference's stacked ones split into layers) and
    shapes, the step and the loader's step exact, the parameters within
    the sharded step's tolerances (atol 1e-4; int8 compressed: at most
    ``SHARE`` of a leaf beyond it, within 2.5 times the lr); both moments
    and the int8 residual within the first moment's (atol 1e-7; at most
    ``SHARE`` of a leaf beyond it, each within one int8 level of the
    second step's gradient, twice the reference's largest residual: the
    residual lies within half a level; step 1 at lr 0 leaves the
    parameters, and so the first step's gradient and level, as they were);
    a CRC per leaf.
    The reference's ``restore(like)`` of its own file gives its state back
    bit for bit."""
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.optim import warmup_cosine
    ref, port = runs
    case, d = C.CKPT_CASE, Path(port[0]["ckpt"]["dir"])
    assert bool(ref[case]["ckpt_restore_same"])
    want = ref_ckpt_as_port(LM(C.config(case, configs), device="meta"),
                            file_leaves(d / "ref_ckpt" / f"step_{C.STEPS}"))
    got = file_leaves(d / "ckpt" / f"step_{C.STEPS}")
    assert set(got) == set(want) and any(k.startswith("compress/error/") for k in got)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert int(got["step"]) == int(want["step"]) == C.STEPS
    for name in ("ckpt", "ref_ckpt"):
        man = manifest(d / name / f"step_{C.STEPS}")
        assert man["extra"] == {"loader_step": C.STEPS}
        assert set(man["checksums"]) == set(man["paths"])
    lr = warmup_cosine(*C.LR)(C.STEPS - 1)
    for k in (k for k in got if k.startswith("params/")):
        diff = np.abs(got[k] - want[k])
        off = diff > 1e-4 + 1e-4 * np.abs(want[k])
        assert off.sum() <= allowed(off.size) and np.all(diff <= 2.5 * lr), (k, diff.max())
    for k in (k for k in got if k.startswith(("opt/", "compress/"))):
        level = 2 * np.abs(want["compress/error/" + k.rsplit("/", 1)[1]]).max() * (1 + 1e-3)
        diff = np.abs(got[k] - want[k])
        off = diff > 1e-7
        assert off.sum() <= allowed(off.size) and np.all(diff <= level + 1e-7), (k, diff.max())


def cut(whole: np.ndarray, snap: dict, key: str, axes=None) -> np.ndarray:
    """A snapshot's rank's cut of a whole leaf, by its placements on its
    layout."""
    from repro_torch.checkpoint.sharded import leaf_places
    from repro_torch.distributed.sharding import local_shard
    mesh = stand_in(snap["shape"])
    return local_shard(torch.from_numpy(whole), leaf_places(snap["places"], key, mesh), mesh,
                       snap["coords"], axes=axes).numpy()


def same_state(a: dict, b: dict) -> list[str]:
    """The leaves and module tensors of two snapshots that differ in a bit."""
    keys = [("state", k) for k in b["state"]] + [("module", k) for k in b["module"]]
    assert a["state"].keys() == b["state"].keys() and a["module"].keys() == b["module"].keys()
    return [k for kind, k in keys
            if not np.array_equal(bits(torch.as_tensor(a[kind][k])),
                                  bits(torch.as_tensor(b[kind][k])))]


@pytest.mark.parametrize("model", C.LAYOUTS)
def test_checkpoint_restores_at_each_layout(model, runs):
    """The (data 2, model 4) file restored into a fresh model and state at
    (data 8 / model, model): every rank's shards of the parameters, both
    moments and the int8 residual are its cut of the file's whole leaves
    bit for bit, its module tensors the parameters' cut over ``model``, the
    step and the loader's step the file's; at the same layout they are the
    saved state bit for bit."""
    _, port = runs
    whole = file_leaves(Path(port[0]["ckpt"]["dir"]) / "ckpt" / f"step_{C.STEPS}")
    for p in port:
        snap = p["ckpt"][f"restored_{model}"]
        assert snap["shape"] == {"data": len(port) // model, "model": model}
        assert snap["step"] == C.STEPS and snap["extra"] == {"loader_step": C.STEPS}
        assert snap["state"]["step"] == C.STEPS
        for key, t in snap["state"].items():
            if key != "step":
                assert np.array_equal(bits(t), bits(cut(whole[key], snap, key))), key
        for name, t in snap["module"].items():
            assert np.array_equal(bits(t), bits(cut(whole[f"params/{name}"], snap,
                                                    f"params/{name}", axes=("model",)))), name
        if model == C.MODEL:
            assert not same_state(snap, p["ckpt"]["saved"])


def test_checkpoint_crcs_do_not_depend_on_the_layout(runs, tmp_path):
    """The same state saved from (data 2, model 4) and from (data 4, model
    2), and by one process's ``CheckpointManager`` as a whole state: the
    same leaf paths and the same CRC per leaf."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim.compress import CompressionState
    _, port = runs
    d = Path(port[0]["ckpt"]["dir"])
    want = manifest(d / "ckpt" / f"step_{C.STEPS}")
    got = manifest(d / "ckpt_m2" / f"step_{C.STEPS}")
    assert got["paths"] == want["paths"] and got["checksums"] == want["checksums"]
    flat = {k: torch.from_numpy(v) for k, v in file_leaves(d / "ckpt" / f"step_{C.STEPS}").items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    whole = {"params": sub("params/"), "opt": {"m": sub("opt/m/"), "v": sub("opt/v/")},
             "compress": CompressionState(error=sub("compress/error/")),
             "step": int(flat["step"])}
    CheckpointManager(str(tmp_path), async_save=False).save(C.STEPS, whole,
                                                            {"loader_step": C.STEPS})
    one = manifest(tmp_path / f"step_{C.STEPS}")
    assert one["paths"] == want["paths"] and one["checksums"] == want["checksums"]


def test_checkpoint_refuses_a_directory_the_ranks_do_not_share(runs):
    """Where only rank 0 sees the checkpoint (every other rank a directory
    of its own), the supervisor's decision to resume raises on every rank:
    each takes rank 0's list of steps and finds its own differs (a rank
    restoring alone would enter collectives the others never reach)."""
    _, port = runs
    for rank, p in enumerate(port):
        msg = p["ckpt"]["unshared"]
        assert msg is not None and "every rank must see rank 0's directory" in msg, (rank, msg)
        assert (f"rank {rank} lists the checkpoints []" in msg) == (rank != 0), (rank, msg)


def test_crash_and_resume_bit_for_bit(runs):
    """``train_lm`` under ``--ckpt`` on every rank, a checkpoint every 2
    steps, ``ft.crashing_step`` raising at call 3 after moving every
    parameter, both moments and the residual: the supervisor restores
    step 2 and the loader, and after step 4 every rank's shards of the
    parameters, both moments and the
    int8 residual, its module tensors and each step's loss equal the
    uninterrupted run's bit for bit; one ``TransientStep`` logged, the
    history steps 1..4."""
    _, port = runs
    for p in port:
        got, want = p["ckpt"]["resumed"], p["ckpt"]["uninterrupted"]
        assert got["failures"] == ["TransientStep"] and want["failures"] == []
        assert [h["step"] for h in got["history"]] == list(range(1, C.RUN_STEPS + 1))
        assert [h["loss"] for h in got["history"]] == [h["loss"] for h in want["history"]]
        assert got["end"]["state"]["step"] == C.RUN_STEPS
        assert not same_state(got["end"], want["end"])


def test_remesh_state_on_the_same_world_is_the_identity(runs):
    """``ft.remesh_state`` of the resumed state on the world it runs in
    keeps the mesh (data 2, model 4) and every rank's shards and module
    tensors bit for bit (the reference's
    ``test_elastic_remesh_same_devices``)."""
    _, port = runs
    for p in port:
        got = p["ckpt"]["remeshed"]
        assert got["shape"] == {"data": C.DATA, "model": C.MODEL}
        assert got["places"] == p["ckpt"]["resumed"]["end"]["places"]
        assert not same_state(got, p["ckpt"]["resumed"]["end"])


def test_remesh_keeps_the_reference_model_axis(runs):
    """The model axis the port's re-mesh keeps on 8 live ranks
    (``ft.remesh_model``) is the one the reference's ``remesh_state``
    keeps on 8 devices, for old meshes whose model axis divides them,
    does not (3, 5, 6) or exceeds them (16, 32)."""
    from repro_torch.ft import remesh_model
    ref, _ = runs
    kept = ref[C.CKPT_CASE]["remesh_kept"]
    assert [m for m, _ in kept] == list(C.REMESH_MODELS)
    assert [remesh_model(int(m), 8) for m, _ in kept] == [int(k) for _, k in kept]
    assert dict(kept)[16] == 8 and dict(kept)[3] == 1


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_trains_four_ranks_on_cpu(capfd):
    """``launch.train --model-parallel 4 --reduced --device cpu --steps 2``
    spawns 4 ranks (data 1, model 4) and rank 0 logs the reference's
    lines: the header with the mesh, then each step's loss, ce, zreg, zf
    and gnorm, equal on every rank."""
    from repro_torch.launch import train
    out = train.main(["--model-parallel", "4", "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "4", "--seq", "32"])
    text = capfd.readouterr().out
    assert "mesh={'data': 1, 'model': 4}" in text
    assert "step     1 loss=" in text and "step     2 loss=" in text and "gnorm=" in text
    assert text.count("step     1 loss=") == 1                 # rank 0 alone logs
    assert [r["model_index"] for r in out["ranks"]] == [0, 1, 2, 3]
    hist = [[(h["loss"], h["grad_norm"]) for h in r["history"]] for r in out["ranks"]]
    assert len(hist[0]) == 2 and all(h == hist[0] for h in hist)
    assert out["tp_per_step"]["bwd_calls"] > 0 and out["state_bytes"]["opt"] > 0


@pytest.mark.parametrize("argv,err", [
    (["--arch", "granite-moe-1b-a400m", "--model-parallel", "3"], NotImplementedError),
    (["--arch", "mamba2-2.7b", "--model-parallel", "16"], NotImplementedError),
    (["SERVE", "--requests", "2", "--arch", "mamba2-2.7b"], NotImplementedError),
    (["--arch", "granite-moe-1b-a400m", "--batch", "3", "DP"], ValueError),
    (["--batch", "3", "K2"], ValueError),
])
def test_cli_refuses_before_any_rank_starts(argv, err, monkeypatch):
    """What the sharded steps do not take raises in the parent, before
    anything is spawned: experts that do not split over the model ranks
    (8 over 3), SSD heads that do not while ``d_inner`` does (8 heads,
    ``d_inner`` 256 over 16), ``--requests`` under ``--model-parallel``
    for an architecture the continuous engine does not serve (``SERVE``:
    the serving CLI; mamba2's recurrent state), a batch that does not split over its
    ranks (``DP``: granite under the "dp" profile, the batch cut over all
    2 ranks; ``K2``: the config at ``grad_accum`` 2, over data x K; both
    through ``train_tensor_parallel`` as ``main`` calls it)."""
    from repro_torch.launch import mesh, serve, train
    monkeypatch.setattr(mesh, "spawn", lambda *a, **k: pytest.fail("a rank was spawned"))
    marks = {"K2": dict(grad_accum=2), "DP": dict(sharding_profile="dp")}
    fields = next((marks[a] for a in argv if a in marks), None)
    cli = serve if "SERVE" in argv else train
    argv = ["--model-parallel", "2", "--reduced", "--device", "cpu",
            *(a for a in argv if a not in marks and a != "SERVE")]
    with pytest.raises(err):
        if fields is not None:
            args = train.parse_args(argv)
            cfg = train.build_config(args.arch, reduced=True).replace(**fields)
            train.train_tensor_parallel(args, cfg)
        else:
            cli.main(argv)


# ---------------------------------------------------------------------------
# Cheap checks: no second world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_placements_match_train_state_specs(case):
    """The port's ``train_state_specs`` of a whole state equals the
    reference's for every leaf of the params, both moments and the int8
    residual, on a (data 2, model 4) mesh, and ``param_shardings`` gives
    the parameters' specs as placements."""
    from repro import configs as jconfigs, optim as joptim
    from repro.launch.steps import make_train_state_shape, train_state_specs as jspecs
    from repro.models.lm import LM as JLM
    from repro_torch import configs, optim
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    jcfg, cfg = C.config(case, jconfigs), C.config(case, configs)
    mode = C.compress_mode(case)
    shape, _ = make_train_state_shape(JLM(jcfg), joptim.adamw(joptim.warmup_cosine(*C.LR)),
                                      mode)
    model = LM(cfg, device="meta")
    want = _port_names(model, C.flat_specs(jspecs(shape, jcfg, StandIn())))
    state = steps.init_train_state(model, optim.adamw(optim.warmup_cosine(*C.LR)), mode)
    got = C.flat_specs(sharding.train_state_specs(state, cfg, StandIn()))
    assert got == want
    assert any(k.startswith("compress.") for k in got) == (mode == "int8")
    assert any("data" in v for v in got.values()) and any("model" in v for v in got.values())
    places = sharding.param_shardings(model, cfg, StandIn())
    for name, pl in places.items():
        assert pl == sharding.placements(sharding.Spec(*got[f"params.{name}"]), StandIn())


def _port_names(model, flat: dict) -> dict:
    """The reference's flattened spec paths in the port's layout: the
    residual without its ``error`` level, a run of one repeat with its
    ``.0``, a stacked run's leaf (its spec None on the stacking axis) one
    leaf a repeat."""
    out = {}
    for k, v in flat.items():
        k = k.replace("compress.error.", "compress.")
        keys = [k]
        for ri, (_, count) in enumerate(model.runs):
            if f".run{ri}." in k:
                keys = [k.replace(f".run{ri}.", f".run{ri}.{c}.") for c in range(count)]
                if count > 1:
                    assert v[0] is None, (k, v)
                    v = v[1:]
        out.update(dict.fromkeys(keys, v))
    return out


def test_microbatch_rows_interleave_the_global_batch():
    """At K 2 over 2 data ranks, data rank d's microbatch i is its rows of
    the reference's microbatch i; the ranks' rows together cover the batch
    once; a batch that does not split raises."""
    from repro_torch.launch.steps import data_rows
    r0, r1 = data_rows(8, 2, 2, 0), data_rows(8, 2, 2, 1)
    assert r0 == [0, 1, 4, 5] and r1 == [2, 3, 6, 7]
    for i in range(2):                    # microbatch i of the reference: rows 4i..4i+3
        assert sorted(r0[2 * i:2 * i + 2] + r1[2 * i:2 * i + 2]) == list(range(4 * i, 4 * i + 4))
    assert data_rows(8, 1, 1, 0) == list(range(8))
    with pytest.raises(ValueError, match="split"):
        data_rows(6, 2, 2, 0)


@pytest.mark.parametrize("scale", [1e-3, 20.0])
def test_int8_max_and_norm_over_hand_cut_shards(scale):
    """A gradient cut by hand into 2 x 2 shards: int8 compression with the
    shards' maxima reduced to the tensor's gives each shard's decoded
    values and residual of the whole tensor's bit for bit, over two steps;
    the norm with each element counted once (a replicated leaf on its first
    rank only) equals the whole one's."""
    from repro_torch.optim import compress
    from repro_torch.optim.optimizers import sharded_global_norm
    from repro_torch.utils import global_norm
    rng = np.random.default_rng(7)
    whole = compress.init_state({"w": torch.zeros(8, 6), "n": torch.zeros(6)}, "int8")
    parts = [compress.init_state({"w": torch.zeros(4, 3), "n": torch.zeros(6)}, "int8")
             for _ in range(4)]

    def cut(t, r):
        return t[(r // 2) * 4:(r // 2 + 1) * 4, (r % 2) * 3:(r % 2 + 1) * 3].clone()
    for step in range(2):
        g = {"w": torch.from_numpy((rng.normal(size=(8, 6)) * scale).astype(np.float32)),
             "n": torch.from_numpy((rng.normal(size=6) * scale).astype(np.float32))}
        want, whole = compress.compressed_gradients({k: v.clone() for k, v in g.items()},
                                                    whole, "int8")
        maxima = [{"w": (cut(g["w"], r) + parts[r].error["w"]).abs().amax(),
                   "n": (g["n"] + parts[r].error["n"]).abs().amax()} for r in range(4)]

        def global_max(amax):
            return {k: torch.stack([m[k] for m in maxima]).amax() for k in amax}
        got = []
        for r in range(4):
            dec, parts[r] = compress.compressed_gradients(
                {"w": cut(g["w"], r), "n": g["n"].clone()}, parts[r], "int8",
                global_max=global_max)
            got.append(dec)
            assert np.array_equal(bits(dec["w"]), bits(cut(want["w"], r)))
            assert np.array_equal(bits(dec["n"]), bits(want["n"]))
            assert np.array_equal(bits(parts[r].error["w"]), bits(cut(whole.error["w"], r)))
        sq = [sharded_global_norm(got[r], {"w"} | ({"n"} if r == 0 else set()),
                                  lambda t: t) for r in range(4)]
        total = torch.sqrt(sum(s.square() for s in sq))
        np.testing.assert_allclose(float(total), float(global_norm(want.values())), rtol=1e-6)


@pytest.fixture
def one_rank_group():
    """A 1-rank gloo group in this process, torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()


def test_autograd_collectives_on_one_rank(one_rank_group):
    """Each autograd collective against its whole-tensor form on a 1-rank
    group: the sum and the gather are the identity forward, the copy too;
    their backwards are the identity, this rank's slice (the whole) and
    the sum over the group (the gradient itself), each counted in
    ``TP_TRAFFIC``."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.collectives import TP_TRAFFIC
    axis = ctx.CommAxis("model", 1, one_rank_group, 0)
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    g = torch.randn(3, 4, dtype=torch.float64)
    before = dict(TP_TRAFFIC)
    for fn in (lambda t: ctx._SumModel.apply(t, axis),
               lambda t: ctx._GatherModel.apply(t, axis, 1),
               lambda t: ctx._CopyModel.apply(t, axis)):
        y = fn(x)
        assert torch.equal(y, x)
        (dx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(dx, g)
    assert TP_TRAFFIC["calls"] - before["calls"] == 2          # the sum and the gather
    assert TP_TRAFFIC["bwd_calls"] - before["bwd_calls"] == 1  # the copy's backward
    assert TP_TRAFFIC["bwd_bytes"] - before["bwd_bytes"] == g.numel() * g.element_size()
    assert torch.autograd.gradcheck(lambda t: ctx._CopyModel.apply(t, axis), (x,))


@pytest.mark.parametrize("remat", ["block", "save_acts"])
def test_recompute_runs_in_the_forwards_context(remat):
    """A remat unit's recompute sees the context variables of its forward
    (``distributed.ctx``'s mesh and layout among them) when the backward
    runs on another thread, as autograd runs it on the card: here a
    thread started without them."""
    import contextvars
    import threading
    from repro_torch.models.lm.remat import run_unit
    probe = contextvars.ContextVar("probe", default=None)
    seen = []

    def unit(x):
        seen.append(probe.get())
        return (x * 2).sin()
    x = torch.randn(4, requires_grad=True)
    tok = probe.set("the forward's")
    try:
        y = run_unit(unit, remat, x).sum()
    finally:
        probe.reset(tok)
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == ["the forward's"] * 2
    assert torch.allclose(x.grad, 2 * torch.cos(2 * x.detach()))


def test_streaming_loader_splits_by_host_as_the_reference():
    """``StreamingLoader(host_id=, n_hosts=)`` draws each host's rows from
    the counter ``step · n_hosts + host_id`` as the reference's does, step
    after step and across a restore."""
    from repro.data import StreamingLoader as JLoader
    from repro_torch.data import LMDatasetConfig, StreamingLoader, lm_batch
    ds = LMDatasetConfig(vocab=512)

    def make(b, s):
        return lm_batch(ds, b, 16, s)
    for host in range(2):
        ours, ref = StreamingLoader(make, 8, host_id=host, n_hosts=2), JLoader(make, 8, host,
                                                                                2)
        for _ in range(3):
            assert np.array_equal(next(ours), next(ref))
        ours.restore(7)
        ref.restore(7)
        assert np.array_equal(next(ours), next(ref)) and ours.state() == ref.state() == 8
    with pytest.raises(ValueError, match="split"):
        StreamingLoader(make, 7, n_hosts=2)
