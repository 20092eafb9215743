"""The port's compressed collectives (``repro_torch.distributed.collectives``)
and the layer hooks that use them, against the reference's, on the CPU.

One module fixture runs both sides at once: the reference under
``shard_map`` on 8 forced host devices, in one JAX subprocess that writes
its outputs to an ``.npz``, and the port as an 8-rank ``gloo`` world
spawned with ``torch.multiprocessing`` (``launch.mesh.spawn``), each rank
saving its own. Both use the reference bench's mesh, (data 2, model 4),
and the inputs of ``tests/_torch_collectives_cases.py``, drawn from numpy
seeds.

Exact: every gathered map and every psum and reduce-scatter result, bit
for bit against the reference (the psum on generic float32 too: the port
sums in the reference's ring order) and by value against the port's own
dense collective (a rebuilt dead block is +0 where the input held -0.0, as
in the reference), each rank's ``LinkBytes``, the exact byte sum
past 2**31, the layer exchanges' maps and aux (labels, bytes, zero
fractions), the data-parallel MoE's bytes, zero-block count and block
count, the ring faults' detections and recoveries, and
``BENCH_collectives.json``'s 12 byte rows. allclose: the MoE's output
(rtol/atol 1e-5, ``tests/test_torch_moe.py``'s float32 tolerance) and its
``router_aux`` (rtol 1e-6). The fixture takes ~25 s, the JAX subprocess
most of it.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_collectives_cases as C
from _torch_parity import bits

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
RANKS = range(8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, the port's 8 rank outputs)."""
    from repro_torch.launch.mesh import spawn
    d = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_collectives_cases as C; "
         "C.reference_main(sys.argv[1])", str(d / "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        spawn(C.port_rank, 8, (str(d),), device="cpu")
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    r = dict(np.load(d / "ref.npz"))
    r["labels"] = ast.literal_eval(str(r["labels"]))
    return r, [torch.load(d / f"rank{i}.pt") for i in RANKS]


def same(a, b) -> bool:
    return np.array_equal(bits(a), bits(b))


def equal(a, b) -> bool:
    """Equal by value: a dense collective keeps a dead block's -0.0, the
    rebuild writes +0 (as the reference's does)."""
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_ranks_lay_out_as_the_reference_mesh(runs):
    _, port = runs
    for rank, p in enumerate(port):
        assert (p["data_index"], p["model_index"]) == divmod(rank, 4)
        assert p["wire"] == "gloo (host copies)"


@pytest.mark.parametrize("tag", [c[0] for c in C.AG_CASES])
def test_all_gather_matches_reference(runs, tag):
    ref, port = runs
    zf, dead = {c[0]: c[1:] for c in C.AG_CASES}[tag]
    sh = C.ag_shards(zf, dead)
    pred = [sum(C._stream(C.live_blocks(sh[s]), C.M, C.K) for s in range(4) if s != i)
            for i in range(4)]
    for rank, p in enumerate(port):
        m = p["model_index"]
        assert same(p[f"ag_{tag}_y"], ref[f"ag_{tag}_y"][rank])
        assert equal(p[f"ag_{tag}_y"], p[f"ag_{tag}_dense_gather"])
        assert equal(p[f"ag_{tag}_y"], sh.reshape(4 * C.M, C.K))
        assert p[f"ag_{tag}_moved"] == int(ref[f"ag_{tag}_moved"][rank]) == pred[m]
        assert p[f"ag_{tag}_dense"] == int(ref[f"ag_{tag}_dense"][rank]) == 3 * C.M * C.K * 4


@pytest.mark.parametrize("tag", [c[0] for c in C.AG_CASES])
def test_ring_sends_only_the_live_prefix(runs, tag):
    """The payload bytes a rank takes from the ring are its link's moved
    bytes less the three packed indices; over the ring the sent bytes
    match the received."""
    _, port = runs
    index = 3 * (((C.M // C.BS) * (C.K // C.BC) + 7) // 8)
    for p in port:
        assert p[f"ag_{tag}_received"] == p[f"ag_{tag}_moved"] - index
    for d in (0, 1):
        group = port[4 * d:4 * d + 4]
        assert sum(p[f"ag_{tag}_sent"] for p in group) == \
            sum(p[f"ag_{tag}_received"] for p in group)


@pytest.mark.parametrize("kind", C.PSUM_CASES)
def test_psum_stream_matches_reference(runs, kind):
    ref, port = runs
    sh = C.psum_shards(kind)
    union = (np.abs(sh).reshape(4, C.M // C.BS, C.BS, C.K // C.BC, C.BC).max((2, 4))
             > 0).any(0)
    for rank, p in enumerate(port):
        assert same(p[f"ps_{kind}_y"], ref[f"ps_{kind}_y"][rank])
        assert same(p[f"ps_{kind}_union"], ref[f"ps_{kind}_union"][rank])
        assert p[f"ps_{kind}_moved"] == int(ref[f"ps_{kind}_moved"][rank]) \
            == 3 * C._stream(int(union.sum()), C.M, C.K)
        assert p[f"ps_{kind}_dense"] == int(ref[f"ps_{kind}_dense"][rank])
        if kind == "int":                       # exact sums: any order agrees
            assert equal(p[f"ps_{kind}_y"], p[f"ps_{kind}_all_reduce"])
        else:
            np.testing.assert_allclose(p[f"ps_{kind}_y"], p[f"ps_{kind}_all_reduce"],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", C.PSUM_CASES)
def test_reduce_scatter_matches_reference(runs, kind):
    ref, port = runs
    for rank, p in enumerate(port):
        assert same(p[f"rs_{kind}_y"], ref[f"rs_{kind}_y"][rank])
        assert p[f"rs_{kind}_moved"] == int(ref[f"rs_{kind}_moved"][rank])
        assert p[f"rs_{kind}_dense"] == int(ref[f"rs_{kind}_dense"][rank])
        if kind == "int":
            assert equal(p[f"rs_{kind}_y"], p[f"rs_{kind}_dense_rs"])


def test_psum_exact_bytes_past_2_31(runs):
    ref, port = runs
    for p in port:
        assert p["bytes_total"] == int(ref["bytes_total"]) == int(C.BYTES.sum()) > 2 ** 31


@pytest.mark.parametrize("backend", ["stream", "reference"])
def test_ffn_layer_out_exchange_matches_reference(runs, backend):
    """The compressed exchange on ``stream``; on ``reference`` the dense
    all-gather with the degrade on the label."""
    ref, port = runs
    want = {"stream": "stream",
            "reference": "reference+dense-comms(comms-capability)"}[backend]
    assert ref["labels"][f"ffn_{backend}"] == want
    for rank, p in enumerate(port):
        assert p[f"ffn_{backend}_label"] == want
        if backend == "stream":
            assert same(p["ffn_stream_y"], ref["ffn_stream_y"][rank])
        else:
            # XLA compiles the reference masking's x * mask into a select,
            # which writes +0 where the port's product keeps -0.0
            assert equal(p["ffn_reference_y"], ref["ffn_reference_y"][rank])
        for f in ("ici", "ici_dense", "measured"):
            assert p[f"ffn_{backend}_{f}"] == int(ref[f"ffn_{backend}_{f}"][rank]), f
        assert same(p[f"ffn_{backend}_zf"], ref[f"ffn_{backend}_zf"][rank])
    p = port[0]
    if backend == "stream":
        assert 0 < p["ffn_stream_ici"] < p["ffn_stream_ici_dense"]
    else:
        assert p["ffn_reference_ici"] == p["ffn_reference_ici_dense"]


def test_gather_kv_shards_matches_reference(runs):
    ref, port = runs
    assert ref["labels"]["kv"] == "stream"
    for rank, p in enumerate(port):
        assert p["kv_label"] == "stream"
        assert same(p["kv_k"], ref["kv_k"][rank]) and same(p["kv_v"], ref["kv_v"][rank])
        for t in "kv":
            for f in ("ici", "ici_dense", "measured"):
                assert p[f"kv_{t}_{f}"] == int(ref[f"kv_{t}_{f}"][rank]), (t, f)
            assert same(p[f"kv_{t}_zf"], ref[f"kv_{t}_zf"][rank])
    assert 0.3 < float(port[0]["kv_k_zf"]) < 0.9


def test_ffn_apply_exchanges_its_output(runs):
    """Under a comm context ``ffn_apply`` returns the gathered sequence,
    its exchange's output, with the two sites' aux merged."""
    _, port = runs
    for p in port:
        assert p["ffn_apply_equal"] and p["ffn_apply_shape"] == (C.EX_B, 4 * C.EX_S, 128)
        assert p["ffn_apply_label"] == "stream+stream"
        assert p["ffn_apply_bytes"] == p["ffn_apply_bytes_want"]
        assert p["ffn_apply_ici"] == p["ffn_apply_ici_want"]


def test_moe_apply_dp_matches_reference(runs):
    ref, port = runs
    for rank, p in enumerate(port):
        np.testing.assert_allclose(p["moe_y"].numpy(), ref["moe_y"][rank], rtol=1e-5,
                                   atol=1e-5)
        assert p["moe_bytes"] == int(ref["moe_bytes"]) > 0
        assert same(p["moe_zf_blocks"], ref["moe_zf_blocks"])
        assert same(p["moe_n_blocks"], ref["moe_n_blocks"])
        assert same(p["moe_reg"], ref["moe_reg"])
        np.testing.assert_allclose(float(p["moe_router_aux"]), float(ref["moe_router_aux"]),
                                   rtol=1e-6)


def test_dp_moe_forward_equals_single_process_rows(runs):
    """The "dp" profile under ``sharding_hints``: each rank's logits equal
    a single-process forward of its row bit for bit (the capacity is per
    shard), and the summed bytes equal the sum over the ranks."""
    _, port = runs
    assert all(p["lm_logits_equal"] for p in port)
    total = sum(p["lm_bytes_1"] for p in port)
    assert all(p["lm_bytes_dp"] == total for p in port) and total > 0
    zfb = sum(float(p["lm_zf_blocks_1"]) for p in port) / 8
    np.testing.assert_allclose(float(port[0]["lm_zf_blocks_dp"]), zfb, rtol=1e-6)


@pytest.mark.parametrize("name", [f[0] for f in C.FAULTS])
def test_ring_fault_detected_and_recovered(runs, name):
    """``BENCH_faults.json``'s ``detect.ring.*`` rows: one drop injected,
    detected once a rank (the reference's callback fires once a device),
    recovered by the dense retry, whose bytes the link adds; a clean run
    at the same level detects nothing."""
    ref, port = runs
    record = {r["name"]: r for r in json.loads((ROOT / "BENCH_faults.json").read_text())
              ["rows"]}[f"faults/detect.ring.{name}"]
    assert (record["injected"], record["detected"], record["recovered"]) == (1, 1, 1)
    assert int(ref[f"fault_{name}_injected"]) == 1 and int(ref[f"fault_{name}_detected"]) >= 1
    psum = name.startswith("psum")
    for rank, p in enumerate(port):
        assert p[f"fault_{name}_injected"] == 1 and p[f"fault_{name}_detected"] == 1
        assert p[f"clean_{name}_detected"] == 0 and p[f"clean_{name}_equal"]
        assert p[f"fault_{name}_moved"] == int(ref[f"fault_{name}_moved"][rank])
        dense = p["fault_dense_psum" if psum else "fault_dense_gather"]
        assert equal(p[f"fault_{name}_y"], dense)
        if psum:     # the retry's all-reduce and XLA's psum may sum in other orders
            np.testing.assert_allclose(p[f"fault_{name}_y"], ref[f"fault_{name}_y"][rank],
                                       rtol=1e-6, atol=1e-6)
        else:
            assert same(p[f"fault_{name}_y"], ref[f"fault_{name}_y"][rank])


@pytest.mark.parametrize("axis", ["model", "data"])
def test_bench_collectives_byte_rows(runs, axis):
    """The 12 byte rows of ``BENCH_collectives.json``: the compressed rows'
    ``ici_bytes`` and ``ici_dense_bytes`` (each the sum over the axis's
    inbound links), and the dense rows' bytes, which are the compressed
    rows' dense baseline; every compressed result equals its dense
    counterpart by value."""
    _, port = runs
    rows = {r["name"]: r for r in json.loads((ROOT / "BENCH_collectives.json").read_text())
            ["rows"]}
    for op in ("all_gather", "psum_stream", "reduce_scatter"):
        comp = rows[f"collectives/{op}.{axis}.compressed"]
        dense = rows[f"collectives/{op}.{axis}.dense"]
        for p in port:
            moved, dense_b = p[f"bench_{op}_{axis}"]
            assert moved == comp["ici_bytes"] == comp["ici_predicted_bytes"]
            assert dense_b == comp["ici_dense_bytes"] == dense["ici_bytes"]
    assert all(all(p[f"bench_equal_{axis}"]) for p in port)
