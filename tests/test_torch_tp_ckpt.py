"""``launch.train --model-parallel N --ckpt DIR`` on the CPU: the sharded
train state checkpointed as whole leaves and resumed where the last run
stopped (``checkpoint.sharded``). Each run spawns its 2 ranks (~10 s a
run). The checkpoints against the reference's, the restore at other
layouts, a crash and resume and ``remesh_state`` run in the shared 8-rank
world of ``tests/test_torch_tp_train.py``."""
import json

import numpy as np

ARGV = ["--model-parallel", "2", "--reduced", "--device", "cpu", "--batch", "4", "--seq",
        "32"]


def test_cli_resumes_a_sharded_run_bit_for_bit(tmp_path, capfd, monkeypatch):
    """``--steps 2 --ckpt-every 1`` writes ``step_1`` and ``step_2``, each
    one ``shard_0.npz`` of whole leaves with a manifest carrying a CRC per
    leaf; the same with ``--steps 4`` resumes at step 2 (the loader at
    2) and ends with the state of an uninterrupted 4-step run: the same
    leaves and CRCs in their ``step_4`` checkpoints, bit for bit, and the
    same losses at steps 3 and 4 on both ranks. The ranks take one thread
    each (``OMP_NUM_THREADS``): a loaded host's threaded sums can part two
    runs in the last bit."""
    from repro_torch.launch import train
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run, whole = str(tmp_path / "run"), str(tmp_path / "whole")
    train.main([*ARGV, "--steps", "2", "--ckpt", run, "--ckpt-every", "1"])
    man = json.loads((tmp_path / "run" / "step_2" / "manifest.json").read_text())
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "heartbeat.json", "step_1", "step_2"]
    assert sorted(p.name for p in (tmp_path / "run" / "step_2").iterdir()) == [
        "manifest.json", "shard_0.npz"]
    assert set(man["checksums"]) == set(man["paths"]) and man["extra"] == {"loader_step": 2}
    assert {k.split("/")[0] for k in man["paths"]} == {"params", "opt", "step"}
    capfd.readouterr()
    resumed = train.main([*ARGV, "--steps", "4", "--ckpt", run, "--ckpt-every", "1"])
    assert f"[train] resumed at step 2 from {run}" in capfd.readouterr().out
    ref = train.main([*ARGV, "--steps", "4", "--ckpt", whole, "--ckpt-every", "4"])
    got, want = (json.loads((tmp_path / d / "step_4" / "manifest.json").read_text())
                 for d in ("run", "whole"))
    assert got["checksums"] == want["checksums"] and got["extra"] == {"loader_step": 4}
    with np.load(tmp_path / "run" / "step_4" / "shard_0.npz") as a, \
            np.load(tmp_path / "whole" / "step_4" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    for r, w in zip(resumed["ranks"], ref["ranks"]):
        assert [h["step"] for h in r["history"]] == [3, 4]
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in w["history"][2:]]
