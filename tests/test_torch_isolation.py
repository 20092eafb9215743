"""The port stands alone: it imports neither ``jax`` nor ``repro``, it
imports with ``jax`` blocked, its entry points refuse to fall back to the
CPU when no ``device`` is given, and a kernel's GPU branch never falls back
to the plain version."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build, mask_pack, pack, spmm_cs, zebra_mask, zebra_spmm

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists()
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.train, repro_torch.kernels, repro_torch.models.cnn.convert\n"
            "import repro_torch.models.lm.convert, repro_torch.compress, repro_torch.serve\n"
            "import repro_torch.launch.serve, repro_torch.configs, repro_torch.ft\n"
            "import repro_torch.compress.integrity, repro_torch.optim.compress\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.checkpoint, repro_torch.ft.supervisor\n"
            "import repro_torch.models.lm.remat\n"
            "from repro_torch import configs\n"
            "for a in configs.ARCHS:\n"
            "    configs.get(a)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_trainer_without_device_needs_cuda():
    from repro_torch.train import CNNTrainConfig, CNNTrainer
    cfg = CNNTrainConfig(width_mult=0.125)
    if torch.cuda.is_available():
        assert CNNTrainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CNNTrainer(cfg)


def test_serve_without_device_needs_cuda():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


def test_lm_trainer_without_device_needs_cuda():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])


@pytest.fixture
def one_thread():
    """This process's torch on one thread for the test: on a loaded host a
    threaded run of the reduced trainer took 40 s where one thread takes
    1 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_trainer_cli_runs_on_cpu(capfd, tmp_path, monkeypatch, one_thread):
    """``--device cpu --reduced --steps 2`` trains and logs as the reference
    does; with ``--ckpt`` a second run resumes from the first's checkpoint;
    under ``--model-parallel 2`` a third resumes from the same one-process
    checkpoint (whole leaves: the format does not depend on the layout)
    and writes the next step in it."""
    from repro_torch.launch import train
    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                      "--seq", "32", "--backend", "pallas"])
    text = capfd.readouterr().out
    assert "step     1 loss=" in text and "step     2 loss=" in text
    assert out["state"]["step"] == 2 and len(out["history"]) == 2
    assert all(torch.isfinite(torch.tensor(m["loss"])) for m in out["history"])
    ckpt = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt",
            str(tmp_path), "--ckpt-every", "1"]
    train.main([*ckpt, "--steps", "2"])
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_1", "step_2"]
    out = train.main([*ckpt, "--steps", "3"])
    assert [m["step"] for m in out["history"]] == [3] and out["state"]["step"] == 3
    assert f"checkpoints in {tmp_path}" in capfd.readouterr().out
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the spawned ranks: one thread each
    out = train.main([*ckpt, "--steps", "4", "--model-parallel", "2"])
    assert f"[train] resumed at step 3 from {tmp_path}" in capfd.readouterr().out
    assert all([m["step"] for m in r["history"]] == [4] for r in out["ranks"])
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_2", "step_3", "step_4"]


@pytest.mark.parametrize("launch", ["bitmap", "pack", "unpack", "mask", "zebra_pack",
                                    "spmm", "spmm_cs"])
def test_gpu_branch_raises_without_cuda(launch):
    """The CUDA branch of each wrapper, handed a tensor off the card,
    raises instead of running the plain version."""
    x = torch.ones(16, 16)
    bitmap = torch.ones(2, 2, dtype=torch.int8)
    slot = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if launch == "bitmap":
            mask_pack.bitmap_cuda(x, 0.5, 8, 8)
        elif launch == "pack":
            mask_pack.pack_cuda(x, bitmap, slot, torch.tensor(4, dtype=torch.int32), 8, 8)
        elif launch == "mask":
            zebra_mask.mask_cuda(x, 0.5, 8, 8)
        elif launch == "zebra_pack":
            pack.zebra_pack(x.to("meta"), bitmap.to("meta"), bs=8, bc=8)
        elif launch == "spmm":
            zebra_spmm.spmm_cuda(x, x, bitmap, 8, 8)
        elif launch == "spmm_cs":
            spmm_cs.spmm_cs_cuda(x.reshape(4, 8, 8), x, bitmap, slot, 8, 8)
        else:
            pack.unpack_cuda(x.reshape(4, 8, 8), bitmap, slot, 8, 8)


def test_wrapper_on_other_device_raises():
    with pytest.raises(ValueError, match="CUDA tensor"):
        mask_pack.zebra_mask_pack(torch.ones(16, 16, device="meta"), t_obj=0.5, bs=8, bc=8)


def test_mask_wrapper_on_other_device_raises():
    with pytest.raises(ValueError, match="CUDA tensor"):
        zebra_mask.zebra_mask(torch.ones(16, 16, device="meta"), t_obj=0.5, bs=8, bc=8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
