"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture
def one_thread():
    """One intra-op thread for a bitwise comparison of two CPU runs: the
    float32 GEMMs may split their sums by the number of threads they get,
    which varies with the machine's load, so two runs of the same step can
    differ in the last bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_lm_params(cfg, seed: int):
    import jax

    from repro.models.lm import LM
    return jax.jit(LM(cfg).init)(jax.random.PRNGKey(seed))


def jax_lm_params(cfg, seed: int = 0):
    """The reference's ``jax.jit(LM(cfg).init)(PRNGKey(seed))``, drawn once
    a process for every config that differs from another only where no
    parameter does (the compute dtype, the CE chunk, the site backend, the
    remat policy): one init compile instead of one a case."""
    return _jax_lm_params(cfg.replace(compute_dtype="float32", ce_chunk=0,
                                      zebra_backend="reference", remat="none"), seed)


def bits(a) -> np.ndarray:
    """Raw bit patterns of a torch tensor or a JAX/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.is_floating_point():
            return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.kind in "fV" or a.dtype.name == "bfloat16":
        return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])
    return a


def jax_cnn_variables(model) -> dict:
    """The reference's ``{"params", "state", "zebra"}`` tree of a port CNN's
    tensors (the dense weight ``fc.w`` transposed back to (in, out))."""
    tree = {"params": {}, "state": {}, "zebra": {}}
    for key, t in model.state_dict().items():
        parts = key.split(".")
        if parts[0] == "zebra":
            root, parts = "zebra", parts[1:]
        else:
            root = "state" if parts[-1] in ("mean", "var") else "params"
        node = tree[root]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(t.numpy().T if key == "fc.w" else t.numpy())
    return tree
