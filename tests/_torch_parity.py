"""Shared helper of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np
import torch


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
