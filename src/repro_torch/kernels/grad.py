"""Training semantics for the Zebra kernels (``repro.kernels.grad``).

The train-time gate has to match the deployed masking exactly, so a kernel
backend trains through the same kernel launches it serves with:
``ZebraKernelTrainable`` is a ``torch.autograd.Function`` whose forward is
``launch_forward`` (``zebra_mask`` for the ``pallas`` backend, the
``zebra_mask_pack -> zebra_unpack`` stream pair for ``stream``) and whose
backward implements the constant-threshold gradient modes of
``core.zebra._apply_gate``:

``hard``  (paper)  dx = g · broadcast(bitmap): only surviving blocks carry
                   the task gradient.
``ste``            dx = g: straight-through identity, so pruned blocks can
                   recover.
``soft``           dx = g · broadcast(sigmoid((blockmax − T_obj)/τ)): the
                   backward is rescaled by the sigmoid surrogate while the
                   value stays the deployed hard mask.

The backward is plain PyTorch, as the reference computes it in jnp outside
any Pallas kernel. Sites with a threshold net are not kernel-trainable:
the engine resolves them to ``reference`` (``core.backends``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .mask_pack import mask_pack_with_slots
from .pack import unpack_with_slots
from .ref import threshold_as
from .zebra_mask import zebra_mask


class KernelStatics(NamedTuple):
    """Static config of one trainable kernel launch. ``variant`` picks the
    forward: ``"mask"`` (one masking launch, dense masked map out) or
    ``"stream"`` (comparator and pack, then the expander, with only the
    compressed stream in between)."""
    variant: str
    t_obj: float
    bs: int
    bc: int
    grad_mode: str
    soft_temp: float


def _expand2d(blocks: torch.Tensor, bs: int, bc: int) -> torch.Tensor:
    """(Mb, Kb) per-block values -> (M, K) elementwise broadcast."""
    return blocks.repeat_interleave(bs, 0).repeat_interleave(bc, 1)


def _mask_forward(x2: torch.Tensor, s: KernelStatics):
    y2, bitmap = zebra_mask(x2, t_obj=s.t_obj, bs=s.bs, bc=s.bc)
    return y2, bitmap, torch.zeros((), dtype=torch.int32, device=x2.device)


def _stream_forward(x2: torch.Tensor, s: KernelStatics):
    payload, bitmap, n_live, keep, slot = mask_pack_with_slots(
        x2, t_obj=s.t_obj, bs=s.bs, bc=s.bc)
    y2 = unpack_with_slots(payload, bitmap, keep, slot, bs=s.bs, bc=s.bc)
    return y2, bitmap, n_live


_FORWARD_VARIANTS = {"mask": _mask_forward, "stream": _stream_forward}


def launch_forward(x2: torch.Tensor, s: KernelStatics):
    """The one forward kernel pipeline of train (the Function's forward)
    and infer (engine dispatch), so the two cannot drift apart. Returns
    ``(y2, bitmap int8, n_live int32)``; n_live is 0 for the mask variant."""
    try:
        fwd = _FORWARD_VARIANTS[s.variant]
    except KeyError:
        raise ValueError(f"unknown trainable kernel variant {s.variant!r}; "
                         f"expected one of {tuple(_FORWARD_VARIANTS)}") from None
    return fwd(x2, s)


class ZebraKernelTrainable(torch.autograd.Function):
    """Kernel-launched Zebra site with training semantics: x2 (M, K) ->
    (masked y2, keep bitmap int8, n_live int32). The bitmap and n_live are
    observables without gradient."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, statics: KernelStatics):
        y2, bitmap, n_live = launch_forward(x2, statics)
        ctx.statics = statics
        if statics.grad_mode == "soft":
            ctx.save_for_backward(x2)       # blockmax is recomputed
        elif statics.grad_mode != "ste":    # hard, the paper's default
            ctx.save_for_backward(bitmap)
        ctx.mark_non_differentiable(bitmap, n_live)
        return y2, bitmap, n_live

    @staticmethod
    def backward(ctx, gy, _gbitmap, _gn_live):
        s = ctx.statics
        if s.grad_mode == "ste":
            return gy, None
        (res,) = ctx.saved_tensors
        if s.grad_mode == "soft":
            M, K = res.shape
            blockmax = res.reshape(M // s.bs, s.bs, K // s.bc, s.bc).abs().amax(dim=(1, 3))
            thr = threshold_as(s.t_obj, blockmax.dtype)
            gate = torch.sigmoid((blockmax - thr) / s.soft_temp)
            return gy * _expand2d(gate, s.bs, s.bc).to(gy.dtype), None
        return gy * _expand2d(res, s.bs, s.bc).to(gy.dtype), None


def zebra_kernel_trainable(x2: torch.Tensor, statics: KernelStatics):
    """``ZebraKernelTrainable.apply``: the forward launches the kernels,
    autograd takes the ``statics.grad_mode`` backward."""
    return ZebraKernelTrainable.apply(x2, statics)
