"""CNN training loop — the port of ``repro.train.cnn_trainer``, the paper's
experimental pipeline (§III).

Loss assembly (paper Eq. 1 + partner methods):
    L = λ·CE + Σ_{l,c} ||T_obj − T_{l,c}||²  (+ ρ_NS·Σ|γ|  during NS
    sparsity-training)  with WP / NS masks held fixed during retrain.

``CNNTrainer.evaluate`` is the paper's measurement: accuracy, the
zero-block fraction, Eq. 2-5 reduced bandwidth and the bytes the stream
backend actually moved.

State is plain tensors: ``variables`` is the model's state dict (parameters,
BatchNorm buffers, threshold nets), applied with
``torch.func.functional_call`` so a call never changes the module; the
trainer state is ``{"variables", "opt", "step"}`` with ``step`` a Python int.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from ..core import (LayerAux, ZebraConfig, collect_zebra_loss, mean_zero_frac,
                    reduced_bandwidth_pct, slimming, weight_pruning)
from ..data import ImageDatasetConfig, StreamingLoader, image_batch
from ..models.cnn import build as build_cnn
from ..models.cnn.common import accuracy, cross_entropy, topk_accuracy
from ..optim import Optimizer, apply_updates, clip_by_global_norm
from ..utils import resolve_device

ZEBRA_PREFIX = "zebra."         # threshold nets: trainable, not model params


def _sum_bytes(auxes) -> LayerAux:
    """Exact cross-site accumulation (int64 bytes)."""
    acc = LayerAux.of_site(auxes[0])
    for a in auxes[1:]:
        acc = acc + LayerAux.of_site(a)
    return acc


@dataclasses.dataclass(frozen=True)
class CNNTrainConfig:
    model: str = "resnet18"
    width_mult: float = 1.0
    dataset: ImageDatasetConfig = ImageDatasetConfig()
    batch: int = 64
    steps: int = 300
    zebra: ZebraConfig = ZebraConfig()
    ns_rho: float = 0.0            # BN-γ L1 weight (NS sparsity training)
    grad_clip: float = 10.0
    seed: int = 0


class CNNTrainer:
    """Holds the model (an ``nn.Module`` on ``device``) and the optimizer.
    ``optimizer`` may be None for a trainer that only evaluates."""

    def __init__(self, cfg: CNNTrainConfig, optimizer: Optimizer | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 end to end on the card: cuDNN convolutions default to
            # TF32 (about three decimal digits), which would put the logits
            # far outside the reference's float32 tolerance
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = build_cnn(cfg.model, cfg.dataset.num_classes, cfg.dataset.hw,
                               cfg.width_mult, use_tnet=cfg.zebra.use_tnet,
                               generator=gen).to(self.device).eval()
        self.opt = optimizer
        self.trainable_names = [k for k, _ in self.model.named_parameters()]
        self.wp_masks = None       # magnitude weight-pruning masks (fixed)
        self.ns_masks = None       # network-slimming channel masks (fixed)

    # ------------------------------------------------------------------
    def init_state(self) -> dict:
        """Fresh variables (random weights from ``cfg.seed``), the
        optimizer's state for them, and step 0."""
        variables = {k: v.clone() for k, v in self.model.state_dict().items()}
        opt = self.opt.init(self._trainable(variables)) if self.opt else None
        return {"variables": variables, "opt": opt, "step": 0}

    def _trainable(self, variables) -> dict:
        """Model parameters and threshold nets (not the BN statistics)."""
        return {k: variables[k] for k in self.trainable_names}

    @staticmethod
    def _params(trainable) -> dict:
        """The model's parameters without the threshold nets (what the
        partner methods read: the reference's ``params`` tree)."""
        return {k: v for k, v in trainable.items() if not k.startswith(ZEBRA_PREFIX)}

    # ------------------------------------------------------------------
    def _loss_fn(self, trainable, state_bn, images, labels):
        """Train-mode loss: ``(loss, (new BN statistics, metrics, site auxes))``."""
        zcfg = self.cfg.zebra.replace(mode="train")
        logits, new_bn, auxes = functional_call(
            self.model, {**trainable, **state_bn}, (images, zcfg, True))
        ce = cross_entropy(logits, labels)
        zreg = collect_zebra_loss(auxes)
        # with use_tnet=False the reg slot is the realised zero-block count
        # (an observable without gradient): Eq. 1's trainable term is zero,
        # so it stays out of the loss
        loss = self.cfg.zebra.lambda_ce * ce + (zreg if self.cfg.zebra.use_tnet else 0.0)
        if self.cfg.ns_rho > 0:
            loss = loss + self.cfg.ns_rho * slimming.gamma_l1(self._params(trainable))
        metrics = {"ce": ce, "zebra_reg": zreg, "acc": accuracy(logits, labels),
                   "zero_frac": mean_zero_frac(auxes),
                   # nonzero when training through the stream backend
                   "measured_bytes": _sum_bytes(auxes).measured_bytes}
        return loss, (new_bn, metrics, auxes)

    def _apply_fixed_masks(self, trainable) -> dict:
        if self.wp_masks is not None:
            trainable = weight_pruning.apply_masks(trainable, self.wp_masks)
        if self.ns_masks is not None:
            trainable = slimming.apply_masks(trainable, self.ns_masks)
        return trainable

    def loss_and_grads(self, state, images, labels):
        """The loss at ``state`` and its gradient with respect to every
        trainable tensor (after the fixed partner masks), unclipped.
        Returns ``(trainable, loss, grads, new BN statistics, metrics)``."""
        variables = state["variables"]
        trainable = self._apply_fixed_masks(self._trainable(variables))
        leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
        state_bn = {k: v for k, v in variables.items() if k not in leaves}
        loss, (new_bn, metrics, _) = self._loss_fn(leaves, state_bn, images, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        detached = lambda d: {k: v.detach() for k, v in d.items()}  # noqa: E731
        return trainable, loss.detach(), grads, detached(new_bn), detached(metrics)

    def _step(self, state, images, labels):
        """One optimizer step: ``(new state, metrics)``. The learning rate
        is read at the step before the increment."""
        trainable, loss, grads, new_bn, metrics = self.loss_and_grads(state, images, labels)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, self.cfg.grad_clip)
            updates, new_opt = self.opt.update(grads, state["opt"], trainable,
                                               state["step"])
            new_trainable = self._apply_fixed_masks(apply_updates(trainable, updates))
        new_vars = {k: new_trainable.get(k, new_bn.get(k, v))
                    for k, v in state["variables"].items()}
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return {"variables": new_vars, "opt": new_opt, "step": state["step"] + 1}, metrics

    # ------------------------------------------------------------------
    def train(self, steps: int | None = None, log_every: int = 50,
              loader: StreamingLoader | None = None, state=None,
              callback: Callable | None = None):
        """Run ``steps`` optimizer steps (default ``cfg.steps``) on batches
        from ``loader`` (default: the synthetic dataset at ``cfg.batch``).
        Returns ``(state, history)``: the host reads the metrics (one
        device sync) only at logged steps, every ``log_every`` and the last."""
        if self.opt is None:
            raise ValueError("CNNTrainer.train needs an optimizer")
        cfg = self.cfg
        steps = steps or cfg.steps
        loader = loader or StreamingLoader(partial(image_batch, cfg.dataset), cfg.batch)
        state = state or self.init_state()
        history = []
        for _ in range(steps):
            images, labels = next(loader)
            state, metrics = self._step(
                state, torch.as_tensor(images, device=self.device),
                torch.as_tensor(labels, device=self.device))
            if state["step"] % log_every == 0 or state["step"] == steps:
                # one device-to-host copy; float64 holds every f32 metric and
                # the byte count (< 2**53) exactly
                m = dict(zip(metrics, torch.stack([v.double() for v in metrics.values()])
                             .tolist()))
                m["step"] = state["step"]
                history.append(m)
                if callback:
                    callback(m)
        return state, history

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, variables, images: torch.Tensor, zcfg: ZebraConfig | None = None):
        """``(logits, site auxes)`` of one infer-mode forward."""
        zcfg = (zcfg or self.cfg.zebra).replace(mode="infer")
        logits, _, auxes = functional_call(self.model, variables, (images, zcfg))
        return logits, auxes

    def _eval(self, variables, images: torch.Tensor, labels: torch.Tensor) -> dict:
        logits, auxes = self.forward(variables, images)
        acc = _sum_bytes(auxes)
        return {"acc": accuracy(logits, labels),
                "top5": topk_accuracy(logits, labels, k=5),
                "ce": cross_entropy(logits, labels),
                "zero_frac": mean_zero_frac(auxes),
                "zero_fracs": torch.stack([a["zero_frac"] for a in auxes]),
                "measured_bytes": acc.measured_bytes}

    def evaluate(self, variables, batches: int = 8, batch: int = 128,
                 seed: int = 10_000) -> dict:
        """The reference's evaluation keys. ``measured_bytes`` is the mean
        over batches of each batch's exact stream bytes (an int when the
        mean is whole); ``measured_bytes_per_batch`` keeps the exact ints.
        The host reads each batch's results in one device-to-host copy."""
        cfg = self.cfg
        accs, top5s, zfs, per_site, mbytes = [], [], [], [], []
        for i in range(batches):
            images, labels = image_batch(cfg.dataset, batch, seed + i)
            out = self._eval(variables, torch.from_numpy(images).to(self.device),
                             torch.from_numpy(labels).to(self.device))
            # float64 holds every f32 metric and the byte count (< 2**53) exactly
            row = torch.cat([torch.stack([out["acc"], out["top5"],
                                          out["zero_frac"]]).double(),
                             out["measured_bytes"].double()[None],
                             out["zero_fracs"].double()]).tolist()
            accs.append(row[0])
            top5s.append(row[1])
            zfs.append(row[2])
            mbytes.append(int(row[3]))
            per_site.append(np.asarray(row[4:], dtype=np.float32))
        specs = self.model.map_specs(cfg.dataset.hw, cfg.zebra)
        site_zf = np.mean(np.stack(per_site), axis=0)
        total = sum(mbytes)
        return {"acc": float(np.mean(accs)), "top5": float(np.mean(top5s)),
                "zero_frac": float(np.mean(zfs)),
                "reduced_bandwidth_pct": reduced_bandwidth_pct(specs, list(site_zf)),
                "site_zero_fracs": site_zf,
                "measured_bytes": (total // batches if total % batches == 0
                                   else total / batches),
                "measured_bytes_per_batch": mbytes}

    # ------------------------------------------------------------------
    # Partner-method hooks (paper §III.A)
    def apply_weight_pruning(self, variables, prune_frac: float) -> float:
        self.wp_masks = weight_pruning.magnitude_masks(
            self._params(self._trainable(variables)), prune_frac)
        return weight_pruning.sparsity(self.wp_masks)

    def apply_network_slimming(self, variables, prune_frac: float) -> float:
        self.ns_masks = slimming.channel_masks(
            self._params(self._trainable(variables)), prune_frac)
        return slimming.pruned_channel_frac(self.ns_masks)
