"""CNN evaluation loop — the port of ``repro.train.cnn_trainer`` (inference
half). ``CNNTrainer.evaluate`` is the paper's measurement: accuracy, the
zero-block fraction, Eq. 2-5 reduced bandwidth and the bytes the stream
backend actually moved. Training waits for the training slice of
ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from ..core import (LayerAux, ZebraConfig, mean_zero_frac,
                    reduced_bandwidth_pct)
from ..core.zebra import TRAIN_NOT_PORTED
from ..data import ImageDatasetConfig, image_batch
from ..models.cnn import build as build_cnn
from ..models.cnn.common import accuracy, cross_entropy, topk_accuracy


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card: with no ``device`` given, a host
    without CUDA raises rather than run on the CPU. The CPU must be asked
    for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: repro_torch runs on "
                               "the card; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _sum_bytes(auxes) -> LayerAux:
    """Exact cross-site accumulation (int64 bytes)."""
    acc = LayerAux.of_site(auxes[0])
    for a in auxes[1:]:
        acc = acc + LayerAux.of_site(a)
    return acc


@dataclasses.dataclass(frozen=True)
class CNNTrainConfig:
    """The fields evaluation reads; the training slice adds its own."""
    model: str = "resnet18"
    width_mult: float = 1.0
    dataset: ImageDatasetConfig = ImageDatasetConfig()
    zebra: ZebraConfig = ZebraConfig()
    seed: int = 0


class CNNTrainer:
    """Holds the model (an ``nn.Module`` on ``device``); ``variables`` are
    its state dicts, applied with ``torch.func.functional_call`` so a call
    never changes the module."""

    def __init__(self, cfg: CNNTrainConfig, optimizer=None, device=None):
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

    def init_state(self) -> dict:
        """Fresh variables (random weights from ``cfg.seed``)."""
        return {"variables": {k: v.clone() for k, v in self.model.state_dict().items()},
                "step": 0}

    def train(self, *args, **kwargs):
        raise NotImplementedError(TRAIN_NOT_PORTED)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, variables, images: torch.Tensor, zcfg: ZebraConfig | None = None):
        """``(logits, site auxes)`` of one infer-mode forward."""
        zcfg = (zcfg or self.cfg.zebra).replace(mode="infer")
        return functional_call(self.model, variables, (images, zcfg))

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
