"""Shared machinery for the paper's CNN zoo (``repro.models.cnn.common``).

A *Zebra site* sits after every ReLU that produces a DRAM-bound activation
map (paper Fig. 2). Block size follows the paper: ``zcfg.block_hw``
normally, shrinking to the largest divisor when a deep map is smaller than
the block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.bandwidth import MapSpec
from ...core.engine import SiteAux, site_block, zebra_site
from ...core.zebra import ZebraConfig


class ZebraSites:
    """Names the sites of one forward pass in order (``z0``, ``z1``, ...)
    and collects their auxes and map specs. Every site executes through
    the engine (``core.engine.zebra_site``), so ``zcfg.backend`` picks
    reference, pallas or stream per forward. ``tnets`` maps site names to
    threshold nets; in train mode with ``use_tnet`` a site whose net is
    missing passes its map through unmasked, as the reference does for
    checkpoints saved without nets."""

    def __init__(self, zcfg: ZebraConfig, tnets=None):
        self.zcfg = zcfg
        self.tnets = tnets
        self.auxes: list[SiteAux] = []
        self.specs: list[MapSpec] = []
        self._i = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        name = f"z{self._i}"
        self._i += 1
        B, C, H, W = x.shape
        b = site_block(H, W, self.zcfg.block_hw)
        cfg = self.zcfg.replace(block_hw=b)
        tnet = self.tnets[name] if self.tnets is not None and name in self.tnets else None
        if cfg.mode == "train" and tnet is None and cfg.use_tnet:
            cfg = cfg.replace(enabled=False)   # net expected but missing
        y, aux = zebra_site(x, cfg, site=name, layout="nchw", tnet=tnet)
        self.auxes.append(aux)
        self.specs.append(MapSpec(c=C, h=H, w=W, bits=cfg.act_bits, block=b))
        return y


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels[:, None].to(torch.int64)).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    topk = torch.topk(logits, k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1).to(torch.float32).mean()
