"""VGG-16 with Zebra sites (``repro.models.cnn.vgg``): the CIFAR variant,
conv-BN-ReLU with a Zebra site after every ReLU (13 sites), a 2x2 max
pool at each ``"M"`` of the plan, global average pooling and one dense
layer.

Parameter names mirror the reference's variable tree (``conv{i}.w``,
``bn{i}.scale``, ``fc.w``, ``zebra.z{i}.w``), so
``convert.from_jax_variables`` is a flatten plus the dense transpose.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bandwidth import MapSpec
from ...core.zebra import ThresholdNet, ZebraConfig
from ..layers import BatchNorm, Conv, Dense, global_avg_pool, max_pool
from .common import ZebraSites, relu, site_block

VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16(nn.Module):
    """``model(x, zcfg, train) -> (logits, new BN statistics, site auxes)``,
    as ``ResNet``."""

    def __init__(self, num_classes: int = 10, in_hw: int = 32, width_mult: float = 1.0,
                 *, use_tnet: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_hw = in_hw
        self.plan = [c if c == "M" else max(8, int(c * width_mult)) for c in VGG16_PLAN]
        self.channels = [c for c in self.plan if c != "M"]
        c_in = 3
        for i, c in enumerate(self.channels):
            self.add_module(f"conv{i}", Conv(c_in, c, 3, generator=generator))
            self.add_module(f"bn{i}", BatchNorm(c))
            c_in = c
        self.fc = Dense(c_in, num_classes, generator=generator)
        self.zebra = nn.ModuleDict(
            {f"z{i}": ThresholdNet(c, generator=generator)
             for i, c in enumerate(self.channels)} if use_tnet else {})

    def forward(self, x: torch.Tensor, zcfg: ZebraConfig, train: bool = False):
        sites = ZebraSites(zcfg, self.zebra)
        new_state = {}
        i = 0
        for c in self.plan:
            if c == "M":
                x = max_pool(x)
                continue
            x, (mean, var) = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train)
            new_state[f"bn{i}.mean"], new_state[f"bn{i}.var"] = mean, var
            x = sites(relu(x))
            i += 1
        return self.fc(global_avg_pool(x)), new_state, sites.auxes

    def map_specs(self, in_hw: int | None = None,
                  zcfg: ZebraConfig = ZebraConfig()) -> list[MapSpec]:
        hw = in_hw or self.in_hw
        specs = []
        for c in self.plan:
            if c == "M":
                hw //= 2
                continue
            b = site_block(hw, hw, zcfg.block_hw)
            specs.append(MapSpec(c=c, h=hw, w=hw, bits=zcfg.act_bits, block=b))
        return specs
