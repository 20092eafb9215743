"""MobileNetV1 with Zebra sites (``repro.models.cnn.mobilenet``): the CIFAR
variant (stem stride 1), 13 depthwise-separable blocks, a Zebra site after
every ReLU (the stem, then each block's depthwise and pointwise maps: 27
sites, since both activations go to DRAM).

The depthwise conv is a grouped conv (``groups = c_in``, an OIHW weight of
shape (c, 1, 3, 3)) through ``layers.conv_apply``, so its stride-2 layers
pad as XLA's ``"SAME"`` does: (0, 1) on an even map. Parameter names
mirror the reference's variable tree (``stem.w``, ``bn_stem.scale``,
``dw{i}.w``, ``bn_dw{i}``, ``pw{i}.w``, ``bn_pw{i}``, ``fc.w``,
``zebra.z{i}.w``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bandwidth import MapSpec
from ...core.zebra import ThresholdNet, ZebraConfig
from ..layers import BatchNorm, Conv, Dense, global_avg_pool
from .common import ZebraSites, relu, site_block

# (out_channels, stride) per separable block
MB_PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


class MobileNetV1(nn.Module):
    """``model(x, zcfg, train) -> (logits, new BN statistics, site auxes)``,
    as ``ResNet``."""

    def __init__(self, num_classes: int = 10, in_hw: int = 32, width_mult: float = 1.0,
                 *, use_tnet: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_hw = in_hw
        self.plan = [(max(8, int(c * width_mult)), s) for c, s in MB_PLAN]
        self.stem_c = max(8, int(32 * width_mult))
        self.stem = Conv(3, self.stem_c, 3, generator=generator)
        self.bn_stem = BatchNorm(self.stem_c)
        site_channels = [self.stem_c]
        c_in = self.stem_c
        for i, (c, _) in enumerate(self.plan):
            self.add_module(f"dw{i}", Conv(c_in, c_in, 3, groups=c_in, generator=generator))
            self.add_module(f"bn_dw{i}", BatchNorm(c_in))
            self.add_module(f"pw{i}", Conv(c_in, c, 1, generator=generator))
            self.add_module(f"bn_pw{i}", BatchNorm(c))
            site_channels += [c_in, c]
            c_in = c
        self.fc = Dense(c_in, num_classes, generator=generator)
        self.zebra = nn.ModuleDict(
            {f"z{i}": ThresholdNet(c, generator=generator)
             for i, c in enumerate(site_channels)} if use_tnet else {})

    def forward(self, x: torch.Tensor, zcfg: ZebraConfig, train: bool = False):
        sites = ZebraSites(zcfg, self.zebra)
        stats = {}
        x, stats["bn_stem"] = self.bn_stem(self.stem(x), train)
        x = sites(relu(x))
        for i, (_, stride) in enumerate(self.plan):
            x, stats[f"bn_dw{i}"] = getattr(self, f"bn_dw{i}")(
                getattr(self, f"dw{i}")(x, stride), train)
            x = sites(relu(x))
            x, stats[f"bn_pw{i}"] = getattr(self, f"bn_pw{i}")(getattr(self, f"pw{i}")(x),
                                                               train)
            x = sites(relu(x))
        new_state = {}
        for bn, (mean, var) in stats.items():
            new_state[f"{bn}.mean"], new_state[f"{bn}.var"] = mean, var
        return self.fc(global_avg_pool(x)), new_state, sites.auxes

    def map_specs(self, in_hw: int | None = None,
                  zcfg: ZebraConfig = ZebraConfig()) -> list[MapSpec]:
        hw = in_hw or self.in_hw
        specs = []

        def add(c, hw):
            b = site_block(hw, hw, zcfg.block_hw)
            specs.append(MapSpec(c=c, h=hw, w=hw, bits=zcfg.act_bits, block=b))

        add(self.stem_c, hw)
        c_in = self.stem_c
        for c, stride in self.plan:
            if stride == 2:
                hw //= 2
            add(c_in, hw)   # depthwise ReLU map
            add(c, hw)      # pointwise ReLU map
            c_in = c
        return specs
