"""ResNet-18 / ResNet-56 with Zebra sites (``repro.models.cnn.resnet``).

ResNet-18: stem conv3x3 -> 4 stages of 2 BasicBlocks (64,128,256,512).
ResNet-56: CIFAR style, 3 stages of 9 BasicBlocks (16,32,64).
Zebra is applied after every ReLU (both intra-block and post-residual).

Module and parameter names mirror the reference's variable tree
(``stem.w``, ``bn_stem.scale``, ``s1b0.proj.w``, ``zebra.z3.w``, ...), so
``convert.from_jax_variables`` is a flatten plus the dense transpose.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.bandwidth import MapSpec
from ...core.zebra import ThresholdNet, ZebraConfig
from ..layers import BatchNorm, Conv, Dense, global_avg_pool
from .common import ZebraSites, relu, site_block


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(c_in, c_out, 3, generator=generator)
        self.conv2 = Conv(c_out, c_out, 3, generator=generator)
        self.bn1, self.bn2 = BatchNorm(c_out), BatchNorm(c_out)
        if stride != 1 or c_in != c_out:
            self.proj = Conv(c_in, c_out, 1, generator=generator)
            self.bnp = BatchNorm(c_out)
        else:
            self.proj = self.bnp = None

    def forward(self, x: torch.Tensor, sites: ZebraSites, train: bool):
        """-> (y, {bn name: (new mean, new var)})."""
        stats = {}
        h, stats["bn1"] = self.bn1(self.conv1(x, self.stride), train)
        h = sites(relu(h))
        h, stats["bn2"] = self.bn2(self.conv2(h), train)
        if self.proj is None:
            sc = x
        else:
            sc, stats["bnp"] = self.bnp(self.proj(x, self.stride), train)
        return sites(relu(h + sc)), stats


class ResNet(nn.Module):
    """``model(x, zcfg, train) -> (logits, new BN statistics, site auxes)``,
    the reference's ``apply``. The statistics are a dict of buffer name
    (``"s0b0.bn1.mean"``, ...) to tensor: the batch-updated running
    statistics when ``train``, the running buffers themselves otherwise."""

    def __init__(self, stage_sizes, stage_channels, num_classes: int = 10,
                 in_hw: int = 32, width_mult: float = 1.0, *,
                 use_tnet: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.stage_sizes = list(stage_sizes)
        self.stage_channels = [max(8, int(c * width_mult)) for c in stage_channels]
        self.num_classes = num_classes
        self.in_hw = in_hw
        c0 = self.stage_channels[0]
        self.stem = Conv(3, c0, 3, generator=generator)
        self.bn_stem = BatchNorm(c0)
        site_channels = [c0]
        self.block_names = []
        for si, bi, c_in, c_out, stride in self._walk():
            name = f"s{si}b{bi}"
            self.add_module(name, BasicBlock(c_in, c_out, stride, generator=generator))
            self.block_names.append(name)
            site_channels += [c_out, c_out]      # two ReLU sites per block
        self.fc = Dense(self.stage_channels[-1], num_classes, generator=generator)
        # threshold nets ride along for training; inference reads T_obj
        self.zebra = nn.ModuleDict(
            {f"z{i}": ThresholdNet(c, generator=generator)
             for i, c in enumerate(site_channels)} if use_tnet else {})

    def _walk(self):
        """Yield (stage, block, c_in, c_out, stride)."""
        c_in = self.stage_channels[0]
        for si, (n, c) in enumerate(zip(self.stage_sizes, self.stage_channels)):
            for bi in range(n):
                yield si, bi, c_in, c, 2 if (si > 0 and bi == 0) else 1
                c_in = c

    def forward(self, x: torch.Tensor, zcfg: ZebraConfig, train: bool = False):
        sites = ZebraSites(zcfg, self.zebra)
        stats = {}
        x, stats["bn_stem"] = self.bn_stem(self.stem(x), train)
        x = sites(relu(x))
        for name in self.block_names:
            x, block_stats = getattr(self, name)(x, sites, train)
            stats.update({f"{name}.{bn}": s for bn, s in block_stats.items()})
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

        add(self.stage_channels[0], hw)
        for si, bi, c_in, c_out, stride in self._walk():
            if stride == 2:
                hw //= 2
            add(c_out, hw)   # post-conv1 ReLU
            add(c_out, hw)   # post-residual ReLU
        return specs


def resnet18(num_classes=10, in_hw=32, width_mult=1.0, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], [64, 128, 256, 512], num_classes, in_hw,
                  width_mult, **kw)


def resnet56(num_classes=10, in_hw=32, width_mult=1.0, **kw) -> ResNet:
    return ResNet([9, 9, 9], [16, 32, 64], num_classes, in_hw, width_mult, **kw)
