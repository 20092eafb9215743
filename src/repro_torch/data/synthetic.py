"""Procedural datasets — a numpy copy of ``repro.data.synthetic``'s image
and token generators, so the port draws the same images, labels and token
sequences as the reference for the same (seed, step), and its
``StreamingLoader``.

Class-conditional oriented-stripe textures composited on low-amplitude
background clutter: learnable, with real "background" pixels so Zebra's
zero-block story is testable, and deterministic per (seed, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDatasetConfig:
    name: str = "syn-cifar10"     # or "syn-tinyimagenet"
    num_classes: int = 10
    hw: int = 32
    seed: int = 0
    noise: float = 0.15           # background clutter amplitude
    fg_classes_per_image: int = 1


SYN_CIFAR10 = ImageDatasetConfig("syn-cifar10", 10, 32)
SYN_TINYIMAGENET = ImageDatasetConfig("syn-tinyimagenet", 200, 64)


def _class_texture(cls: int, num_classes: int, hw: int, rng: np.random.Generator):
    """Oriented stripe patch whose (angle, frequency, phase-color) encode cls."""
    angle = np.pi * (cls % num_classes) / num_classes
    freq = 2.0 + 3.0 * ((cls * 7) % 5)
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw), indexing="ij")
    u = np.cos(angle) * xx + np.sin(angle) * yy
    base = np.sin(2 * np.pi * freq * u + rng.uniform(0, 2 * np.pi))
    color = np.array([np.sin(cls), np.cos(2 * cls), np.sin(3 * cls + 1)]) * 0.5 + 0.75
    return base[None, :, :] * color[:, None, None]          # (3, hw, hw)


def image_batch(cfg: ImageDatasetConfig, batch: int, step: int):
    """-> (images (B,3,H,W) float32 ~N(0,1)-ish, labels (B,) int32)."""
    rng = np.random.default_rng((cfg.seed << 32) ^ (step & 0xFFFFFFFF))
    hw = cfg.hw
    labels = rng.integers(0, cfg.num_classes, size=(batch,))
    imgs = rng.normal(0.0, cfg.noise, size=(batch, 3, hw, hw)).astype(np.float32)
    for i in range(batch):
        tex = _class_texture(int(labels[i]), cfg.num_classes, hw, rng)
        # place the foreground patch over a random sub-window; the rest stays
        # background clutter => spatially sparse information, like photos.
        ph = rng.integers(hw // 2, hw + 1)
        pw = rng.integers(hw // 2, hw + 1)
        top = rng.integers(0, hw - ph + 1)
        left = rng.integers(0, hw - pw + 1)
        imgs[i, :, top:top + ph, left:left + pw] += tex[:, :ph, :pw].astype(np.float32)
    return imgs, labels.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class LMDatasetConfig:
    vocab: int = 32000
    effective_vocab: int = 509    # prime < vocab: structure lives here
    seed: int = 0
    noise_p: float = 0.05


def lm_batch(cfg: LMDatasetConfig, batch: int, seq: int, step: int) -> np.ndarray:
    """-> tokens (B, S+1) int32: per-row affine recurrences mod a prime with
    noise; inputs = [:, :-1], labels = [:, 1:]."""
    rng = np.random.default_rng((cfg.seed << 32) ^ (0x5BCD ^ step))
    V = cfg.effective_vocab
    a = 5 + 2 * rng.integers(0, 20, size=(batch, 1))
    b = rng.integers(0, V, size=(batch, 1))
    x = np.empty((batch, seq + 1), dtype=np.int64)
    x[:, 0] = rng.integers(0, V, size=batch)
    for t in range(seq):
        nxt = (a[:, 0] * x[:, t] + b[:, 0]) % V
        flip = rng.random(batch) < cfg.noise_p
        nxt = np.where(flip, rng.integers(0, V, size=batch), nxt)
        x[:, t + 1] = nxt
    return (x % cfg.vocab).astype(np.int32)


class StreamingLoader:
    """Counter-indexed loader: batch ``step`` is ``make_fn(batch, step)``, so
    its state is the step counter and checkpoint and restore persist one
    int. With ``n_hosts`` > 1 the global batch is split by host as the
    reference splits it: each host draws ``batch // n_hosts`` rows from
    the counter ``step · n_hosts + host_id``, so hosts draw disjoint data.
    (The sharded train step's ranks are not hosts: they take their rows
    of the one global batch, ``launch.steps.data_rows``.)"""

    def __init__(self, make_fn, batch: int, start_step: int = 0, *, host_id: int = 0,
                 n_hosts: int = 1):
        if batch % n_hosts:
            raise ValueError(f"batch {batch} does not split over {n_hosts} hosts")
        self.make_fn = make_fn
        self.batch = batch // n_hosts
        self.host_id, self.n_hosts = host_id, n_hosts
        self.step = start_step

    def __next__(self):
        out = self.make_fn(self.batch, self.step * self.n_hosts + self.host_id)
        self.step += 1
        return out

    def state(self) -> int:
        return self.step

    def restore(self, step: int) -> None:
        self.step = step
