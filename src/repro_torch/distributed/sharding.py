"""Sharding rules (``repro.distributed.sharding``): parameter and cache
names -> a partition spec.

Conventions: ``"data"`` carries the batch and FSDP (ZeRO-3) parameter
shards; ``"model"`` tensor parallelism (attention heads, d_ff), expert
parallelism, the vocabulary and the KV sequence; ``"pod"`` pure data
parallelism only. Under ``LMConfig.sharding_profile == "dp"`` every
``"model"`` becomes None and the batch spreads over every axis.

A rule is keyed on a leaf's name (with checks on its parents) and fills
the trailing dimensions, so a leaf with extra leading axes (the
reference's stacked runs) gets None there. The port keeps one module per
layer, so its specs are the reference's without the stacking axis; the
names are the reference's (``models.lm.convert``).

A spec is a :class:`Spec`: per dimension one axis name, a tuple of names,
or None. A mesh is a ``DeviceMesh`` or any object with an
``{axis: size}`` ``shape`` mapping and ``axis_names``. Turning specs into
DTensor placements (the reference's ``to_shardings``) waits for the
tensor-parallel slice, the first to consume them (ROADMAP.md, item 3).
"""
from __future__ import annotations

import math

from ..models.lm.config import LMConfig
from ..utils import map_tree


class Spec(tuple):
    """A partition spec: per dimension an axis name, a tuple of names or
    None; ``Spec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _kv_axis(cfg: LMConfig, mesh):
    m = mesh_shape(mesh).get("model", 1)
    return "model" if (cfg.n_kv_heads and cfg.n_kv_heads % m == 0) else None


def _axis_ok(shape, template, mesh) -> tuple:
    """Drop the axis names whose mesh size does not divide the dimension."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, ax in zip(shape[-len(template):], template):
        if ax is None:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        out.append(ax if dim % size == 0 else None)
    return tuple(out)


def _template(shape, cfg: LMConfig | None, mesh):
    pure_dp = cfg is not None and cfg.sharding_profile == "dp"

    def t(*template) -> Spec:
        if pure_dp:     # pure data parallel: no TP/EP, "model" carries batch
            template = tuple(None if a == "model" else a for a in template)
        template = _axis_ok(shape, template, mesh)
        return Spec(*((None,) * (len(shape) - len(template)) + template))
    return t


def spec_for(path_names: tuple[str, ...], shape: tuple[int, ...], cfg: LMConfig,
             mesh) -> Spec:
    n = path_names
    name = n[-1]
    kv = _kv_axis(cfg, mesh)
    t = _template(shape, cfg, mesh)

    # --- embeddings / head ---
    if name == "embed":
        return t("model", None)
    if name == "lm_head":
        return t(None, "model")
    # --- zebra threshold nets ---
    if "zebra_tnet" in n or "zebra_out_tnet" in n:
        return t("model", None) if name == "w" else t(None)
    # --- norms ---
    if name in ("scale", "bias") and len(n) >= 2 and n[-2] == "out_norm":
        return t("model")
    if name in ("scale", "bias"):
        return t(None)
    # --- attention ---
    if name == "wq":
        return t("data", "model", None)
    if name in ("wk", "wv"):
        return t("data", kv, None)
    if name == "wo":
        return t("model", None, "data")
    if name == "bq":
        return t("model", None)
    if name in ("bk", "bv"):
        return t(kv, None)
    # --- FFN dense vs MoE (MoE weights carry a leading E) ---
    if name in ("w_gate", "w_up"):
        return t("model", "data", None) if "moe" in n else t("data", "model")
    if name == "w_down":
        return t("model", None, "data") if "moe" in n else t("model", "data")
    if name == "b_up":
        return t("model")
    if name == "b_down":
        return t(None)
    if name == "router":
        return t("data", None)
    # --- Mamba-2 ---
    if name in ("z_proj", "x_proj", "dt_proj"):
        return t("data", "model")
    if name in ("b_proj", "c_proj"):
        return t("data", None)
    if name == "conv_x":
        return t(None, "model")
    if name in ("conv_b", "conv_c"):
        return t(None, None)
    if name in ("A_log", "D", "dt_bias"):
        return t("model")
    if name == "out_proj":
        return t("model", "data")
    # --- RG-LRU ---
    if name in ("w_gate_branch", "w_rec_branch"):
        return t("data", "model")
    if name in ("w_a", "w_x"):
        return t(None, "model")
    if name in ("b_a", "b_x", "lam"):
        return t("model")
    if name == "w_out":
        return t("model", "data")
    if name == "conv_w":
        return t(None, "model")
    return Spec()   # replicate anything unknown


def param_specs(params, cfg: LMConfig, mesh) -> dict[str, Spec]:
    """{dotted name: Spec} over a model's parameters (an ``nn.Module``, by
    its ``state_dict``, or a mapping of dotted names to tensors)."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    return {k: spec_for(tuple(k.split(".")), tuple(v.shape), cfg, mesh)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Batch and cache specs
# ---------------------------------------------------------------------------

def dp(mesh, cfg: LMConfig | None = None) -> tuple[str, ...]:
    names = tuple(mesh_shape(mesh))
    axes = ("pod", "data") if "pod" in names else ("data",)
    if cfg is not None and cfg.sharding_profile == "dp":
        axes = axes + ("model",)     # pure DP: the batch over every axis
    return axes


def batch_spec(mesh, ndim: int, batch: int | None = None,
               cfg: LMConfig | None = None) -> Spec:
    """dim 0 (the global batch) over the DP axes, the rest replicated; the
    axes whose product does not divide ``batch`` go, outermost first."""
    axes = dp(mesh, cfg)
    sizes = mesh_shape(mesh)
    if batch is not None:
        while axes and batch % math.prod(sizes[a] for a in axes):
            axes = axes[1:]
    return Spec(axes if axes else None, *([None] * (ndim - 1)))


def cache_spec_for(path_names, shape, cfg: LMConfig, mesh) -> Spec:
    name = path_names[-1]
    t = _template(shape, cfg, mesh)
    d = dp(mesh, cfg)
    if name in ("k", "v"):            # (B, T, Hkv, hd): split-K over the sequence
        return t(d, "model", None, None)
    if name == "H":                   # (B, nh, ds, hd)
        return t(d, "model", None, None)
    if name == "conv_x":              # (B, w, di)
        return t(d, None, "model")
    if name in ("conv_b", "conv_c"):
        return t(d, None, None)
    if name == "h":                   # (B, dl)
        return t(d, "model")
    if name == "conv":                # the RG-LRU's ring (B, w, dl)
        return t(d, None, "model")
    return Spec()


def cache_specs(cache_tree, cfg: LMConfig, mesh):
    """The cache tree (``LM.init_cache``) with a Spec for every leaf."""
    return map_tree(lambda path, leaf: cache_spec_for(tuple(map(str, path)),
                                                      tuple(leaf.shape), cfg, mesh),
                    cache_tree)
