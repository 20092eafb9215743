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
``{axis: size}`` ``shape`` mapping and ``axis_names``.
:func:`to_shardings` and :func:`param_shardings` (the reference's
``NamedSharding`` trees) give each Spec as DTensor placements, one
``Shard(dim)`` or ``Replicate()`` per mesh axis, and :func:`local_shard`
cuts a rank's shard out of a whole tensor by them. :func:`build_sharded`
draws a model straight into a rank's shards and :func:`shard_model_` cuts
a whole one. Serving (:func:`serving_shardings`) materialises the
``model`` axis and keeps every parameter whole across ``data``. Training
keeps the full specs (:func:`param_shardings`; the reference's
``train_state_specs``: :func:`train_state_specs`): the module a rank runs
holds its ``model`` shards whole over ``data``, and the train state (the
float32 master parameters, both AdamW moments and the int8 residual) is
cut over ``data`` as well, the FSDP (ZeRO-3) split that
``launch.steps.train_step`` gathers before each forward.
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


def local_kv_heads(cfg: LMConfig, mesh) -> int:
    """The K/V heads a rank of a model served or trained on ``mesh`` holds:
    its part of them where the specs split them over ``model`` (a count
    the axis divides, outside the "dp" profile), else all of them."""
    if cfg.sharding_profile == "dp" or _kv_axis(cfg, mesh) is None:
        return cfg.n_kv_heads
    return cfg.n_kv_heads // mesh_shape(mesh)["model"]


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



# ---------------------------------------------------------------------------
# Placements: the reference's NamedShardings as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """``spec`` as DTensor placements over the mesh's axes, in their order:
    ``Shard(dim)`` for the axis a dimension is split over (an axis named
    by two dimensions keeps the first), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_shape(mesh))
    dims: dict[str, int] = {}
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                dims.setdefault(a, d)
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


def to_shardings(spec_tree, mesh):
    """A {name: Spec} mapping (or one Spec) as {name: placements}."""
    if isinstance(spec_tree, Spec):
        return placements(spec_tree, mesh)
    return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}


def param_shardings(params, cfg: LMConfig, mesh) -> dict:
    """{dotted name: placements} over a model's parameters (the
    reference's ``param_shardings``)."""
    return to_shardings(param_specs(params, cfg, mesh), mesh)


def local_shard(t, places: tuple, mesh, coords: dict[str, int] | None = None,
                axes: tuple[str, ...] | None = None):
    """This rank's shard of the whole tensor ``t`` under ``places``: for
    every mesh axis in ``axes`` (default: all) split as ``Shard(dim)``, the
    ``coords[axis]``-th of its equal parts along ``dim`` (the rank's
    coordinate on a ``DeviceMesh`` by default), nested in mesh order. A
    view of ``t``."""
    sizes = mesh_shape(mesh)
    for name, pl in zip(sizes, places):
        if axes is not None and name not in axes or not hasattr(pl, "dim"):
            continue
        n = sizes[name]
        if t.shape[pl.dim] % n:
            raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not split over "
                             f"{name!r} ({n})")
        i = coords[name] if coords is not None else mesh.get_local_rank(name)
        part = t.shape[pl.dim] // n
        t = t.narrow(pl.dim, i * part, part)
    return t


def serving_shardings(params, cfg: LMConfig, mesh) -> dict:
    """The placements a served model's parameters take: the reference's
    specs over ``model``, every parameter whole over ``data``, and, where
    the FFN's hidden map would be gathered (a ``model`` shard of ``d_ff``
    would cut a Zebra block: ``core.engine.tp_site_rule``), ``w_down``
    whole on every rank, since the site then runs on the whole map."""
    from torch.distributed.tensor import Replicate

    from ..core.engine import tp_site_rule
    m = mesh_shape(mesh).get("model", 1)
    out = {}
    for name, places in param_shardings(params, cfg, mesh).items():
        places = tuple(Replicate() if a != "model" else pl
                       for a, pl in zip(mesh_shape(mesh), places))
        if name.endswith("ffn.w_down") and cfg.d_ff % m == 0 and \
                tp_site_rule(cfg.d_ff // m, True, m, cfg.zebra_block_ch) == "gather":
            places = tuple(Replicate() for _ in places)
        out[name] = places
    return out


def train_state_specs(state: dict, cfg: LMConfig, mesh) -> dict:
    """The reference's ``train_state_specs``: a Spec for every leaf of a
    whole train state (``launch.steps.init_train_state`` of a whole
    model, or of one on the meta device): the parameters' specs, mirrored
    by both AdamW moments and the int8 residual (None without one), and a
    replicated step."""
    specs = param_specs(state["params"], cfg, mesh)
    error = state["compress"].error
    return {"params": specs,
            "opt": {slot: {n: specs[n] for n in bufs} for slot, bufs in state["opt"].items()},
            "compress": None if error is None else {n: specs[n] for n in error},
            "step": Spec()}


def split_dim(places: tuple, mesh, axis: str) -> int | None:
    """The dimension ``places`` splits over mesh axis ``axis``, or None
    (the tensor is whole across it)."""
    pl = dict(zip(mesh_shape(mesh), places)).get(axis)
    return getattr(pl, "dim", None)


def tp_unported(cfg: LMConfig) -> str | None:
    """Why the sharded train step does not take ``cfg``, or None: it trains
    every layer kind tensor-parallel serving takes (attention, the MoE by
    expert parallelism, Mamba-2's SSD, the RG-LRU, the encoder-decoder).
    Under the "dp" profile only the MoE's sites report global observables
    (``ffn.moe_apply_dp`` averages them over the ranks), so a Zebra site
    outside an MoE is refused there."""
    if cfg.sharding_profile == "dp" and cfg.zebra_enabled:
        trained = {"layer_out"} | (set() if cfg.is_moe else {"ffn_hidden"})
        outside = sorted(trained & set(cfg.zebra_sites))
        if outside:
            return f"Zebra sites outside the MoE ({', '.join(outside)}) under the \"dp\" profile"
    return None


def check_tp(cfg: LMConfig, m: int, *, train: bool = False) -> None:
    """Raise for what the layouts of the port's tensor parallelism over
    ``m`` model ranks do not cover (serving, or with ``train`` the sharded
    train step, :func:`tp_unported`). The specs decide each split
    (``_axis_ok``: heads or a vocabulary that do not divide stay whole,
    and run replicated); the experts must split, and a Mamba-2 block's
    heads with its ``d_inner``."""
    if train:
        why = tp_unported(cfg)
        if why is not None:
            raise NotImplementedError(f"the sharded train step does not take {why}")
    if cfg.sharding_profile == "dp":
        return                          # no layer is tensor-parallel
    if cfg.is_moe and cfg.n_experts % m:
        raise NotImplementedError(f"{cfg.n_experts} experts do not split over {m} model "
                                  f"ranks")
    if "ssm" in cfg.layer_pattern and cfg.d_inner % m == 0 and cfg.ssm_heads % m:
        raise NotImplementedError(f"d_inner {cfg.d_inner} splits over {m} model ranks but "
                                  f"its {cfg.ssm_heads} SSD heads do not")


def _cut(p, places: tuple, mesh, coords):
    return local_shard(p, places, mesh, coords, axes=("model",)).clone()


def _placements(params, cfg: LMConfig, mesh, train: bool) -> dict:
    return (param_shardings if train else serving_shardings)(params, cfg, mesh)


def _record(model, mesh, places: dict, train: bool):
    """Record the mesh (``model.mesh``, where the steps read it) and, for
    training, the placements the train state is cut by
    (``model.train_places``)."""
    model.mesh = mesh
    model.train_places = places if train else None
    return model


def shard_model_(model, mesh, coords: dict[str, int] | None = None, *, train: bool = False):
    """Cut a whole model's parameters to this rank's shards over ``model``
    (:func:`serving_shardings`, or with ``train`` the full :func:`param_shardings`),
    in place: each becomes a copy of its shard, and the whole tensors go.
    Records the mesh on the model (``model.mesh``) and, with ``train``, the
    placements (``model.train_places``). Returns the model."""
    import torch
    check_tp(model.cfg, mesh_shape(mesh).get("model", 1), train=train)
    places = _placements(model, model.cfg, mesh, train)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = _cut(p.data, places[name], mesh, coords)
    return _record(model, mesh, places, train)


def build_sharded(cfg: LMConfig, mesh, *, generator=None, device=None,
                  coords: dict[str, int] | None = None, train: bool = False):
    """``models.lm.LM(cfg, generator=..., device=...)`` with every
    parameter cut to this rank's shard over ``model`` (serving's, or with
    ``train`` the train step's) as soon as it is drawn, so a rank holds its
    shards and one whole parameter at most, never the whole model. The
    values are those of building whole and cutting (:func:`shard_model_`):
    each parameter is drawn whole, in the same order from the same
    generator. A build on the meta device first names the parameters in
    the order they are made. ``launch.steps.init_train_state`` then cuts
    the train state over ``data``."""
    import torch
    from torch.nn.modules.module import register_module_parameter_registration_hook

    from ..models.lm import LM
    check_tp(cfg, mesh_shape(mesh).get("model", 1), train=train)
    made = []
    hook = register_module_parameter_registration_hook(
        lambda mod, name, p: made.append((mod, name)))
    try:
        meta = LM(cfg, device="meta")
    finally:
        hook.remove()
    prefix = {id(mod): f"{path}." if path else "" for path, mod in meta.named_modules()}
    names = iter([prefix[id(mod)] + name for mod, name in made])
    places = _placements(dict(meta.named_parameters()), cfg, mesh, train)

    def cut(mod, name, p):
        return torch.nn.Parameter(_cut(p.data, places[next(names)], mesh, coords),
                                  requires_grad=p.requires_grad)
    hook = register_module_parameter_registration_hook(cut)
    try:
        model = LM(cfg, generator=generator, device=device)
    finally:
        hook.remove()
    return _record(model, mesh, places, train)
