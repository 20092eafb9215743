"""Zebra site engine — the port of ``repro.core.engine``.

Model code calls :func:`zebra_site`; the engine picks the execution backend
from ``ZebraConfig.backend`` (per-site overrides via ``site_backends``):

``reference``  plain PyTorch masking (``core.zebra``); threshold nets
               live here.
``pallas``     ``zebra_mask``: one kernel pass writes the masked map and
               its keep bitmap.
``stream``     ``zebra_mask_pack`` -> ``zebra_unpack``: the two-phase
               producer hands only the compressed ``(payload, bitmap)``
               stream to the expander. ``SiteAux.measured_bytes`` reports
               the observed stream length (payload + packed index, the
               Eq. 2/3 observable).
``fused``      with a downstream weight ``w``: ``zebra_mask_pack`` ->
               ``zebra_spmm_cs``, the payload GEMM that reads each live
               block from its slot and skips dead ones, so the masked map
               is never expanded; the site returns ``mask(x) @ w``. With
               no ``w`` it is the ``pallas`` masking pass.

With ``ZebraConfig.validation`` other than ``off``, an infer-mode
``stream`` or ``fused`` site (with or without ``w``) checks the stream
between producer and consumer (``compress.integrity``) and recovers a
failed one from the dense map in hand (``_validated_stream_impl``).

The masked map is bitwise equal on reference, pallas and stream. Train
mode runs on every backend but ``fused`` (not trainable: it degrades to
reference): a pallas or stream site trains through
``kernels.grad.ZebraKernelTrainable``, whose forward is the same kernel
pipeline infer dispatches. Capability resolution (``_resolve_backend``)
and its degrade labels ``"reference(<reason>)"`` are those of the
reference engine.

Layouts: ``tokens`` maps ``(..., S, D)`` tile into ``(block_seq,
block_ch)`` blocks; ``nchw`` maps ``(B, C, H, W)`` are flattened onto the
kernels' 2-D grid as ``(B*C*H, W)`` with ``bs = bc = b``, so every
``(b, b)`` tile is one spatial block of one channel.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
from typing import Any

import torch

from ..compress import integrity
from ..ft.inject import stream_tap
from ..kernels.grad import KernelStatics, launch_forward, zebra_kernel_trainable
from ..kernels.mask_pack import mask_pack_with_slots
from ..kernels.pack import unpack_with_slots
from ..kernels.schedule import slot_map
from ..kernels.spmm_cs import spmm_cs_with_slots
from ..kernels.zebra_mask import zebra_mask
from .backends import BackendSpec, backend_spec
from .zebra import (ZebraConfig, effective_tnet, require_tnet, zebra_cnn,
                    zebra_tokens, zero_fraction, zero_fraction_of)

_log = logging.getLogger("repro_torch.engine")
_DEGRADE_LOGGED: set[tuple[str, str, str]] = set()

@dataclasses.dataclass
class SiteAux:
    """What one Zebra site reports, uniformly across backends.

    ``reg``             Eq. 1 regularizer term (0 in infer mode).
    ``zero_frac``       fraction of blocks masked to zero at this site
                        (float32 tensor).
    ``measured_bytes``  observed transport bytes (payload + packed index)
                        for the whole input, an int64 tensor on the map's
                        device; 0 for backends that move the map dense.
    ``n_blocks``        per-sample block count (0 when disabled).
    ``thresholds``      threshold-net outputs (None in infer mode).
    ``backend``         which backend actually executed, with a degrade
                        surfaced as ``"reference(<reason>)"``; a degraded
                        layer exchange appends ``"+dense-comms(<reason>)"``.
    ``ici_bytes``       interconnect bytes this site's layer exchanges put
                        on one inbound link (the compressed stream, or the
                        dense size of a degraded exchange), an int64 tensor
                        once ``distributed.collectives.attach_link`` has
                        added a link; 0 outside a comm context.
    ``ici_dense_bytes`` the dense-equivalent bytes of the same exchanges
                        (the plain all-gather the compression is measured
                        against).
    ``keep``            the site's block keep flags as it computed them
                        (the kernels' (rows/bs, D/bc) bitmap, or the
                        reference's block mask), None where no block ran;
                        the tensor-parallel path sums it over the ranks.
    """
    reg: Any = 0.0
    zero_frac: Any = 0.0
    measured_bytes: Any = 0
    n_blocks: Any = 0
    thresholds: Any = None
    backend: str = "reference"
    ici_bytes: Any = 0
    ici_dense_bytes: Any = 0
    keep: Any = None

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    @classmethod
    def empty(cls, backend: str = "disabled", device=None) -> "SiteAux":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(reg=z, zero_frac=z,
                   measured_bytes=torch.zeros((), dtype=torch.int64, device=device),
                   n_blocks=0, thresholds=None, backend=backend)


@dataclasses.dataclass
class LayerAux:
    """Site aux accumulated across sites and layers. Bytes add in int64,
    exact to 2**63 (the reference carries an f32 base-2**24 pair only
    because JAX runs 32-bit); ``measured_bytes_exact`` returns the same
    integer. ``router_aux`` is an MoE layer's load-balancing loss (float32,
    0 elsewhere), summed over the layers as the reference's carry sums it.
    ``ici_bytes``/``ici_dense_bytes`` total the per-link interconnect bytes
    of every layer exchange the sites ran (``SiteAux`` of the same names);
    they stay the Python int 0 until a site brings a link, so a run without
    a comm context adds no tensor for them. ``ici_bytes_exact`` reads both."""
    reg: torch.Tensor
    zf_blocks: torch.Tensor
    n_blocks: torch.Tensor
    measured_bytes: torch.Tensor
    router_aux: torch.Tensor
    ici_bytes: Any = 0
    ici_dense_bytes: Any = 0

    @classmethod
    def zero(cls, device=None) -> "LayerAux":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(z, z, z, torch.zeros((), dtype=torch.int64, device=device), z)

    @classmethod
    def of_site(cls, site: SiteAux, router_aux=0.0) -> "LayerAux":
        zf = torch.as_tensor(site.zero_frac, dtype=torch.float32)
        nb = float(site.n_blocks)
        return cls(reg=torch.as_tensor(site.reg, dtype=torch.float32,
                                       device=zf.device),
                   zf_blocks=zf * nb,
                   n_blocks=torch.tensor(nb, dtype=torch.float32, device=zf.device),
                   measured_bytes=torch.as_tensor(site.measured_bytes,
                                                  device=zf.device).to(torch.int64),
                   router_aux=torch.as_tensor(router_aux, dtype=torch.float32,
                                              device=zf.device),
                   ici_bytes=_int64(site.ici_bytes), ici_dense_bytes=_int64(site.ici_dense_bytes))

    def __add__(self, other: "LayerAux") -> "LayerAux":
        return LayerAux(self.reg + other.reg, self.zf_blocks + other.zf_blocks,
                        self.n_blocks + other.n_blocks,
                        self.measured_bytes + other.measured_bytes,
                        self.router_aux + other.router_aux,
                        self.ici_bytes + other.ici_bytes,
                        self.ici_dense_bytes + other.ici_dense_bytes)

    @property
    def zero_frac(self) -> torch.Tensor:
        return torch.clamp(self.zf_blocks / torch.clamp(self.n_blocks, min=1.0),
                           0.0, 1.0)

    def measured_bytes_exact(self) -> int:
        """Exact host-side readout (one device-to-host copy)."""
        return int(self.measured_bytes.item())

    def ici_bytes_exact(self) -> tuple[int, int]:
        """Exact host-side (moved, dense-equivalent) per-link totals."""
        return int(self.ici_bytes), int(self.ici_dense_bytes)


def _int64(v):
    """A byte count as an int64 tensor, or the Python int it is."""
    return v if isinstance(v, int) else torch.as_tensor(v).to(torch.int64)


def merge_site_aux(a: SiteAux, b: SiteAux) -> SiteAux:
    """Fold two sites' aux into one ``SiteAux``: the block-weighted zero
    fraction, summed reg, measured and ici bytes, the joined backend label.
    For a call site whose contract is one aux but that runs an auxiliary
    site: ``ffn_apply`` masking its layer output for the exchange under a
    comm context. Thresholds keep ``a``'s (the primary site's). The zero
    fraction is rounded as the reference's compiled form rounds it: ``a``'s
    product fused into the sum (one rounding), times the float32
    reciprocal of the block count."""
    na, nb = int(a.n_blocks), int(b.n_blocks)
    nt = max(na + nb, 1)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
    part_b = f32(b.zero_frac) * nb
    zf = ((f32(a.zero_frac).double() * na + part_b.double()).float()
          * (torch.ones((), dtype=torch.float32) / nt))
    return SiteAux(reg=a.reg + b.reg, zero_frac=zf,
                   measured_bytes=_int64(a.measured_bytes) + _int64(b.measured_bytes),
                   n_blocks=na + nb, thresholds=a.thresholds,
                   backend=f"{a.backend}+{b.backend}",
                   ici_bytes=_int64(a.ici_bytes) + _int64(b.ici_bytes),
                   ici_dense_bytes=_int64(a.ici_dense_bytes) + _int64(b.ici_dense_bytes))


# ---------------------------------------------------------------------------
# Block-layout helpers
# ---------------------------------------------------------------------------

def site_block(h: int, w: int, want: int) -> int:
    """Largest block size <= want dividing both map sides (paper §II.A:
    shrink when the map is smaller than the block, e.g. 2 for 2x2 maps)."""
    b = min(want, h, w)
    while h % b or w % b:
        b -= 1
    return max(b, 1)


def nchw_stream_dims(shape: tuple[int, ...], block_hw: int
                     ) -> tuple[int, int, int] | None:
    """(B, C, H, W) -> (M, K, b): the 2-D tile-grid view whose (b, b)
    tiles are exactly the paper's spatial blocks. None if not 4-D."""
    if len(shape) != 4:
        return None
    B, C, H, W = shape
    b = site_block(H, W, block_hw)
    return B * C * H, W, b


def _tokens_blocks(x: torch.Tensor, cfg: ZebraConfig) -> tuple[int, int, bool]:
    """Effective (bs, bc) for a (..., S, D) map + whether bs degenerated."""
    S, D = x.shape[-2], x.shape[-1]
    bs = cfg.block_seq if S % cfg.block_seq == 0 else 1
    bc = cfg.block_ch if D % cfg.block_ch == 0 else D
    return bs, bc, (bs == 1 and cfg.block_seq > 1)


def _index_bytes(n_blocks_total: int) -> int:
    return (n_blocks_total + 7) // 8


def stream_bytes(n_live: torch.Tensor, bs: int, bc: int, dtype,
                 n_blocks_total: int) -> torch.Tensor:
    """Observed stream length (Eq. 2/3): live payload + packed index, in
    int64 on n_live's device — the one byte-accounting rule."""
    item = dtype.itemsize
    return (n_live.to(torch.int64) * (bs * bc * item)
            + _index_bytes(n_blocks_total))


# ---------------------------------------------------------------------------
# Kernel backends
# ---------------------------------------------------------------------------

def _kernel_statics(variant: str, bs: int, bc: int, cfg: ZebraConfig) -> KernelStatics:
    """Launch config of ``kernels.grad.launch_forward``, the one forward
    pipeline of infer dispatch and of the trainable path."""
    return KernelStatics(variant=variant, t_obj=cfg.t_obj, bs=bs, bc=bc,
                         grad_mode=cfg.grad_mode, soft_temp=cfg.soft_temp)


def _matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as the reference's
    ``jnp`` matmul promotes mixed operands (torch's refuses them); in
    ``out_dtype`` where that is wider (the operands widened to it)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    if out_dtype is not None:
        dt = torch.promote_types(dt, out_dtype)
    return x.to(dt) @ w.to(dt)


def _consume_fused(payload: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor,
                   keep: torch.Tensor, slot: torch.Tensor, bs: int, bc: int,
                   dtype: torch.dtype, out_dtype=None) -> torch.Tensor:
    """The payload GEMM of a stream: each live block read from its
    consumer-order slot, dead ones skipped. Operands promote as
    ``jnp.dot`` promotes them (bf16 map, f32 w: products in f32); the
    product (float32 sums) comes back in the map's ``dtype``, or in
    ``out_dtype``."""
    dt = torch.promote_types(dtype, w.dtype)
    out = spmm_cs_with_slots(payload.to(dt), w.to(dt), bitmap, keep, slot, bs=bs, bc=bc)
    return out.to(out_dtype or dtype)


def _run_fused(x2: torch.Tensor, w: torch.Tensor, bs: int, bc: int,
               cfg: ZebraConfig, out_dtype=None) -> tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """mask_pack -> payload GEMM, reusing the producer's slot map; the
    dense masked map is never expanded. Returns ``(mask(x2) @ w in x2's
    dtype or out_dtype, bitmap, stream bytes)``; the stream bytes are the
    map's."""
    payload, bitmap, n_live, keep, slot = mask_pack_with_slots(
        x2, t_obj=cfg.t_obj, bs=bs, bc=bc)
    out = _consume_fused(payload, w, bitmap, keep, slot, bs, bc, x2.dtype, out_dtype)
    return out, bitmap, stream_bytes(n_live, bs, bc, x2.dtype, bitmap.numel())


# ---------------------------------------------------------------------------
# Validated ingest (cfg.validation != "off"): the wire contract checked at
# the producer -> consumer boundary, with recompute-from-dense recovery
# ---------------------------------------------------------------------------

_VALIDATED_BACKENDS = ("stream", "fused")


def _validated_stream_impl(x2: torch.Tensor, bs: int, bc: int, cfg: ZebraConfig,
                           w: torch.Tensor | None = None, *, site: str = "",
                           out_dtype=None):
    """The stream/fused pipeline with ``compress.integrity``'s contract
    checked between producer and consumer: comparator + pack -> (chaos
    tap) -> ``check_stream`` -> the expander (``w`` None) or the payload
    GEMM. A failed check takes the ``ft.faults`` policy
    "recompute-dense": the masking kernel on ``x2``, the dense source
    still in hand (then, with ``w``, a float32 matmul by ``w``, cast
    back), and ``integrity.note_failure``. The checksum level seals the
    stream before the tap, so corruption in flight breaks the fold.

    Returns ``(y2, bitmap of the branch taken, stream bytes, n_cols)``;
    with ``w``, y2 in ``out_dtype`` where given.

    The branch is chosen on the host: reading the verdict costs one
    device sync per site, where the reference's ``lax.cond`` has none.
    Computing both branches and blending them with ``torch.where`` would
    run the recovery (a masking pass, and with ``w`` a dense matmul) at
    every site of every call."""
    level = cfg.validation
    tag = f"engine:{site or 'map'}"
    payload, bitmap, n_live, keep, slot = mask_pack_with_slots(
        x2, t_obj=cfg.t_obj, bs=bs, bc=bc)
    csum = (integrity.stream_checksum(payload, bitmap, n_live)
            if level == "checksum" else None)
    produced = bitmap
    payload, bitmap, n_live = stream_tap(payload, bitmap, n_live, site=tag)
    ok = integrity.check_stream(payload, bitmap, n_live, level=level, checksum=csum,
                                live_nonzero=cfg.t_obj > 0)
    if bool(ok):
        if bitmap is not produced:      # a tapped bitmap has slots of its own
            keep, slot = slot_map(bitmap)
        if w is None:
            y2 = unpack_with_slots(payload, bitmap, keep, slot, bs=bs, bc=bc)
        else:
            y2 = _consume_fused(payload, w, bitmap, keep, slot, bs, bc, x2.dtype, out_dtype)
    else:
        integrity.note_failure(tag)
        y2, bitmap = zebra_mask(x2, t_obj=cfg.t_obj, bs=bs, bc=bc)
        if w is not None:
            # a plain float32 product outside any kernel, as the reference
            # computes it (TF32 is off: torch's default, and set so by the
            # entry points on the card)
            y2 = (y2.float() @ w.float()).to(out_dtype or x2.dtype)
    measured = stream_bytes(bitmap.to(torch.int64).sum(), bs, bc, x2.dtype,
                            bitmap.numel())
    return y2, bitmap, measured, (None if w is None else w.shape[-1])


# ---------------------------------------------------------------------------
# Capability resolution
# ---------------------------------------------------------------------------

def _resolve_backend(spec: BackendSpec, *, mode: str, tnet,
                     degenerate: bool, over_budget: bool = False
                     ) -> tuple[str, str | None]:
    """Map one site's situation onto a backend the spec can serve.

    Returns ``(final backend name, degrade reason | None)``, with the
    reference engine's reasons and precedence."""
    if spec.name == "reference":
        return "reference", None
    if mode == "train" and not spec.trainable:
        return "reference", "not-trainable"
    if mode == "train" and tnet is not None:
        return "reference", "tnet"
    if degenerate:
        return "reference", "degenerate-rows"
    if spec.vmem_bounded and over_budget:
        return "reference", "vmem-bounded"
    return spec.name, None


def _log_degrade(site: str, requested: str, reason: str) -> None:
    key = (site, requested, reason)
    if key not in _DEGRADE_LOGGED:
        _DEGRADE_LOGGED.add(key)
        _log.info("zebra_site %r: backend %r degraded to reference (%s)",
                  site, requested, reason)


def wants_fused(cfg: ZebraConfig, site: str = "") -> bool:
    """True when this site should hand its downstream weight to the engine:
    the configured backend consumes ``w`` and capability resolution keeps
    it (a train-mode request on a non-trainable w-consumer degrades, so the
    caller keeps its dense matmul)."""
    if not cfg.enabled:
        return False
    spec = backend_spec(cfg.backend_for(site))
    if not spec.consumes_w or spec.name == "reference":
        return False
    final, _ = _resolve_backend(spec, mode=cfg.mode, tnet=None, degenerate=False)
    return final == spec.name


# ---------------------------------------------------------------------------
# The engine entry point
# ---------------------------------------------------------------------------

def zebra_site(x: torch.Tensor, cfg: ZebraConfig, *, site: str = "",
               layout: str = "tokens", tnet=None, w: torch.Tensor | None = None,
               split: bool | str = False) -> tuple[torch.Tensor, SiteAux]:
    """Execute one Zebra activation site through the configured backend.

    x       ``tokens``: (..., S, D) activation map (leading dims = batch);
            ``nchw``: (B, C, H, W) CNN map.
    site    name used for per-site backend overrides (cfg.site_backends).
    tnet    threshold net (``core.zebra.ThresholdNet``); train-mode sites
            with one resolve to reference.
    w       downstream weight (K, N), for backends that consume one
            (reference, fused): the site then returns ``mask(x) @ w``.

    split   tensor parallelism only: True, x is this rank's equal slice of
            the map's last axis over the ``model`` axis; ``"rows"``, of its
            rows, every data rank holding the same map (an MoE dispatch);
            False, every model rank holds the whole map.

    Returns ``(y, SiteAux)``. Without ``w``, y is the masked map (bitwise
    identical on reference, pallas and stream); with ``w``, the product,
    dead blocks skipped on fused. Under a tensor-parallel layout
    (``distributed.ctx.tensor_parallel``) the site is that of the logical
    whole map (:func:`_tp_site`)."""
    if layout == "tokens":
        from ..distributed.ctx import tensor_parallel
        tp = tensor_parallel()
        if tp is not None:
            return _tp_site(x, cfg, tp, site=site, tnet=tnet, w=w, split=split)
    if split:
        raise ValueError("zebra_site(split=True) needs a tensor-parallel layout "
                         "(distributed.ctx.sharding_hints on a mesh)")
    return _site(x, cfg, site=site, layout=layout, tnet=tnet, w=w)


def _site(x: torch.Tensor, cfg: ZebraConfig, *, site: str = "", layout: str = "tokens",
          tnet=None, w: torch.Tensor | None = None,
          out_dtype=None) -> tuple[torch.Tensor, SiteAux]:
    """One site in one process: :func:`zebra_site`'s backends. With ``w``,
    ``out_dtype`` (float32 for a row-parallel partial) widens the product's
    dtype."""
    spec = backend_spec(cfg.backend_for(site))
    if w is not None and not spec.consumes_w:
        raise ValueError(
            f"backend {spec.name!r} does not consume a downstream weight "
            f"(site={site!r}); apply the matmul at the call site instead")
    if not cfg.enabled:
        return (x if w is None else _matmul(x, w, out_dtype)), SiteAux.empty(device=x.device)
    tnet = effective_tnet(cfg, tnet)
    require_tnet(cfg, tnet, site)

    if layout == "nchw":
        B, C, H, W = x.shape
        b = site_block(H, W, cfg.block_hw)
        cfg = cfg.replace(block_hw=b)
        bs = bc = b
        dims = (B * C * H, W)
        nb_sample = C * (H // b) * (W // b)
        degenerate = False
    elif layout == "tokens":
        if x.dim() == 2:                # bare (M, K) map: one-sample batch
            y, aux = _site(x[None], cfg, site=site, layout=layout, tnet=tnet, w=w,
                           out_dtype=out_dtype)
            return y[0], aux
        bs, bc, degenerate = _tokens_blocks(x, cfg)
        cfg = cfg.replace(block_seq=bs, block_ch=bc)
        S, D = x.shape[-2], x.shape[-1]
        dims = (x.numel() // D, D)
        nb_sample = (S // bs) * (D // bc)
    else:
        raise ValueError(f"unknown layout {layout!r}")

    backend, reason = _resolve_backend(spec, mode=cfg.mode, tnet=tnet,
                                       degenerate=degenerate)
    if reason is not None:
        _log_degrade(site, spec.name, reason)
    label = backend if reason is None else f"{backend}({reason})"

    if backend == "reference":
        fn = zebra_cnn if layout == "nchw" else zebra_tokens
        y, aux = fn(x, cfg, tnet)
        if w is not None:               # w-consuming request served dense
            y = _matmul(y, w, out_dtype)
        return y, SiteAux(reg=aux["reg"], zero_frac=aux["zero_frac"],
                          measured_bytes=torch.zeros((), dtype=torch.int64,
                                                     device=x.device),
                          n_blocks=aux["n_blocks"],
                          thresholds=aux["thresholds"], backend=label, keep=aux.get("keep"))

    x2 = x.contiguous().reshape(dims)
    no_bytes = torch.zeros((), dtype=torch.int64, device=x.device)
    if (cfg.mode != "train" and cfg.validation != "off"
            and backend in _VALIDATED_BACKENDS):
        y2, bitmap, measured, n_cols = _validated_stream_impl(
            x2, bs, bc, cfg, w if backend == "fused" else None, site=site,
            out_dtype=out_dtype)
        y = (y2.reshape(x.shape) if n_cols is None
             else y2.reshape(*x.shape[:-1], n_cols))
        return y, SiteAux(reg=torch.zeros((), dtype=torch.float32, device=x.device),
                          zero_frac=zero_fraction(bitmap), measured_bytes=measured,
                          n_blocks=nb_sample, thresholds=None, backend=label, keep=bitmap)
    if backend == "fused":
        # infer only (fused is not trainable). With w: the payload GEMM;
        # without: the pallas masking pass, which moves no stream bytes
        if w is not None:
            y2, bitmap, measured = _run_fused(x2, w, bs, bc, cfg, out_dtype)
            y = y2.reshape(*x.shape[:-1], w.shape[-1])
        else:
            y2, bitmap, _ = launch_forward(x2, _kernel_statics("mask", bs, bc, cfg))
            y, measured = y2.reshape(x.shape), no_bytes
        return y, SiteAux(reg=torch.zeros((), dtype=torch.float32, device=x.device),
                          zero_frac=zero_fraction(bitmap), measured_bytes=measured,
                          n_blocks=nb_sample, thresholds=None, backend=label, keep=bitmap)
    # pallas: one masking pass ("mask"); stream: mask_pack -> unpack with
    # only the (payload, bitmap) stream in between ("stream"). In train
    # mode the same launches run under the configured gradient mode.
    statics = _kernel_statics(spec.grad_variant, bs, bc, cfg)
    launch = zebra_kernel_trainable if cfg.mode == "train" else launch_forward
    y2, bitmap, n_live = launch(x2, statics)
    # the observables come from the launch's bitmap and n_live, which
    # carry no gradient; a dense map moves no stream bytes
    measured = (stream_bytes(n_live, bs, bc, x2.dtype, bitmap.numel()) if spec.emits_stream
                else no_bytes)
    zero_frac = zero_fraction(bitmap)
    # train mode: the realised Eq. 1 observable under the constant threshold
    reg = (zero_frac * nb_sample if cfg.mode == "train"
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return y2.reshape(x.shape), SiteAux(
        reg=reg, zero_frac=zero_frac, measured_bytes=measured,
        n_blocks=nb_sample, thresholds=None, backend=label, keep=bitmap)


# ---------------------------------------------------------------------------
# Tensor parallelism: a site of the logical whole map
# ---------------------------------------------------------------------------

_TP_SITE_LOG: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tp_sites",
                                                            default=None)


_AUX_UNREAD: contextvars.ContextVar = contextvars.ContextVar("repro_torch_aux_unread",
                                                             default=False)


@contextlib.contextmanager
def aux_unread():
    """The sites run inside have their aux dropped by their caller (a
    decode step): the tensor-parallel path does not sum their block counts
    over the mesh, and returns each rank's own aux."""
    tok = _AUX_UNREAD.set(True)
    try:
        yield
    finally:
        _AUX_UNREAD.reset(tok)


@contextlib.contextmanager
def record_tp_sites(bitmaps: bool = False):
    """Record every tensor-parallel site run inside (for checks: nothing
    of it reaches the host, and no collective runs for it, until
    :func:`tp_sites_on_host`). Yields the list, one entry a site; with
    ``bitmaps`` each entry also keeps the site's keep flags on its
    device."""
    log: list[dict] = []
    tok = _TP_SITE_LOG.set((log, bitmaps))
    try:
        yield log
    finally:
        _TP_SITE_LOG.reset(tok)


def tp_sites_on_host(log: list[dict]) -> list[dict]:
    """The sites :func:`record_tp_sites` recorded, on the host: a dict a
    site (name, rule, label, the whole map's live and total block counts,
    per-sample block count, zero fraction, bytes, rows and width, and the
    axis its map is split along, ``"cols"`` or ``"rows"``; where recorded,
    ``keep``, the whole map's flags as int8, a ``"blocks"`` site's shards
    gathered over the model axis in rank order). Every model
    rank calls it at the same point after the run: it runs one
    collective a recorded ``"blocks"`` site."""
    from ..distributed.collectives import Wire
    out = []
    for e in log:
        e = dict(e)
        axis, keep = e.pop("axis"), e.pop("keep")
        e["zero_frac"], e["measured_bytes"] = float(e["zero_frac"]), int(e["measured_bytes"])
        if keep is not None:
            k8 = keep.to(torch.int8)
            if e["rule"] == "blocks" and axis.size > 1:
                k8 = torch.cat(Wire(axis).all_gather(k8).unbind(0),
                               dim=0 if e["split"] == "rows" else -1)
            e["keep"] = k8.cpu()
        out.append(e)
    return out


def tp_site_rule(width: int, split: bool, m: int, block_ch: int) -> str:
    """How a tensor-parallel site runs its map of local extent ``width``
    along its split axis (its columns; for a map split by rows, its rows
    with ``block_ch`` the block's rows): ``"whole"`` (the map is
    replicated over the model axis: counted once), ``"blocks"`` (split on
    Zebra block edges: each rank runs its shard) or ``"gather"`` (a shard
    would cut a block: the map is gathered, the site runs on it whole and
    each rank keeps its own part)."""
    if not split or m == 1:
        return "whole"
    D = width * m
    bc = block_ch if D % block_ch == 0 else D
    return "blocks" if width % bc == 0 else "gather"


def _tp_site(x: torch.Tensor, cfg: ZebraConfig, tp, *, site: str, tnet, w, split):
    """One site under tensor parallelism, with the observables of the
    logical whole map, the one the reference's partitioned program masks.

    The map is (..., S, D). With ``split`` False or True its rows are this
    rank's share of the batch (the whole batch under a layout whose
    ``data`` axis has one rank: ``distributed.ctx.tensor_parallel`` with a
    batch replicated over ``data``) and, with True, its columns this rank's
    slice over the model axis. With ``split == "rows"`` (the MoE dispatch
    map: this rank's experts' capacity slots) its rows are this rank's
    slice over the model axis, and every data rank holds the same map
    (the dispatch is global over ``data``). :func:`tp_site_rule` picks how
    it runs, on the columns' block edges or, split by rows, the rows'. With ``w`` (a w-consuming
    backend) the product returned is the whole ``mask(x) @ w`` on every
    rank: on ``"blocks"`` ``w`` is this rank's rows and the partial
    products are summed over the model axis; on ``"gather"`` and
    ``"whole"`` ``w`` is whole. Without ``w`` the masked map comes back in
    x's layout.

    The aux is the whole map's: the live blocks every rank owns (its shard
    on ``"blocks"``, the model axis's first rank's map otherwise; split by
    rows, the first data rank's alone) summed over the layout's ``world``, the zero
    fraction rounded as :func:`zero_fraction` rounds it, the stream bytes
    by :func:`stream_bytes` with the global block count (summing per-rank
    bytes would count the index padding once a rank). Every rank reaches
    that sum, in the forward and in a recompute alike, unless the caller
    drops the aux (:func:`aux_unread`).

    Train mode: the forward is serving's; the backward follows the rule,
    ``"blocks"`` local, ``"gather"`` the gathered map's gradient cut back
    to this rank's part (``distributed.ctx.gather_model``), ``"whole"``
    as in one process. At a constant threshold the reg slot is the whole
    map's realised zero-block count. A threshold net sees the whole map,
    so a site with one gathers a split map whatever its block edges
    (:class:`_TPNet`: its ``w``, cut over the model axis by rows, meets this
    rank's channels of the GAP and the partial thresholds are summed); its
    Eq. 1 term is that of this data rank's rows (split by rows: of the
    whole dispatch map), replicated over the model axis. A map split by
    rows meets the net's channel cut across its own row cut, so each
    rank's gradient of the gathered map reaches other ranks' rows through
    the GAP: it is gathered by ``gather_model_split``, whose backward sums
    the gradient over the model axis before keeping this rank's rows."""
    from ..distributed.ctx import gather_model, gather_model_split, psum_model
    if not cfg.enabled:
        if w is not None:
            raise ValueError("a disabled site takes no weight under tensor parallelism")
        return x, SiteAux.empty(device=x.device)
    m = tp.model.size
    rows = split == "rows"
    if rows and w is not None:
        raise NotImplementedError(f"site {site!r}: a map split by rows takes no weight")
    width = x.shape[-1]
    S = x.shape[-2] if x.dim() > 1 else 1
    axis = -2 if rows else -1
    if rows:
        rule = tp_site_rule(S, True, m, cfg.block_seq)
    else:
        rule = tp_site_rule(width, split, m, cfg.block_ch)
    D = width * m if split is True else width
    tnet = effective_tnet(cfg, tnet) if cfg.mode == "train" else None
    if tnet is not None:
        if cfg.grad_mode == "soft":
            raise NotImplementedError("a soft-gated threshold net under tensor parallelism")
        rule = "gather" if rule == "blocks" else rule
        tnet = _TPNet(tnet, tp.model)
    if rule == "gather":
        if w is not None and w.shape[0] != D:
            raise ValueError(f"site {site!r}: a gathered map of width {D} needs the whole "
                             f"weight, got {tuple(w.shape)}")
        gather = gather_model_split if rows and tnet is not None else gather_model
        y, aux = _site(gather(x, axis), cfg, site=site, tnet=tnet, w=w)
        if w is None:
            n = x.shape[axis]
            y = y.narrow(axis, tp.model.index * n, n).contiguous()
    else:
        # row-parallel w: float32 partial products, rounded once after
        # their sum (as ``ctx.row_parallel``)
        sums = torch.float32 if w is not None and rule == "blocks" else None
        y, aux = _site(x, cfg, site=site, tnet=tnet, w=w, out_dtype=sums)
        if sums is not None:
            y = psum_model(y).to(torch.promote_types(x.dtype, w.dtype))
    if aux.keep is None or _AUX_UNREAD.get():   # nothing ran, or nobody reads it
        return y, aux
    from ..distributed.collectives import tp_all_reduce
    owned = (rule == "blocks" or tp.model.index == 0) and (not rows or tp.data.index == 0)
    keep = aux.keep.reshape(-1, aux.keep.shape[-1])
    live = keep.sum(dtype=torch.int64) if owned else torch.zeros((), dtype=torch.int64,
                                                                  device=x.device)
    live = tp_all_reduce(live, tp.world)
    if rows:                    # the whole map: every rank's rows, whole over data
        S, n_rows = S * m, x.numel() // width * m
    else:
        n_rows = x.numel() // width * tp.data.size
    bs = cfg.block_seq if S % cfg.block_seq == 0 else 1
    bc = cfg.block_ch if D % cfg.block_ch == 0 else D
    n_total = (n_rows // bs) * (D // bc)
    zero_frac = zero_fraction_of(live, n_total)
    # a backend that moves stream bytes reports them (the index alone is
    # more than 0); the rest report none
    measured = torch.where(aux.measured_bytes > 0, stream_bytes(live, bs, bc, x.dtype, n_total),
                           torch.zeros_like(live))
    n_blocks = (S // bs) * (D // bc)
    reg = aux.reg
    if cfg.mode == "train" and tnet is None:
        reg = zero_frac * n_blocks      # the whole map's realised zero-block count
    out = dataclasses.replace(aux, reg=reg, zero_frac=zero_frac, measured_bytes=measured,
                              n_blocks=n_blocks)
    rec = _TP_SITE_LOG.get()
    if rec is not None and torch._C._current_graph_task_id() == -1:
        # read on the host after the run (tp_sites_on_host); a recompute
        # inside the backward records nothing
        log, bitmaps = rec
        log.append({"site": site, "rule": rule, "backend": aux.backend, "n_total": n_total,
                    "n_blocks": out.n_blocks, "zero_frac": zero_frac, "measured_bytes": measured,
                    "rows": n_rows, "width": D, "split": "rows" if rows else "cols",
                    "keep": keep if bitmaps else None, "axis": tp.model})
    return y, out


class _TPNet:
    """A threshold net under tensor parallelism, applied to the GAP of the
    whole map: a net whose ``w`` is cut over the model axis by rows (the
    map's channels; ``distributed.sharding``) takes this rank's channels of
    the GAP, and the partial thresholds are summed over the axis
    (``row_parallel``: the thresholds' consumers are replicated, so the
    gradient passes through to each rank's rows of ``w``); a whole ``w``
    is applied as in one process."""

    def __init__(self, net, axis):
        self.net, self.axis = net, axis

    def __call__(self, gap: torch.Tensor) -> torch.Tensor:
        from ..distributed.ctx import row_parallel
        w = self.net.w
        if w.shape[0] == gap.shape[-1]:
            return self.net(gap)
        n = w.shape[0]
        return row_parallel(gap.narrow(-1, self.axis.index * n, n), w) + self.net.b
