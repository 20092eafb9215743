"""BackendSpec registry — the capability contract of the Zebra site engine.

The same four backends, with the same names and capabilities, as
``repro.core.backends``, so that ``SiteAux.backend`` labels (including
the ``"reference(<reason>)"`` degrade labels) compare equal across the
two packages. What each capability means:

``trainable``      the backend has training semantics (a backward that
                   implements the hard/STE/soft gradient modes).
``emits_stream``   it moves the compressed ``(payload, 1-bit index)``
                   stream, so ``SiteAux.measured_bytes`` is live.
``consumes_w``     it may take the downstream weight and return the
                   product instead of the masked map.
``vmem_bounded``   its whole-map working set must fit a memory budget
                   (TPU machinery; every built-in backend declares False).
``payload_order``  the slot order of the payload it emits or consumes;
                   ``"consumer"`` is the column-grouped order of
                   ``kernels.schedule``.
``grad_variant``   which forward variant its trainable path runs.
``comms``          how its maps cross devices in layer exchanges.

Which backends *execute* in the port is the engine's business
(``core.engine``): the registry declares capabilities only.
"""
from __future__ import annotations

import dataclasses

PAYLOAD_ORDERS = ("consumer",)
COMM_MODES = ("compressed",)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    trainable: bool
    emits_stream: bool
    consumes_w: bool
    vmem_bounded: bool
    grad_variant: str | None = None
    payload_order: str | None = None
    comms: str | None = None


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    if spec.trainable and spec.name != "reference" and spec.grad_variant is None:
        raise ValueError(
            f"backend {spec.name!r}: trainable kernel backends must declare "
            f"a grad_variant")
    if spec.emits_stream and spec.payload_order is None:
        raise ValueError(
            f"backend {spec.name!r}: stream-emitting backends must declare "
            f"the payload slot order (payload_order)")
    if spec.payload_order is not None and spec.payload_order not in PAYLOAD_ORDERS:
        raise ValueError(
            f"backend {spec.name!r}: unknown payload_order "
            f"{spec.payload_order!r}; expected one of {PAYLOAD_ORDERS}")
    if spec.comms is not None and spec.comms not in COMM_MODES:
        raise ValueError(
            f"backend {spec.name!r}: unknown comms mode {spec.comms!r}; "
            f"expected one of {COMM_MODES}")
    if spec.comms == "compressed" and not spec.emits_stream:
        raise ValueError(
            f"backend {spec.name!r}: comms='compressed' requires "
            f"emits_stream=True")
    _REGISTRY[spec.name] = spec
    return spec


def backend_spec(name: str) -> BackendSpec:
    """Resolve a backend name; raises with the known set on a bad name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown zebra backend {name!r}; expected one of "
                         f"{backend_names()}") from None


def backend_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def validate_backend(name: str) -> str:
    backend_spec(name)
    return name


register_backend(BackendSpec(
    "reference", trainable=True, emits_stream=False, consumes_w=True,
    vmem_bounded=False))
register_backend(BackendSpec(
    "pallas", trainable=True, emits_stream=False, consumes_w=False,
    vmem_bounded=False, grad_variant="mask"))
register_backend(BackendSpec(
    "stream", trainable=True, emits_stream=True, consumes_w=False,
    vmem_bounded=False, grad_variant="stream", payload_order="consumer",
    comms="compressed"))
register_backend(BackendSpec(
    "fused", trainable=False, emits_stream=True, consumes_w=True,
    vmem_bounded=False, payload_order="consumer", comms="compressed"))
