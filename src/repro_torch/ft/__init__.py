"""Fault tolerance of the stream paths (``repro.ft``): the failure
taxonomy, the per-site circuit breaker and deterministic fault injection.
The step supervisor, the checkpoint and ring-hop taps and the crash
injectors wait for their consumers (ROADMAP.md, module queue)."""
from .faults import (  # noqa: F401
    CorruptStream,
    DeadlineExceeded,
    DeviceLoss,
    FaultError,
    Overload,
    PoisonBatch,
    TransientStep,
    classify,
    policy_for,
)
from .breaker import (  # noqa: F401
    BreakerBoard,
    BreakerConfig,
    CircuitBreaker,
    active_board,
    breaker_scope,
)
from .inject import (  # noqa: F401
    Fault,
    FaultPlan,
    active_plan,
    corrupt_map,
    inject,
    stream_tap,
)
