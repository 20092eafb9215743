"""Fault tolerance (``repro.ft``): the failure taxonomy, the per-site
circuit breaker, deterministic fault injection (the stream taps, the
checkpoint and step faults, and the serving engine's tick tap
``crash_tap``, and the collectives' ring-hop tap ``ring_hop_tap``) and the
training step supervisor, whose ``FailurePolicy`` the serving engine
shares, and the elastic re-mesh of a sharded train state
(``remesh_state``)."""
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
    ENGINE_TICK_SITE,
    Fault,
    FaultPlan,
    active_plan,
    corrupt_file,
    corrupt_map,
    crash_tap,
    crashing_step,
    inject,
    ring_hop_tap,
    stream_tap,
)
from .supervisor import (FailurePolicy, FTConfig, StepSupervisor, remesh_model,  # noqa: F401
                         remesh_state)
