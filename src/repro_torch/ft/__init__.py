"""Fault tolerance (``repro.ft``): the failure taxonomy, the per-site
circuit breaker, deterministic fault injection and the training step
supervisor. The supervisor's remesh and the ring-hop and engine-tick taps
wait for the distributed and serving items (ROADMAP.md, module queue)."""
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
    corrupt_file,
    corrupt_map,
    crashing_step,
    inject,
    stream_tap,
)
from .supervisor import FailurePolicy, FTConfig, StepSupervisor  # noqa: F401
