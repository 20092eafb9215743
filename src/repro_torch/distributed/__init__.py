"""The distributed package (``repro.distributed``): the context that says
which mesh and which exchange axis model code runs under (``ctx``), the
sharding rules (``sharding``) and the compressed collectives
(``collectives``, imported by their users)."""
from . import sharding  # noqa: F401
from .ctx import (CommAxis, comm_axis, comm_context, dp_axes,  # noqa: F401
                  sharding_hints, tp_axis)
