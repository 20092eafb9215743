"""The LM stack of the port (``repro.models.lm``): dense attention layers
(global and local) with SwiGLU/GELU FFNs and their Zebra sites."""
from .config import LMConfig  # noqa: F401
from .model import LM, layer_runs  # noqa: F401
