from .compress import CompressionState, compressed_gradients, init_state  # noqa: F401
from .optimizers import (Optimizer, adamw, apply_updates, clip_by_global_norm,  # noqa: F401
                         clip_by_global_norm_, sgd)
from .schedule import constant, cosine, step_decay, warmup_cosine  # noqa: F401
