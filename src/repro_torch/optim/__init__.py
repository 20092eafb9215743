from .optimizers import Optimizer, adamw, apply_updates, clip_by_global_norm, sgd  # noqa: F401
from .schedule import constant, cosine, step_decay, warmup_cosine  # noqa: F401
