"""Checkpoints of the train state and of compressed activation maps
(``repro.checkpoint``)."""
from .manager import (CheckpointManager, load_compressed_acts, load_pytree,  # noqa: F401
                      save_compressed_acts)
