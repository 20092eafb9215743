from .synthetic import (SYN_CIFAR10, SYN_TINYIMAGENET,  # noqa: F401
                        ImageDatasetConfig, LMDatasetConfig, StreamingLoader,
                        image_batch, lm_batch)
