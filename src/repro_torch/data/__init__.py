from .synthetic import (SYN_CIFAR10, SYN_TINYIMAGENET,  # noqa: F401
                        ImageDatasetConfig, StreamingLoader, image_batch)
