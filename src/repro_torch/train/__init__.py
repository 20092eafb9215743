from .cnn_trainer import CNNTrainConfig, CNNTrainer, resolve_device  # noqa: F401
