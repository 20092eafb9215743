from .common import accuracy, cross_entropy, topk_accuracy  # noqa: F401
from .mobilenet import MobileNetV1  # noqa: F401
from .resnet import ResNet, resnet18, resnet56  # noqa: F401
from .vgg import VGG16  # noqa: F401


def build(name: str, num_classes: int = 10, in_hw: int = 32,
          width_mult: float = 1.0, **kw):
    """The CNN by name; ``kw`` (``use_tnet``, ``generator``) goes to the
    model's constructor."""
    name = name.lower()
    if name == "vgg16":
        return VGG16(num_classes, in_hw, width_mult, **kw)
    if name in ("resnet18", "resnet-18"):
        return resnet18(num_classes, in_hw, width_mult, **kw)
    if name in ("resnet56", "resnet-56"):
        return resnet56(num_classes, in_hw, width_mult, **kw)
    if name in ("mobilenet", "mobilenetv1"):
        return MobileNetV1(num_classes, in_hw, width_mult, **kw)
    raise ValueError(f"unknown CNN {name!r}")
