"""Model zoo of the port: the ResNet family and the ViT family, ``vit_moe``
included.

``get_model`` resolves the JAX package's zoo names.
"""

from .from_jax import (
    ResNetPortError,
    VitPortError,
    resnet_from_jax,
    resnet_to_jax,
    vit_from_jax,
    vit_to_jax,
)
from .moe import SwitchFFN
from .norms import BatchNorm2d, LayerNorm, sync_batch_norm_
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .vit import ViT, ViTBlock, ViTLong, ViTMoE, ViTSmall, ViTTiny

_ZOO = {
    "resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
    "resnet101": ResNet101, "resnet152": ResNet152,
    "vit_tiny": ViTTiny, "vit_small": ViTSmall, "vit_long": ViTLong, "vit_moe": ViTMoE,
}


def get_model(name: str, **kwargs):
    """Build a zoo model by CLI name (e.g. ``"resnet18"``, ``"vit_moe"``)."""
    try:
        ctor = _ZOO[name.lower()]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; choices: {sorted(_ZOO)}") from None
    return ctor(**kwargs)


__all__ = [
    "BasicBlock", "BatchNorm2d", "Bottleneck", "LayerNorm", "ResNet", "ResNet18",
    "ResNet34", "ResNet50", "ResNet101", "ResNet152", "ResNetPortError", "SwitchFFN",
    "ViT", "ViTBlock", "ViTLong", "ViTMoE", "ViTSmall", "ViTTiny", "VitPortError",
    "get_model", "resnet_from_jax", "resnet_to_jax", "sync_batch_norm_", "vit_from_jax",
    "vit_to_jax",
]
