"""Model zoo of the port: the ViT family, ``vit_moe`` included.

``get_model`` resolves the JAX package's zoo names.  The ResNet family is
not ported yet and raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from .from_jax import VitPortError, vit_from_jax
from .moe import SwitchFFN
from .vit import ViT, ViTBlock, ViTLong, ViTMoE, ViTSmall, ViTTiny

_ZOO = {
    "vit_tiny": ViTTiny, "vit_small": ViTSmall, "vit_long": ViTLong, "vit_moe": ViTMoE,
}
_NOT_PORTED = {
    name: "ROADMAP.md queue 1, 'ResNet-18 training' (models/resnet.py)"
    for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
}


def get_model(name: str, **kwargs):
    """Build a zoo model by CLI name (e.g. ``"vit_moe"``)."""
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: {_NOT_PORTED[key]}"
        )
    try:
        ctor = _ZOO[key]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choices: {sorted(_ZOO) + sorted(_NOT_PORTED)}"
        ) from None
    return ctor(**kwargs)


__all__ = [
    "SwitchFFN", "ViT", "ViTBlock", "ViTLong", "ViTMoE", "ViTSmall", "ViTTiny",
    "VitPortError", "get_model", "vit_from_jax",
]
