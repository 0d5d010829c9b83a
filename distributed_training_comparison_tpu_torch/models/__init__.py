"""Model zoo of the port: the ViT family.

``get_model`` resolves the JAX package's zoo names.  The ResNet family and
``vit_moe`` are not ported yet and raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from .from_jax import VitPortError, vit_from_jax
from .vit import ViT, ViTBlock, ViTLong, ViTSmall, ViTTiny

_ZOO = {"vit_tiny": ViTTiny, "vit_small": ViTSmall, "vit_long": ViTLong}
_NOT_PORTED = {
    **{
        name: "ROADMAP.md queue 1, 'ResNet-18 training' (models/resnet.py)"
        for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
    },
    "vit_moe": "ROADMAP.md queue 1, 'vit_moe' (models/moe.py, kernels K7-K9)",
}


def get_model(name: str, **kwargs):
    """Build a zoo model by CLI name (e.g. ``"vit_long"``)."""
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
    "ViT", "ViTBlock", "ViTLong", "ViTSmall", "ViTTiny",
    "VitPortError", "get_model", "vit_from_jax",
]
