"""Kernels of the port and their plain PyTorch versions."""

from .attention import (
    attention,
    auto_impl,
    flash_attention,
    flash_attention_bwd_reference,
    mha_reference,
)
from .attention_small import small_mha

__all__ = [
    "attention", "auto_impl", "flash_attention", "flash_attention_bwd_reference",
    "mha_reference", "small_mha",
]
