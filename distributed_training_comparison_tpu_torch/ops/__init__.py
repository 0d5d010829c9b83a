"""Kernels of the port and their plain PyTorch versions."""

from .attention import (
    attention,
    auto_impl,
    flash_attention,
    flash_attention_bwd_reference,
    mha_reference,
)

__all__ = [
    "attention", "auto_impl", "flash_attention", "flash_attention_bwd_reference",
    "mha_reference",
]
