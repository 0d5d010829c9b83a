"""Kernels of the port and their plain PyTorch versions.

Every wrapper that launches a CUDA kernel counts its launches in a
plain-int ``launches`` attribute; :func:`counted_wrappers` lists them, as
their modules hold them at the call, so that a CUDA graph of the step
program (``utils/graphs.py``) can keep the counts true across replays.
"""

import importlib

from .attention import (
    attention,
    auto_impl,
    flash_attention,
    flash_attention_bwd_reference,
    mha_reference,
)
from .attention_small import small_mha

# the wrappers that count their kernel launches, by module of this package
COUNTED_WRAPPERS = {
    "attention": ("flash_attention", "flash_attention_dq", "flash_attention_dkv"),
    "attention_small": ("small_mha_fwd", "small_mha_bwd"),
    "moe_gmm": ("grouped_ffn_fwd", "grouped_ffn_dx", "grouped_ffn_dw"),
    "vit_block": (
        "fused_vit_block", "block_gemm", "block_attention", "fused_vit_block_bwd",
        "block_ln", "block_gemm_dgrad", "block_ln_bwd", "block_gemm_wgrad",
        "block_attention_bwd", "block_grad_reduce",
    ),
}


_MODULES: list = []


def counted_wrappers() -> tuple:
    """Every counted wrapper (``COUNTED_WRAPPERS``) as its module holds it
    now: a rebound one (a planted fault) is the one listed."""
    if not _MODULES:
        _MODULES.extend((importlib.import_module(f"{__name__}.{module}"), names)
                        for module, names in COUNTED_WRAPPERS.items())
    return tuple(getattr(module, name) for module, names in _MODULES for name in names)


__all__ = [
    "COUNTED_WRAPPERS", "attention", "auto_impl", "counted_wrappers", "flash_attention",
    "flash_attention_bwd_reference", "mha_reference", "small_mha",
]
