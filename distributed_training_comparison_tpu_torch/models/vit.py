"""Vision Transformer family (``distributed_training_comparison_tpu/models/vit.py``).

The same model, widths and numerics as the flax ``ViT``: patch embed →
``depth`` pre-LN blocks → LN → mean pool over tokens → linear head, with
``embed`` / ``trunk`` / ``head_out`` kept separate.  Under a bf16 compute
dtype the parameters stay fp32 and are cast at each use (flax
``nn.Dense(dtype=bf16)`` casts input, kernel and bias and adds the bias in
bf16), the residual stream stays in the compute dtype, LayerNorm reduces in
fp32 (``norms.py``), the MLP's gelu is the tanh approximation (flax's
default) and the logits are fp32.

Attention goes through ``ops.attention`` with the (B, S, H, D) layout: on
the card at long sequences that is the CUDA flash-attention kernel, read
in place through a transposed view.  The fused whole-block kernel of the
JAX package (``ops/vit_block.py``, K5) is not ported yet, so
``block_fusion="auto"`` always composes, also in the 128-512 token window
where the JAX package would take K5, and ``"force"`` raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .norms import LayerNorm


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense(dtype=...)`` numerics: fp32
    parameters, input, weight and bias cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype) -> None:
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class ViTBlock(nn.Module):
    """Pre-LN transformer block with separate q/k/v projections."""

    def __init__(
        self,
        dim: int,
        heads: int,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
        attn_impl: str = "auto",
    ) -> None:
        super().__init__()
        self.heads = heads
        self.attn_impl = attn_impl
        self.ln_attn = LayerNorm(dim, dtype, norm_dtype)
        self.q_proj = Dense(dim, dim, dtype)
        self.k_proj = Dense(dim, dim, dtype)
        self.v_proj = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.ln_mlp = LayerNorm(dim, dtype, norm_dtype)
        self.mlp_up = Dense(dim, mlp_ratio * dim, dtype)
        self.mlp_down = Dense(mlp_ratio * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        hd = dim // self.heads
        h = self.ln_attn(x)
        q = self.q_proj(h).view(b, s, self.heads, hd)
        k = self.k_proj(h).view(b, s, self.heads, hd)
        v = self.v_proj(h).view(b, s, self.heads, hd)
        o = attention(q, k, v, impl=self.attn_impl, layout="bshd")
        x = x + self.proj(o.reshape(b, s, dim))
        h = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_down(h)


class ViT(nn.Module):
    """Patch embed → ``depth`` blocks → LN → mean pool → linear head.

    Input: normalized images (B, H, W, 3), NHWC like the JAX package.
    """

    def __init__(
        self,
        depth: int,
        dim: int,
        heads: int,
        patch: int = 4,
        mlp_ratio: int = 4,
        num_classes: int = 100,
        image_size: int = 32,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
        attn_impl: str = "auto",
        block_fusion: str = "auto",
    ) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(
                f"ViT dim ({dim}) must be divisible by heads ({heads}); "
                "per-head dim would not be integral"
            )
        if block_fusion == "force":
            raise NotImplementedError(
                "block_fusion='force' needs the fused ViT block kernel "
                "(K5, ops/vit_block.py::_block_fwd_kernel), which is not "
                "ported yet (ROADMAP.md queue 2); use 'auto' or 'off'"
            )
        if block_fusion not in ("auto", "off"):
            raise ValueError(f"unknown block_fusion {block_fusion!r}")
        self.patch = patch
        self.dim = dim
        self.image_size = image_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        tokens = (image_size // patch) ** 2
        self.pos_emb = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            ViTBlock(dim, heads, mlp_ratio, dtype, norm_dtype, attn_impl)
            for _ in range(depth)
        )
        self.ln_head = LayerNorm(dim, dtype, norm_dtype)
        self.head = Dense(dim, num_classes, dtype)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: xavier-uniform kernels (conv fans include
        the receptive field, as in flax), zero biases, LayerNorm scale 1,
        ``pos_emb`` ~ N(0, 0.02).  ``generator`` seeds fresh weights; the
        draws are torch's, not flax's, so only the distributions match."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.pos_emb, std=0.02, generator=generator)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) → tokens (B, S, dim) with position added."""
        b, h, w, _ = x.shape
        if h != self.image_size or w != self.image_size:
            raise ValueError(f"ViT(image_size={self.image_size}) got {h}x{w} input")
        # NHWC seen as NCHW is channels-last: the conv output flattens to
        # (B, S, dim) row-major over (h, w) with no copy
        x = F.conv2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(self.dtype),
            self.patch_embed.bias.to(self.dtype),
            stride=self.patch,
        )
        x = x.flatten(2).transpose(1, 2)
        return x + self.pos_emb.to(self.dtype)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x

    def head_out(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_head(x).mean(dim=1)
        return self.head(x).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head_out(self.trunk(self.embed(x)))


def ViTTiny(**kw) -> ViT:
    return ViT(depth=12, dim=192, heads=3, **kw)


def ViTSmall(**kw) -> ViT:
    return ViT(depth=12, dim=384, heads=6, **kw)


def ViTLong(**kw) -> ViT:
    """Long-context config: head dim 512/4 = 128; 256 px inputs at patch 4
    give 4096 tokens, the flash-attention kernel's regime."""
    kw.setdefault("image_size", 256)
    return ViT(depth=8, dim=512, heads=4, **kw)
