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
the card at long sequences that is the CUDA flash-attention forward, and
under autograd its dq and dk/dv kernels, all reading the projections in
place through transposed views.

``block_fusion`` selects the fused block (``ops/vit_block.py``: the K5
forward, and under autograd the K6 backward) with the JAX package's gate
(:func:`block_fusion_path`): ``"auto"`` takes it on the card for dense
blocks at 128-512 tokens whose weights fit the JAX package's budget,
``"force"`` also on the CPU through its plain versions, ``"off"`` always
composes.  Training and inference take the same path, as in the JAX
package.

``num_experts > 0`` replaces every block's MLP with a Switch MoE FFN
(``models/moe.py``, ``moe_dispatch`` choosing its dispatch); such a block
always composes.  After a forward, :meth:`ViT.moe_aux_loss` is the summed
load-balance loss of the blocks and :meth:`ViT.moe_health` their routing
health, the port's form of the JAX model's sown ``losses`` and
``moe_metrics`` collections.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.vit_block import fused_vit_block
from ..ops.vmem import fits_weight_budget, fused_block_weight_bytes
from .moe import SwitchFFN
from .norms import LayerNorm

BLOCK_FUSIONS = ("auto", "force", "off")

# reasons already warned about when block_fusion="force" composed (one
# warning per distinct reason per process; tests may clear this)
_FUSION_FORCE_WARNED: set[str] = set()


def _warn_force_composed(reason: str) -> None:
    """One warning per distinct reason when ``block_fusion="force"`` is
    declined and the block composes (the JAX package's rule)."""
    if reason in _FUSION_FORCE_WARNED:
        return
    _FUSION_FORCE_WARNED.add(reason)
    warnings.warn(
        "--block-fusion force: the fused block kernel was declined "
        f"({reason}); this block runs the composed path",
        UserWarning,
        stacklevel=3,
    )


def block_fusion_path(
    block_fusion: str,
    device_type: str,
    seq: int,
    dim: int,
    heads: int,
    mlp_ratio: int,
    dtype: torch.dtype,
    attn_impl: str,
    num_experts: int = 0,
) -> tuple[str, str | None]:
    """The fused-block gate as a pure function: ``("fused" | "composed",
    the first reason the fused block was declined, or None)``.

    The JAX package's conditions, in its order: a dense block (no experts),
    ``attn_impl`` not pinned, S and the head dim multiples of 8,
    128 <= S <= 512, the weight budget of ``ops/vmem.py``; then ``"auto"``
    fuses on the card and ``"force"`` also on the CPU.  Like the JAX gate it has no autograd input: a block that
    trains takes the path it takes when it serves.
    """
    if block_fusion not in BLOCK_FUSIONS:
        raise ValueError(f"unknown block_fusion {block_fusion!r}")
    if block_fusion == "off":
        return "composed", None
    if num_experts:
        return "composed", "MoE block (the kernel has no expert FFN form)"
    hd = dim // heads
    if attn_impl != "auto":
        return "composed", f"attn_impl={attn_impl!r} pins attention"
    if seq % 8 or hd % 8:
        return "composed", f"tokens ({seq}) and head dim ({hd}) must be multiples of 8"
    if not 128 <= seq <= 512:
        return "composed", f"{seq} tokens outside the measured 128-512 window"
    wbytes = fused_block_weight_bytes(dim, mlp_ratio, dtype)
    if not fits_weight_budget(wbytes):
        return "composed", (
            f"static VMEM weight footprint {wbytes / 2**20:.1f} MiB exceeds the kernel budget"
        )
    if device_type == "cuda" or block_fusion == "force":
        return "fused", None
    return "composed", None


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
    """Pre-LN transformer block with separate q/k/v projections; the fused
    block (``ops.vit_block.fused_vit_block``) where :func:`block_fusion_path`
    takes it, on the same parameters.  ``num_experts > 0``: a Switch MoE FFN
    (``moe``) in place of ``mlp_up``/``mlp_down``."""

    _SUBLAYERS = ("ln_attn", "q_proj", "k_proj", "v_proj", "proj", "ln_mlp", "mlp_up", "mlp_down")

    def __init__(
        self,
        dim: int,
        heads: int,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
        attn_impl: str = "auto",
        block_fusion: str = "auto",
        num_experts: int = 0,
        capacity_factor: float = 1.25,
        moe_dispatch: str = "auto",
    ) -> None:
        super().__init__()
        self.heads = heads
        self.mlp_ratio = mlp_ratio
        self.dtype = dtype
        self.norm_f32 = norm_dtype is not None
        self.attn_impl = attn_impl
        self.block_fusion = block_fusion
        self.num_experts = num_experts
        self.ln_attn = LayerNorm(dim, dtype, norm_dtype)
        self.q_proj = Dense(dim, dim, dtype)
        self.k_proj = Dense(dim, dim, dtype)
        self.v_proj = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.ln_mlp = LayerNorm(dim, dtype, norm_dtype)
        self.moe = None
        if num_experts:
            self.moe = SwitchFFN(dim, num_experts, mlp_ratio, capacity_factor, dtype,
                                 dispatch=moe_dispatch)
        else:
            self.mlp_up = Dense(dim, mlp_ratio * dim, dtype)
            self.mlp_down = Dense(mlp_ratio * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        path, declined = block_fusion_path(
            self.block_fusion, x.device.type, s, dim, self.heads, self.mlp_ratio,
            self.dtype, self.attn_impl, self.num_experts,
        )
        if self.block_fusion == "force" and declined:
            _warn_force_composed(declined)
        if path == "fused":
            params = {
                f"{m}.{p}": getattr(getattr(self, m), p)
                for m in self._SUBLAYERS for p in ("weight", "bias")
            }  # named_parameters() costs several times this per call
            return fused_vit_block(
                x.to(self.dtype), params, heads=self.heads, norm_f32=self.norm_f32
            )
        hd = dim // self.heads
        h = self.ln_attn(x)
        q = self.q_proj(h).view(b, s, self.heads, hd)
        k = self.k_proj(h).view(b, s, self.heads, hd)
        v = self.v_proj(h).view(b, s, self.heads, hd)
        o = attention(q, k, v, impl=self.attn_impl, layout="bshd")
        x = x + self.proj(o.reshape(b, s, dim))
        if self.moe is not None:
            return x + self.moe(self.ln_mlp(x))
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
        num_experts: int = 0,
        capacity_factor: float = 1.25,
        moe_dispatch: str = "auto",
    ) -> None:
        super().__init__()
        if dim % heads:
            raise ValueError(
                f"ViT dim ({dim}) must be divisible by heads ({heads}); "
                "per-head dim would not be integral"
            )
        if block_fusion not in BLOCK_FUSIONS:
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
            ViTBlock(dim, heads, mlp_ratio, dtype, norm_dtype, attn_impl, block_fusion,
                     num_experts, capacity_factor, moe_dispatch)
            for _ in range(depth)
        )
        self.ln_head = LayerNorm(dim, dtype, norm_dtype)
        self.head = Dense(dim, num_classes, dtype)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: xavier-uniform kernels (conv fans include
        the receptive field, as in flax), zero biases, LayerNorm scale 1,
        ``pos_emb`` ~ N(0, 0.02), and the MoE layers' own
        (:meth:`SwitchFFN.init_weights`).  ``generator`` seeds fresh weights;
        the draws are torch's, not flax's, so only the distributions match."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.pos_emb, std=0.02, generator=generator)
        for m in self._moe_layers():  # the router is not xavier
            m.init_weights(generator)

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

    def _moe_layers(self) -> list[SwitchFFN]:
        return [blk.moe for blk in self.blocks if blk.moe is not None]

    def moe_aux_loss(self) -> torch.Tensor | None:
        """The last forward's load-balance loss summed over the MoE blocks
        (the JAX train step's sum of the ``losses`` collection); None for a
        dense model."""
        layers = self._moe_layers()
        return torch.stack([m.aux_loss for m in layers]).sum() if layers else None

    def moe_health(self) -> dict[str, torch.Tensor]:
        """The last forward's routing health per MoE block, as device
        tensors: ``dropped_frac`` (depth,) and ``expert_load`` (depth, E);
        empty for a dense model."""
        layers = self._moe_layers()
        if not layers:
            return {}
        return {
            "dropped_frac": torch.stack([m.dropped_frac for m in layers]),
            "expert_load": torch.stack([m.expert_load for m in layers]),
        }


def ViTTiny(**kw) -> ViT:
    return ViT(depth=12, dim=192, heads=3, **kw)


def ViTSmall(**kw) -> ViT:
    return ViT(depth=12, dim=384, heads=6, **kw)


def ViTMoE(**kw) -> ViT:
    """Switch-MoE config: a ViT-Tiny-width trunk of 8 blocks whose every FFN
    is 8 experts behind a top-1 router."""
    kw.setdefault("num_experts", 8)
    kw.setdefault("depth", 8)
    kw.setdefault("dim", 192)
    kw.setdefault("heads", 3)
    return ViT(**kw)


def ViTLong(**kw) -> ViT:
    """Long-context config: head dim 512/4 = 128; 256 px inputs at patch 4
    give 4096 tokens, the flash-attention kernel's regime."""
    kw.setdefault("image_size", 256)
    return ViT(depth=8, dim=512, heads=4, **kw)
