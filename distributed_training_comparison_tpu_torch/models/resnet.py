"""The CIFAR-style ResNet family (``distributed_training_comparison_tpu/models/resnet.py``).

The same model, widths and numerics as the flax ``ResNet``:

- stem ``"cifar"``: a 3x3 stride-1 convolution and no max-pool;
  ``"imagenet"``: a 7x7 stride-2 convolution (pad 3) and a 3x3 stride-2
  max-pool (pad 1);
- four stages of widths 64/128/256/512 at strides 1/2/2/2, of
  ``BasicBlock`` (two 3x3 convolutions) or ``Bottleneck`` (1x1, 3x3
  carrying the stride, 1x1 expanding x4), with a projection shortcut (1x1
  convolution and BatchNorm) where the stride or the width changes;
- a spatial mean and a linear head, with fp32 logits.

Precision follows the JAX model: each convolution and the head cast their
input and weight to the compute dtype ``dtype``, while the BatchNorm
outputs, the residual sums and the ReLUs stay in BatchNorm's output dtype,
``norm_dtype`` (fp32 by default under any compute dtype, ``models/norms.py``).
Parameters are fp32.

The input is NHWC, as the data path gives it.  It is seen once as NCHW in
``channels_last`` memory format (a view, no copy), which cuDNN prefers, and
the convolution weights are held in that format too.  The ``state_dict``
names are the reference net's (``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{j}`` / ``bn{j}``, ``shortcut.{0,1}``, ``linear``), as
``distributed_training_comparison_tpu/models/torch_port.py`` maps them.

There is no kernel of the port on this path: the convolutions are cuDNN's,
the head cuBLAS's and BatchNorm PyTorch's own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .norms import BatchNorm2d
from .remat import remat_block
from .vit import Dense

STEMS = ("cifar", "imagenet")
# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal initializers divide by it to keep the variance asked for
TRUNC_NORMAL_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` without a bias, with flax ``nn.Conv(dtype=...)``
    numerics: an fp32 weight, input and weight cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, padding: int,
                 dtype: torch.dtype) -> None:
        super().__init__(cin, cout, kernel, stride, padding, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                        self.stride, self.padding)


def _shortcut(cin: int, cout: int, stride: int, dtype, norm_dtype) -> nn.Sequential:
    """The identity, or a projection where the stride or the width changes."""
    if stride == 1 and cin == cout:
        return nn.Sequential()
    return nn.Sequential(Conv2d(cin, cout, 1, stride, 0, dtype), BatchNorm2d(cout, dtype, norm_dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convolutions; projection shortcut when the shape changes."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype | None = torch.float32) -> None:
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm2d(planes, dtype, norm_dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype, norm_dtype)
        self.shortcut = _shortcut(cin, planes, stride, dtype, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (carrying the stride), 1x1 expand (x4)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype | None = torch.float32) -> None:
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, 1, 0, dtype)
        self.bn1 = BatchNorm2d(planes, dtype, norm_dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype, norm_dtype)
        self.conv3 = Conv2d(planes, cout, 1, 1, 0, dtype)
        self.bn3 = BatchNorm2d(cout, dtype, norm_dtype)
        self.shortcut = _shortcut(cin, cout, stride, dtype, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))


class ResNet(nn.Module):
    """Stem, four stages, spatial mean, linear head.  Input: normalized
    images (B, H, W, 3), NHWC.  ``remat`` rematerializes each residual
    block on the backward pass (``models/remat.py``)."""

    STAGE_WIDTHS = (64, 128, 256, 512)
    STAGE_STRIDES = (1, 2, 2, 2)

    def __init__(
        self,
        block: type[BasicBlock] | type[Bottleneck],
        num_blocks: tuple[int, ...],
        num_classes: int = 100,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
        stem: str = "cifar",
        remat: bool = False,
    ) -> None:
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}; choices: {STEMS}")
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem = stem
        self.remat = remat
        kernel, stride, pad = (7, 2, 3) if stem == "imagenet" else (3, 1, 1)
        self.conv1 = Conv2d(3, 64, kernel, stride, pad, dtype)
        self.bn1 = BatchNorm2d(64, dtype, norm_dtype)
        cin = 64
        for i, (planes, stride, n) in enumerate(
            zip(self.STAGE_WIDTHS, self.STAGE_STRIDES, num_blocks)
        ):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, planes, stride if j == 0 else 1, dtype, norm_dtype))
                cin = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.linear = Dense(cin, num_classes, dtype)
        self.to(memory_format=torch.channels_last)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: ``he_normal`` on every convolution and on
        the head kernel (a normal truncated at +-2 standard deviations,
        scaled so that its standard deviation is sqrt(2 / fan_in), fan_in
        counting the receptive field), a zero head bias, BatchNorm scale 1
        and bias 0 with fresh running statistics.  ``generator`` seeds fresh
        weights; the draws are torch's, not flax's, so only the
        distributions match."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(2.0 / m.weight[0].numel()) / TRUNC_NORMAL_STD
                # drawn contiguous (several times faster than into the
                # channels_last weight), then copied into it
                w = torch.empty(m.weight.shape, device=m.weight.device)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in stage:
                x = remat_block(blk, x) if self.remat else blk(x)
        # the reference's 4x4 average pool of a 4x4 map is the spatial mean
        return self.linear(x.mean(dim=(2, 3))).float()


def ResNet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)
