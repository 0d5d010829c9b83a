"""PyTorch/CUDA port of ``distributed_training_comparison_tpu``, for an NVIDIA
H100.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  Plain tensor code is PyTorch, and each Pallas kernel of the
JAX package on a ported path becomes a kernel written by hand for Hopper
(``ops/csrc/``), with its plain PyTorch version beside it.  Entry points run
on the card unless the caller asks for the CPU.

Ported so far: training and serving the ResNet and ViT families on one
card (``python -m distributed_training_comparison_tpu_torch --synthetic-data``
trains the default ``resnet18``; ``--model vit_long --image-size 256 --amp
--synthetic-data``, and the same with ``--serve``), the ViTs with the
flash-attention forward and backward kernels, the fused ViT block chains,
and ``vit_moe`` with the grouped expert FFN kernels.  The ResNets run no
kernel of the port: their convolutions are cuDNN's.
"""
