"""PyTorch/CUDA port of ``distributed_training_comparison_tpu``, for an NVIDIA
H100.

The JAX package stays the reference; this package imports neither JAX nor
anything of it.  Plain tensor code is PyTorch, and each Pallas kernel of the
JAX package on a ported path becomes a kernel written by hand for Hopper
(``ops/csrc/``), with its plain PyTorch version beside it.  Entry points run
on the card unless the caller asks for the CPU.

Ported so far: serving the ViT family (``python -m
distributed_training_comparison_tpu_torch --serve --model vit_long
--image-size 256 --amp``), with the flash-attention forward kernel.
"""
