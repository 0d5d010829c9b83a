"""CIFAR-100 channel statistics (the reference's train/val normalisation,
``distributed_training_comparison_tpu/data/cifar100.py:28-29``).  The
pickle loader comes with the training slice."""

CIFAR100_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR100_STD = (0.2023, 0.1994, 0.2010)
