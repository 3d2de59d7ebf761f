"""Runnable examples of the port: ``quickstart`` (the multipliers, their
exact decomposition, the bit-exact matmul three ways, a dense layer and its
gradient), ``lenet_mnist_qat`` (the paper's own experiment on LeNet) and
``approx_qat_lm`` (QAT of a granite-family LM with checkpoint/restart).
Run as ``python -m repro_torch.examples.<name> --device D``."""
