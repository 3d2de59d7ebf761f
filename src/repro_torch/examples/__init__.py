"""Runnable examples of the port: ``quickstart`` (the multipliers, their
exact decomposition, the bit-exact matmul three ways, a dense layer and its
gradient) and ``lenet_mnist_qat`` (the paper's own experiment on LeNet).
Run as ``python -m repro_torch.examples.<name> --device D``."""
