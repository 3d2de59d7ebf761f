"""PyTorch/CUDA port of the approximate-multiplier serving system.

Mirrors ``src/repro``'s layout (``core/ quant/ kernels/ configs/ models/
serve/ launch/``).  It imports ``torch`` and never JAX nor the JAX package;
the tests hold it against that package.  Hand-written CUDA kernels for the
card replace the Pallas TPU kernels (``kernels/``), each beside its plain
PyTorch version, which runs for tensors on the CPU.
"""
