"""Hand-written Hopper kernels and their plain PyTorch versions.

One subpackage per kernel of the JAX package's ``repro.kernels``:
``ref.py`` is the plain PyTorch version (the CPU path and the test
oracle), ``ops.py`` the wrapper that launches the CUDA kernel from
``src/repro_torch/csrc/<name>.cu`` for tensors on the card.
:mod:`repro_torch.kernels.runtime` builds, loads and counts them.
"""
