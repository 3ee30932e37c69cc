"""PyTorch/CUDA port of the GNNFlow reproduction.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``models/``, ``serve/`` …) so each module's counterpart is found under
the same path.  Entry points put their state on the NVIDIA card unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
Every kernel the serving and training paths run is a hand-written CUDA
kernel under ``csrc/``; its plain PyTorch version in
``kernels/<name>/ref.py`` runs only for tensors on the CPU.

This package imports ``torch`` and ``numpy`` only — never JAX and never
``repro``.
"""
