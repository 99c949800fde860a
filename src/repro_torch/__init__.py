"""PyTorch/CUDA port of the SkewRoute reproduction.

Mirrors the JAX package ``repro`` module for module (``repro/core/router.py``
is ``repro_torch/core/router.py``). It imports ``torch`` and numpy and never
``jax`` or ``repro``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (see :func:`repro_torch.kernels.device.resolve_device`);
the TPU kernels on the routing path and in the LLM tiers behind it are
hand-written CUDA C++ for Hopper under ``repro_torch/kernels/csrc/``.
"""
