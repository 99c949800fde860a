"""Hand-written Hopper (sm_90a) CUDA kernels: the routing hot path
(``skew_metrics``, ``triple_score``) and the LLM tiers' attention
(``flash_attention`` for prefill, ``decode_attention`` for decode).

Each kernel package ships ``kernel.py`` (the ctypes launcher with its
shape/dtype/device checks, launch counter, and the plain PyTorch version
of the same arithmetic that CPU tensors take), ``ops.py`` (the public
wrapper) and ``ref.py`` (the readable oracle). CUDA sources live in
``csrc/`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.cuda_build`).

:func:`repro_torch.kernels.device.resolve_device` is the canonical
call-time device choice shared by every entry point.
"""

from repro_torch.kernels.device import resolve_device  # noqa: F401
