"""The one canonical device choice for the port.

Counterpart of the reference's ``default_interpret`` (compiled on TPU,
interpret elsewhere): here every entry point runs on the CUDA device
unless the caller asks for the CPU, and it never falls back on its own.
Like the reference's choice it is resolved AT CALL TIME and never
serialized, so a snapshot taken on the card restores on a CPU host (and
vice versa) by naming the device at build time, not in the policy.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only when asked. Raises when CUDA
    is requested (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (copied to the host) or an array-like, as
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

