"""Device resolution for the port's entry points.

Every public entry point takes ``device=`` and defaults to ``"cuda"``.  A
CUDA request on a machine without CUDA raises: the port never quietly
falls back to the CPU.  The CPU runs only when the caller asks for it (the
tests do, with ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    """`torch.device` for `device` (``None`` means ``"cuda"``); raises
    `RuntimeError` for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
