"""Device resolution: the port runs on the card unless told otherwise.

``resolve_device(None)`` is ``cuda``.  Asking for CUDA on a machine without
it raises; nothing falls back to the CPU quietly.  The CPU runs only when
the caller names it (``device="cpu"``, ``--device cpu``), as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
