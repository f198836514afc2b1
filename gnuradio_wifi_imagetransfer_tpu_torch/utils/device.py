"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A request for
CUDA on a machine without it raises; nothing drops silently to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``device``; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
