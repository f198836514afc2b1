"""Device selection for the port's entry points, and the phy tables cached
per device.

Entry points run on CUDA unless the caller asks for the CPU. A request for
CUDA on a machine without it raises; nothing drops silently to the CPU.
"""

from __future__ import annotations

import functools

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``device``; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _table(make, args: tuple, device: torch.device, dtype) -> torch.Tensor:
    t = torch.as_tensor(make(*args), device=device)
    return t if dtype is None else t.to(dtype)


def device_table(make, *args, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The numpy table ``make(*args)`` as a tensor on ``device`` (converted
    to ``dtype`` when given), made once per (make, args, device, dtype) and
    shared: read it, never write it. ``make`` and ``args`` key the cache,
    so they are hashable: a table function and its arguments, or
    (``getattr``, module, name) for a module constant (``param_table``).

    The phy modules take their tables through it: an upload from numpy is
    a pageable, blocking copy, which stalls the host on every call and
    cannot sit inside a CUDA graph's capture."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _table(make, args, device, dtype)


def param_table(name: str, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The ``phy.params`` constant ``name`` on ``device`` (``device_table``)."""
    return device_table(getattr, params, name, device=device, dtype=dtype)
