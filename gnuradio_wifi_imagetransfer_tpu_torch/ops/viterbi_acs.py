"""K=7 Viterbi decoder: CUDA kernel wrapper and plain version.

Replaces the JAX package's TPU kernel ops/pallas_viterbi.py
(``_make_acs_kernel``, reached through ``acs_forward``'s pl.pallas_call)
and the XLA traceback in ``pallas_viterbi.decode``. The kernel is
``csrc/viterbi_acs.cu``: forward ACS and traceback in one launch, one warp
per frame, survivor decisions as one 64-bit word per step in shared
memory. It is latency bound by the serial step chain (see the source's
note).

``viterbi_decode_plain`` is the JAX package's XLA path (phy/viterbi.py:
73-110) in PyTorch, with the same float32 operations in the same order;
kernel, plain version and the JAX path agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params

# shared memory a block may use on Hopper, less the kernel's static metrics
_MAX_SMEM = 232448 - 1024


@functools.cache
def _np_tables():
    t = params.conv_tables()
    return tuple(np.ascontiguousarray(a) for a in (
        t["prev_state"].astype(np.int32), t["prev_bit"].astype(np.int32),
        t["prev_out0"].astype(np.float32), t["prev_out1"].astype(np.float32)))


def viterbi_decode_plain(llr: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """(B, n, 2) float32 LLR pairs -> (B, n) uint8 decoded bits."""
    dev = llr.device
    prev_state, prev_bit, out0, out1 = (torch.as_tensor(a, device=dev)
                                        for a in _np_tables())
    prev_state = prev_state.long()
    b, n, _ = llr.shape
    pm = torch.full((b, params.N_STATES), -1e30, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0                                           # start in state 0
    dec = torch.empty((n, b, params.N_STATES), dtype=torch.bool, device=dev)
    for i in range(n):
        # gain[b, ns, k] = llr_a * out0[ns, k] + llr_b * out1[ns, k]
        gain = llr[:, i, 0, None, None] * out0 + llr[:, i, 1, None, None] * out1
        cand = pm[:, prev_state] + gain                      # (B, 64, 2)
        d = cand[..., 1] > cand[..., 0]                      # ties -> k = 0
        new = torch.where(d, cand[..., 1], cand[..., 0])
        pm = new - new.amax(dim=-1, keepdim=True)            # drift control
        dec[i] = d
    if terminated:
        state = torch.zeros(b, dtype=torch.long, device=dev)
    else:
        state = torch.argmax(pm, dim=-1)                     # first max
    bits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    bi = torch.arange(b, device=dev)
    for i in range(n - 1, -1, -1):
        k = dec[i, bi, state].long()
        bits[:, i] = prev_bit[state, k].to(torch.uint8)
        state = prev_state[state, k]
    return bits


@functools.cache
def _tables_on(device_index: int) -> None:
    """Copy the trellis tables into the device's constant memory once."""
    lib = build.library()
    tabs = _np_tables()
    with torch.cuda.device(device_index):
        err = lib.gwt_viterbi_set_tables(*(a.ctypes.data for a in tabs))
    build.check(err, "viterbi_set_tables")


def viterbi_decode(llr: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """Viterbi-decode (B, n, 2) float32 mother-code LLR pairs (llr > 0
    favours bit 1; erasures are 0) -> (B, n) uint8 bits. ``terminated``:
    trace back from state 0, else from the first best final state.

    A CUDA tensor goes through the kernel (one launch, forward and
    traceback); a CPU tensor through ``viterbi_decode_plain``."""
    if llr.device.type == "cpu":
        return viterbi_decode_plain(llr, terminated)
    if llr.device.type != "cuda":
        raise ValueError(f"viterbi_decode: unsupported device {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"viterbi_decode: expected float32, got {llr.dtype}")
    if llr.ndim != 3 or llr.shape[-1] != 2:
        raise ValueError(f"viterbi_decode: expected (B, n, 2), got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("viterbi_decode: input must be contiguous")
    b, n, _ = llr.shape
    bits = torch.empty((b, n), dtype=torch.uint8, device=llr.device)
    if b == 0 or n == 0:
        return bits
    lib = build.library()
    if lib.gwt_viterbi_smem_bytes(n) > _MAX_SMEM:
        raise ValueError(f"viterbi_decode: {n} trellis steps exceed one block's "
                         f"shared memory ({_MAX_SMEM} bytes)")
    _tables_on(llr.device.index if llr.device.index is not None
               else torch.cuda.current_device())
    err = lib.gwt_viterbi_decode(
        llr.data_ptr(), bits.data_ptr(), b, n, int(bool(terminated)),
        torch.cuda.current_stream(llr.device).cuda_stream)
    build.check(err, "viterbi_decode")
    viterbi_decode.launches += 1
    return bits


viterbi_decode.launches = 0
