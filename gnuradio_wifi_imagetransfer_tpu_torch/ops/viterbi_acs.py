"""K=7 Viterbi decoder: CUDA kernel wrappers and plain versions.

Replaces the JAX package's TPU kernel ops/pallas_viterbi.py
(``_make_acs_kernel``, reached through ``acs_forward``'s pl.pallas_call)
and the XLA traceback in ``pallas_viterbi.decode``. The kernel is
``csrc/viterbi_acs.cu``: forward ACS and traceback in one launch for a
table of trellis segments (``viterbi_decode_many``; ``viterbi_decode`` is
one segment), 8 lanes a frame and 4 frames a warp, survivor decisions in
shared memory. It is latency bound by the serial step chain (see the
source's note).

``viterbi_decode_plain`` is the JAX package's XLA path (phy/viterbi.py:
73-110) in PyTorch, with the same float32 operations in the same order;
kernel, plain version and the JAX path agree bit for bit.
``viterbi_bound`` is the kernel's bound and ``chain_floor_ms`` the floor
of its design's serial chain.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import build, roofline
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table


@functools.cache
def _np_tables():
    t = params.conv_tables()
    return tuple(np.ascontiguousarray(a) for a in (
        t["prev_state"].astype(np.int32), t["prev_bit"].astype(np.int32),
        t["prev_out0"].astype(np.float32), t["prev_out1"].astype(np.float32)))


def viterbi_decode_plain(llr: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """(B, n, 2) float32 LLR pairs -> (B, n) uint8 decoded bits."""
    dev = llr.device
    prev_state, prev_bit, out0, out1 = (
        device_table(_np_table, i, device=dev, dtype=torch.long if i == 0 else None)
        for i in range(4))
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


def _np_table(i: int) -> np.ndarray:
    return _np_tables()[i]


@functools.cache
def _check_tables() -> None:
    """The kernel is built for the 802.11a trellis: check that the port's
    tables are it (once)."""
    err = build.library().gwt_viterbi_check_tables(*(a.ctypes.data for a in _np_tables()))
    build.check(err, "viterbi_check_tables")


def _check(llr: torch.Tensor, name: str) -> None:
    if llr.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {llr.dtype}")
    if llr.ndim != 3 or llr.shape[-1] != 2:
        raise ValueError(f"{name}: expected (B, n, 2), got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    max_steps = build.library().gwt_viterbi_max_steps()
    if llr.shape[1] > max_steps:
        raise ValueError(f"{name}: {llr.shape[1]} trellis steps exceed one block's "
                         f"shared memory ({max_steps} steps)")


def viterbi_decode(llr: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """Viterbi-decode (B, n, 2) float32 mother-code LLR pairs (llr > 0
    favours bit 1; erasures are 0) -> (B, n) uint8 bits. ``terminated``:
    trace back from state 0, else from the first best final state.

    A CUDA tensor goes through the kernel (one launch of one segment,
    forward and traceback); a CPU tensor through ``viterbi_decode_plain``."""
    if llr.device.type == "cpu":
        return viterbi_decode_plain(llr, terminated)
    bits, launched = _decode_segments([llr], [bool(terminated)], "viterbi_decode")
    if launched:
        build.count_launch(viterbi_decode, (llr, terminated))
    return bits[0]


viterbi_decode.launches = 0


def viterbi_decode_many_plain(llrs, terminated) -> list[torch.Tensor]:
    """``viterbi_decode_plain`` on each (B_i, n_i, 2) segment."""
    return [viterbi_decode_plain(v, t) for v, t in zip(llrs, terminated, strict=True)]


def viterbi_decode_many(llrs, terminated) -> list[torch.Tensor]:
    """Viterbi-decode several segments of (B_i, n_i, 2) float32 LLR pairs
    with their ``terminated`` flags -> [(B_i, n_i) uint8 bits].

    CUDA tensors (on one device) go through the kernel in ONE launch for
    all segments; CPU tensors through ``viterbi_decode_many_plain``."""
    llrs, terminated = list(llrs), [bool(t) for t in terminated]
    if len(llrs) != len(terminated):
        raise ValueError(f"viterbi_decode_many: {len(llrs)} segments, "
                         f"{len(terminated)} terminated flags")
    if all(v.device.type == "cpu" for v in llrs):
        return viterbi_decode_many_plain(llrs, terminated)
    bits, launched = _decode_segments(llrs, terminated, "viterbi_decode_many")
    if launched:
        build.count_launch(viterbi_decode_many, (llrs, terminated))
    return bits


def _decode_segments(llrs, terminated, name: str):
    """The one launch behind both wrappers. Returns (bits, whether it
    launched)."""
    for v in llrs:
        _check(v, name)
    dev = llrs[0].device
    if any(v.device != dev for v in llrs):
        raise ValueError(f"{name}: segments on different devices")
    lib = build.library()
    if len(llrs) > lib.gwt_viterbi_max_segments():
        raise ValueError(f"{name}: {len(llrs)} segments exceed one launch's "
                         f"{lib.gwt_viterbi_max_segments()}")
    sizes = [v.shape[0] * v.shape[1] for v in llrs]
    flat = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    bits = [b.view(v.shape[:2]) for b, v in zip(flat.split(sizes), llrs)]
    if not any(sizes):
        return bits, False
    _check_tables()
    desc = (ctypes.c_int64 * (5 * len(llrs)))(*(
        x for v, b, t in zip(llrs, bits, terminated)
        for x in (v.data_ptr(), b.data_ptr(), v.shape[0], v.shape[1], int(t))))
    err = lib.gwt_viterbi_decode_segments(desc, len(llrs),
                                          torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    return bits, True


viterbi_decode_many.launches = 0


# Bounds (ms on the card, ``roofline``)
# ----------------------------------------------------------------------

# per frame and trellis step of the Viterbi ACS in the kernel's form (the
# code is linear, so a step has 4 distinct gains): 4 gains x (2 mul + 1
# add) + 64 states x 2 edges x 1 add + 64 compare/select + 63 max + 64
# subtract; counted at the instruction rate
K2_OPS_PER_STEP = 4 * 3 + 64 * 2 + 64 + 63 + 64
# the chain floor, a design estimate in dependent cycles: an ACS step
# (two shared loads in flight together ~33, add 4, compare/select 8, 3
# in-lane max 12, 3 shuffles with their max ~84, subtract 4, stores and
# the warp sync ~20) and a traceback step (shared byte load ~33, bit and
# state arithmetic ~12)
K2_ACS_CYCLES = 165
K2_TRACEBACK_CYCLES = 45


def viterbi_bound(steps: int) -> dict:
    """K2's bound for ``steps`` trellis steps in all (frames x steps,
    summed over the segments): an LLR pair read and a decided bit written
    a step, the ACS of a step."""
    return roofline.bound(steps * (8 + 1), steps * K2_OPS_PER_STEP, roofline.FP32_INSTR_PER_S)


def chain_floor_ms(steps: int, sm_mhz: float) -> float:
    """The design's floor for a trellis of ``steps`` steps at an SM clock
    of ``sm_mhz``: each step's ACS and traceback run one after the other
    on one frame's lanes, whatever the number of frames."""
    return steps * (K2_ACS_CYCLES + K2_TRACEBACK_CYCLES) / (sm_mhz * 1e3)
