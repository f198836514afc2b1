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


@functools.cache
def _butterfly() -> bool:
    """Whether the port's trellis is the butterfly the plain loop's views
    assume (the kernel checks the same, gwt_viterbi_check_tables):
    prev_state[ns][k] = 2 (ns mod 32) + k and prev_bit[ns][k] = ns / 32."""
    prev_state, prev_bit = _np_tables()[:2]
    ns = np.arange(params.N_STATES)[:, None]
    return bool(np.array_equal(prev_state, 2 * (ns % 32) + np.arange(2))
                and np.array_equal(prev_bit, np.broadcast_to(ns // 32, prev_bit.shape)))


_CHUNK = 256                # trellis steps whose gains (and predecessors) are formed at once


def viterbi_decode_plain(llr: torch.Tensor, terminated: bool = True,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n, 2) float32 LLR pairs -> (B, n) uint8 decoded bits.

    ``lengths`` (B,) (terminated only): frame b decodes its first
    lengths[b] steps (clipped to 1..n) as a trellis of its own, traced back
    from state 0 at its last step, and its bits past them are 0. The
    recursion runs over all n steps (reading no length back to the host,
    as a captured function must not); past a frame's own length its
    decisions into state 0 are set to the edge from state 0, so the
    traceback waits there.

    The operations are the JAX path's: per step gain = llr_a * out0 +
    llr_b * out1 (formed for a chunk of steps at once), cand = pm[prev] +
    gain, the decision, the select and the max subtracted; the butterfly
    (``_butterfly``) lets pm[prev] be a view."""
    if not _butterfly():
        raise ValueError("viterbi_decode_plain: the trellis tables are not the butterfly")
    dev = llr.device
    out0, out1 = (device_table(_np_table, i, device=dev) for i in (2, 3))
    b, n, _ = llr.shape
    if lengths is not None and not terminated:
        raise ValueError("viterbi_decode_plain: lengths take a terminated trellis")
    pm = torch.full((b, params.N_STATES), -1e30, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0                                           # start in state 0
    chunks = []
    for lo in range(0, n, _CHUNK):
        v = llr[:, lo: lo + _CHUNK]
        # gain[b, t, ns, k] = llr_a * out0[ns, k] + llr_b * out1[ns, k]
        gains = (v[..., 0, None, None] * out0 + v[..., 1, None, None] * out1).view(
            b, v.shape[1], 2, 32, 2)                         # ns = 32 h + j
        ds = []
        for t in range(v.shape[1]):
            c0, c1 = (pm.view(b, 1, 32, 2) + gains[:, t]).unbind(-1)   # pm[2 (ns mod 32) + k]
            d = c1 > c0                                      # ties -> k = 0
            new = torch.where(d, c1, c0)
            pm = (new - new.amax(dim=(1, 2), keepdim=True)).view(b, params.N_STATES)
            ds.append(d)                                     # (the max: drift control)
        chunks.append(torch.stack(ds).view(v.shape[1], b, params.N_STATES))
    dec = (torch.cat(chunks) if chunks
           else torch.empty((0, b, params.N_STATES), dtype=torch.bool, device=dev))
    if terminated:
        state = torch.zeros((b, 1), dtype=torch.long, device=dev)
    else:
        state = torch.argmax(pm, dim=-1, keepdim=True)       # first max
    if lengths is not None:
        own = lengths.to(device=dev, dtype=torch.long).clamp(1, max(n, 1))
        dec[:, :, 0] &= torch.arange(n, device=dev)[:, None] < own
    # prev_state[s][k] = 2 (s mod 32) + k, prev_bit[s][k] = s / 32: a chunk's
    # predecessor table, then one gather a step
    low = (torch.arange(params.N_STATES, device=dev) & 31) << 1
    bits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    for hi in range(n, 0, -_CHUNK):
        lo = max(0, hi - _CHUNK)
        prev = low + dec[lo:hi].long()                       # (steps, B, 64)
        states = []
        for t in range(hi - lo - 1, -1, -1):
            states.append(state)
            state = prev[t].gather(1, state)
        bits[:, lo:hi] = torch.cat(states[::-1], dim=1) >> 5
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


def viterbi_decode_many_plain(llrs, terminated, lengths=None) -> list[torch.Tensor]:
    """``viterbi_decode_plain`` on each (B_i, n_i, 2) segment, with its
    ``lengths`` entry (None or (B_i,))."""
    lengths = [None] * len(llrs) if lengths is None else lengths
    return [viterbi_decode_plain(v, t, n)
            for v, t, n in zip(llrs, terminated, lengths, strict=True)]


def viterbi_decode_many(llrs, terminated, lengths=None) -> list[torch.Tensor]:
    """Viterbi-decode several segments of (B_i, n_i, 2) float32 LLR pairs
    with their ``terminated`` flags -> [(B_i, n_i) uint8 bits]. ``lengths``,
    if given, holds for each segment None or the (B_i,) trellis lengths of
    its frames (a terminated segment only; ``viterbi_decode_plain``).

    CUDA tensors (on one device) go through the kernel in ONE launch for
    all segments; CPU tensors through ``viterbi_decode_many_plain``."""
    llrs, terminated = list(llrs), [bool(t) for t in terminated]
    lengths = [None] * len(llrs) if lengths is None else list(lengths)
    if not len(llrs) == len(terminated) == len(lengths):
        raise ValueError(f"viterbi_decode_many: {len(llrs)} segments, "
                         f"{len(terminated)} terminated flags, {len(lengths)} lengths")
    if all(v.device.type == "cpu" for v in llrs):
        return viterbi_decode_many_plain(llrs, terminated, lengths)
    bits, launched = _decode_segments(llrs, terminated, "viterbi_decode_many", lengths)
    if launched:
        build.count_launch(viterbi_decode_many, (llrs, terminated, lengths))
    return bits


def _decode_segments(llrs, terminated, name: str, lengths=None):
    """The one launch behind both wrappers. Returns (bits, whether it
    launched)."""
    lengths = [None] * len(llrs) if lengths is None else lengths
    for v in llrs:
        _check(v, name)
    for v, t, n in zip(llrs, terminated, lengths):
        if n is None:
            continue
        if not t:
            raise ValueError(f"{name}: lengths take a terminated trellis")
        if n.device != v.device or n.dtype != torch.int32 or n.shape != v.shape[:1] \
                or not n.is_contiguous():
            raise ValueError(f"{name}: lengths must be ({v.shape[0]},) contiguous int32 on "
                             f"{v.device}, got {tuple(n.shape)} {n.dtype} on {n.device}")
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
    desc = (ctypes.c_int64 * (6 * len(llrs)))(*(
        x for v, b, t, n in zip(llrs, bits, terminated, lengths)
        for x in (v.data_ptr(), b.data_ptr(), v.shape[0], v.shape[1], int(t),
                  0 if n is None else n.data_ptr())))
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
