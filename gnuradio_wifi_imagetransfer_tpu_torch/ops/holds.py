"""The kernels' calls of a run, made again through each kernel and its
plain version on the same inputs.

A run records its kernel calls with ``utils.tracing.recording``;
``hold_recorded`` then holds each call: the fused detector as
``hold_detect`` does, K2 (``viterbi_decode``, ``viterbi_decode_many``)
bit for bit, K4 (``polyphase_resample``) within 2e-4. A call that
disagrees raises AssertionError. On CPU tensors the wrappers take their
plain versions, so there the hold checks only the plumbing.
"""

from __future__ import annotations

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(got, want) -> float:
    return (got - want).abs().max().item()


def hold_detect(args, label: str):
    """The fused detector on args (x, K, threshold, min_plateau, search_lo,
    search_hi) against its plain version (starts and valid exact, cfo
    within 1e-4, ratio within 1e-3) and bit-identical to dense K1 plus the
    plain glue; returns (max |dcfo|, max |dratio|, valid)."""
    got = k1.sync_detect(*args)
    want = k1.sync_detect_plain(*args)
    a, _, c = k1.sync_stats(args[0])
    glue = k1.detect_from_stats(a, c, *args[1:])
    if args[0].is_cuda:
        torch.cuda.synchronize()
    _need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"sync_detect != plain on {label}: starts {got[0].tolist()} vs "
          f"{want[0].tolist()}")
    errs = max_err(got[2], want[2]), max_err(got[3], want[3])
    _need(errs[0] <= 1e-4 and errs[1] <= 1e-3,
          f"sync_detect != plain on {label}: max |dcfo|, |dratio| = {errs}")
    _need(all(torch.equal(g, w) for g, w in zip(got, glue)),
          f"sync_detect is not bit-identical to dense K1 + glue on {label}")
    return errs[0], errs[1], int(got[1].sum())


def hold_recorded(calls, label: str) -> dict:
    """Each kernel call that a run made (``recording``) again, through the
    kernel and its plain version on the same inputs: the detector as
    ``hold_detect``, K2 bit-exact, K4 within 2e-4. Returns {kernel: (max
    error, [input shapes])}."""
    out = {}

    def note(name, err, shape):
        merge_held(out, {name: (err, [shape])})

    for args, kw in calls.get("sync_detect", []):
        e_cfo, e_ratio, _ = hold_detect(args, f"{label}: {tuple(args[0].shape)}, K {args[1]}")
        note("sync_detect", max(e_cfo, e_ratio), (tuple(args[0].shape), args[1]))
    for args, kw in calls.get("viterbi_decode", []):
        got, want = k2.viterbi_decode(*args, **kw), k2.viterbi_decode_plain(*args, **kw)
        _need(torch.equal(got, want), f"viterbi_decode != plain on {label}: "
                                      f"{tuple(args[0].shape)}, {(got != want).sum().item()} "
                                      f"bits differ")
        note("viterbi_decode", 0.0, tuple(args[0].shape))
    for args, kw in calls.get("viterbi_decode_many", []):
        got = k2.viterbi_decode_many(*args, **kw)
        want = k2.viterbi_decode_many_plain(*args, **kw)
        shape = [tuple(v.shape) for v in args[0]]
        _need(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"viterbi_decode_many != plain on {label}: {shape}")
        note("viterbi_decode_many", 0.0, shape)
    for args, kw in calls.get("polyphase_resample", []):
        e = max_err(k34.polyphase_resample(*args, **kw),
                     k34.polyphase_resample_plain(*args, **kw))
        _need(e <= 2e-4, f"polyphase_resample != plain on {label}: {tuple(args[0].shape)} "
                         f"at {args[1]}/{args[2]}: {e:.3g} (2e-4)")
        note("polyphase_resample", e, tuple(args[0].shape))
    return out


def merge_held(held: dict, out: dict) -> None:
    """Adds a ``hold_recorded`` result to ``held`` (the largest error, the
    shapes appended), kernel by kernel."""
    for name, (e, shapes) in out.items():
        e0, s0 = held.get(name, (0.0, []))
        held[name] = (max(e0, e), s0 + shapes)
