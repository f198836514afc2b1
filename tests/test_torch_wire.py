"""Host staging of the receiver's wire stream: ``quantize_wire_into`` (the
native one-pass quantizer and its numpy fallback) against the JAX
package's ``quantize_wire`` byte for byte, and the executors' staging
(``_pad_wire`` into a reused buffer, ``stage_resident``) against a fresh
zero-padded quantization by the JAX package, with its ``wire_alloc`` and
``wire_fallback`` counters.

The CUDA case of the staging test is marked ``cuda`` and skips without a
GPU; the native cases skip where g++ is missing. On a card host without
JAX (``--noconftest``) the quantizer test skips and the staging test's
CUDA case takes the port's ``quantize_wire``, which the quantizer test
holds to the JAX package's wherever JAX imports."""

import importlib

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor as pexec
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import AdaptiveStreamExecutor
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native
from gnuradio_wifi_imagetransfer_tpu_torch.utils import xfer

JAX_XFER = "gnuradio_wifi_imagetransfer_tpu.utils.xfer"
SCALES = {"sc16": (32767.0 / xfer.SC16_FULL_SCALE, 32767), "sc8": (127.0 / xfer.SC8_FULL_SCALE, 127)}


def _ties(fmt):
    """float32 values v whose float32 product v * k is exactly m + 0.5,
    checked in numpy, over the whole integer range and beyond."""
    k, top = SCALES[fmt]
    m = np.arange(-top - 3, top + 3, max(1, top // 997), dtype=np.float32)
    v = ((m + np.float32(0.5)) / np.float32(k)).astype(np.float32)
    exact = (v * np.float32(k)) == (m + np.float32(0.5))
    assert exact.sum() > 100
    return v[exact]


def _cases(fmt):
    """(name, (n, 2) float32 riq) streams: random at amplitudes 0.5 and
    3.9, exact ties, full scale and beyond with -0.0, each cut to lengths
    0, 1, 7, 8 and 9 too (the native loop's scalar tail)."""
    rng = np.random.default_rng(22)
    streams = {f"random{a}": (a * rng.uniform(-1, 1, (4099, 2))).astype(np.float32)
               for a in (0.5, 3.9)}
    for f in ("sc16", "sc8"):
        streams[f"ties_{f}"] = _ties(f).reshape(-1, 1).repeat(2, 1) * np.float32([1, -1])
    edges = np.float32([4.0, -4.0, 2.0, -2.0, 4.0001, -4.0001, 2.0001, -2.0001, 3.99995,
                        -3.99995, 1e3, -1e3, 1e30, -1e30, 0.0, -0.0, 1e-30, -1e-30])
    streams["edges"] = np.concatenate([edges, edges[::-1]]).reshape(-1, 2)
    cases = list(streams.items())
    for name, x in streams.items():
        cases += [(f"{name}[:{n}]", x[:n]) for n in (0, 1, 7, 8, 9)]
    return cases


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("fmt", ["sc16", "sc8", "f32"])
def test_quantize_wire_into_matches_quantize_wire(monkeypatch, fmt, path):
    if path == "native" and not native.available():
        pytest.skip("g++ is unavailable: the native library cannot be built")
    jxfer = pytest.importorskip(JAX_XFER)
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    for name, riq in _cases(fmt):
        want = jxfer.quantize_wire(riq, fmt)
        out = np.full(riq.shape, 0x5A, xfer.WIRE_DTYPES[fmt])
        xfer.quantize_wire_into(riq, fmt, out)
        assert out.dtype == want.dtype and out.tobytes() == want.tobytes(), name
    with pytest.raises(ValueError, match="unknown wire_format"):
        xfer.quantize_wire_into(riq, "sc-8", out)
    riq = _cases(fmt)[0][1]                 # pointers cross only after these checks
    wide = np.zeros((riq.shape[0], 4), xfer.WIRE_DTYPES[fmt])
    for bad in (wide[:, ::2], wide[:, :2].astype(np.float64 if fmt != "f32" else np.int16),
                wide[:-1, :2].copy(), wide.T[:2].copy()):
        with pytest.raises(ValueError, match="quantize_wire_into"):
            xfer.quantize_wire_into(riq, fmt, bad)


def _reference_xfer(device):
    """The JAX package's ``to_riq`` and ``quantize_wire``; on a card host
    without JAX, the port's (held to JAX's by the quantizer test)."""
    if device == "cpu":
        return pytest.importorskip(JAX_XFER)
    try:
        return importlib.import_module(JAX_XFER)
    except ImportError:
        return xfer


BLOCK = 1 << 12


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_staging_reuses_its_buffer_and_leaves_no_stale_samples(monkeypatch, device, path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if path == "native" and not native.available():
        pytest.skip("g++ is unavailable: the native library cannot be built")
    ref = _reference_xfer(device)
    cfg = ExecutorConfig(block_size=BLOCK, time_shards=2, channels=2,
                         max_frames_per_block=4, wire_format="sc16")
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        with pytest.warns(RuntimeWarning, match="wire quantizer"):
            ex = AdaptiveStreamExecutor(exec_cfg=cfg, device=device)
    else:
        ex = AdaptiveStreamExecutor(exec_cfg=cfg, device=device)
    rng = np.random.default_rng(5)
    span = 2 * BLOCK
    lengths = (2 * span - 37, span + 301)      # longer first: one padded shape
    assert ex.padded_out_len(lengths[0]) == ex.padded_out_len(lengths[1])
    for n in lengths:
        x = (1.3 * (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n)))
             ).astype(np.complex64)
        want = np.zeros((2, ex.padded_out_len(n), 2), np.int16)
        for ch in range(2):
            want[ch, pexec.HALO_LEFT: pexec.HALO_LEFT + n] = ref.quantize_wire(
                ref.to_riq(x[ch]), "sc16")
        ex.stage_resident(x)
        got = ex._dev_stream.cpu().numpy()
        assert got.dtype == np.int16 and got.tobytes() == want.tobytes()
    report = ex.tracer.report()
    assert report["layout"].calls == 2 and report["transfer"].calls == 2
    alloc = report["wire_alloc"].calls if "wire_alloc" in report else 0
    assert alloc == (1 if device == "cuda" else 0)
    fallback = report["wire_fallback"].calls if "wire_fallback" in report else 0
    assert fallback == (2 if path == "numpy" else 0)
