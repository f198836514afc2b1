"""Host staging of the receiver's wire stream: ``quantize_wire_into`` (the
native one-pass quantizer and its numpy fallback) against the JAX
package's ``quantize_wire`` byte for byte, and the executors' staging
(``_pad_wire`` into a reused buffer, ``stage_resident``) against a fresh
zero-padded quantization by the JAX package, with its ``wire_alloc``,
``wire_fallback`` and ``wire_split`` counters. The staging pool
(``WirePool``) is held to the same bytes with a small minimum segment, so
that it splits at CPU sizes, and at the executor's own minimum on a card.

The CUDA cases are marked ``cuda`` and skip without a GPU; the native
cases skip where g++ is missing. On a card host without
JAX (``--noconftest``) the quantizer test skips and the staging test's
CUDA case takes the port's ``quantize_wire``, which the quantizer test
holds to the JAX package's wherever JAX imports."""

import importlib
import os
import sys
import threading

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
    assert report["wire_split"].calls == 0 and report["wire_split"].samples == 0


@pytest.mark.cuda
def test_pooled_staging_fills_the_device_tensor_as_the_inline_path(monkeypatch):
    """Above the minimum segment a CUDA executor stages on the pool, whose
    threads exist once the constructor returns, on its caller's cores; the
    device tensor holds the inline path's bytes, a shorter stream after a
    longer one leaves nothing stale, and ``wire_split`` counts the
    segments. Building more executors starts no more threads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not native.available():
        pytest.skip("g++ is unavailable: the native library cannot be built")
    ref = _reference_xfer("cuda")
    block = 1 << 17
    span = 4 * block
    assert span == xfer.WIRE_MIN_SEGMENT
    cfg = ExecutorConfig(block_size=block, time_shards=4, channels=2,
                         max_frames_per_block=4, wire_format="sc16")
    monkeypatch.setattr(xfer, "_pool", None)          # this test starts the process's pool
    cores = sorted(os.sched_getaffinity(0))
    mine = set(cores[: max(1, len(cores) // 2)])
    os.sched_setaffinity(0, mine)
    try:
        ex = AdaptiveStreamExecutor(exec_cfg=cfg, device="cuda")
    finally:
        os.sched_setaffinity(0, set(cores))
    try:
        pool = ex._wire_pool
        assert pool is xfer._pool and len(pool.threads) == min(xfer.WIRE_WORKERS, len(mine))
        assert all(t.is_alive() and os.sched_getaffinity(t.native_id) == mine
                   for t in pool.threads)
        threads = threading.active_count()
        inline = AdaptiveStreamExecutor(exec_cfg=cfg, device="cuda")
        assert inline._wire_pool is pool and threading.active_count() == threads
        inline._wire_pool = None
        rng = np.random.default_rng(26)
        lengths = (4 * span - 37, 3 * span + 301)       # longer first: one padded shape
        assert ex.padded_out_len(lengths[0]) == ex.padded_out_len(lengths[1])
        for n in lengths:
            x = _stream(rng, 2, n)
            want = np.zeros((2, ex.padded_out_len(n), 2), np.int16)
            for ch in range(2):
                want[ch, pexec.HALO_LEFT: pexec.HALO_LEFT + n] = ref.quantize_wire(
                    ref.to_riq(x[ch]), "sc16")
            ex.stage_resident(x)
            inline.stage_resident(x)
            got = ex._dev_stream.cpu().numpy()
            assert got.tobytes() == inline._dev_stream.cpu().numpy().tobytes()
            assert got.tobytes() == want.tobytes()
        split = ex.tracer.report()["wire_split"]
        assert split.calls == 2 * 3 + 2 * 3 and split.samples == 2 * sum(lengths)
        assert inline.tracer.report()["wire_split"].calls == 0
        assert ex.tracer.report()["wire_alloc"].calls == 1
    finally:
        xfer._pool.close()


# -- the staging pool -------------------------------------------------------

SEG = 37                # a minimum segment no multiple of 8, so the pool splits at CPU sizes


def _stream(rng, c, n, scale=1.3):
    return (scale * (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n)))
            ).astype(np.complex64)


@pytest.fixture
def pool():
    p = xfer.WirePool(3)
    yield p
    p.close()


@pytest.mark.parametrize("n", [SEG, 2 * SEG + 5, 3 * SEG, 7 * SEG + 3, 4099])
@pytest.mark.parametrize("fmt", ["sc16", "sc8", "f32"])
def test_pool_quantizes_rows_as_quantize_wire(pool, fmt, n):
    """Every segment's bytes equal ``quantize_wire``'s; the segments come
    back row after row, cover each row, and are final when reported."""
    ref = pytest.importorskip(JAX_XFER)
    x = _stream(np.random.default_rng(n), 3, n, scale=3.9)
    want = np.stack([ref.quantize_wire(ref.to_riq(x[ch]), fmt) for ch in range(3)])
    out = np.full((3, n, 2), 0x5A, xfer.WIRE_DTYPES[fmt])
    parts = []

    def on_part(ch, lo, hi):
        assert out[ch, lo:hi].tobytes() == want[ch, lo:hi].tobytes()
        parts.append((ch, lo, hi))

    split = pool.quantize_rows(x, fmt, out, on_part, min_segment=SEG)
    assert out.tobytes() == want.tobytes()
    per_row = min(3, n // SEG)
    assert split == len(parts) == 3 * per_row
    for ch in range(3):
        row = [(lo, hi) for c, lo, hi in parts if c == ch]
        assert [c for c, _, _ in parts] == sorted(c for c, _, _ in parts)
        assert row[0][0] == 0 and row[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(row, row[1:]))
        assert all(hi - lo >= SEG for lo, hi in row)


def test_pool_raises_a_workers_exception_once_every_segment_ended(monkeypatch, pool):
    ref = pytest.importorskip(JAX_XFER)
    x = _stream(np.random.default_rng(9), 4, 10 * SEG)
    want = np.stack([ref.quantize_wire(ref.to_riq(x[ch]), "sc16") for ch in range(4)])
    out = np.zeros((4, 10 * SEG, 2), np.int16)
    real = xfer.quantize_wire_into

    def failing(riq, fmt, dst):
        if np.shares_memory(dst, out[1]):
            raise RuntimeError("segment of row 1 failed")
        real(riq, fmt, dst)

    monkeypatch.setattr(xfer, "quantize_wire_into", failing)
    with pytest.raises(RuntimeError, match="row 1 failed"):
        pool.quantize_rows(x, "sc16", out, min_segment=SEG)
    # every other row's segments ran to their end before the raise
    for ch in (0, 2, 3):
        assert out[ch].tobytes() == want[ch].tobytes()
    monkeypatch.setattr(xfer, "quantize_wire_into", real)
    out[:] = 0
    assert pool.quantize_rows(x, "sc16", out, min_segment=SEG) == 12
    assert out.tobytes() == want.tobytes()


def test_pool_under_contention_reports_every_segment_once_in_order():
    """More workers than cores, a short switch interval and many small
    segments: every call still reports each segment once, row after row,
    with its final bytes."""
    ref = pytest.importorskip(JAX_XFER)
    rng = np.random.default_rng(31)
    x = _stream(rng, 8, 12 * SEG + 7)
    want = np.stack([ref.quantize_wire(ref.to_riq(row), "sc8") for row in x])
    p = xfer.WirePool(len(os.sched_getaffinity(0)) + 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            out = np.zeros(want.shape, np.int8)
            parts = []
            p.quantize_rows(x, "sc8", out,
                            lambda ch, lo, hi: parts.append((ch, lo, hi, out[ch, lo:hi].copy())),
                            min_segment=SEG)
            assert out.tobytes() == want.tobytes()
            keys = [(ch, lo) for ch, lo, _, _ in parts]
            assert keys == sorted(set(keys)) and len(keys) == 8 * min(12, len(p.threads))
            assert all(seg.tobytes() == want[ch, lo:hi].tobytes() for ch, lo, hi, seg in parts)
    finally:
        sys.setswitchinterval(interval)
        p.close()

def test_pool_threads_take_the_constructing_threads_cores_and_close():
    cores = sorted(os.sched_getaffinity(0))
    mine = set(cores[: max(1, len(cores) // 2)])
    before = threading.active_count()
    os.sched_setaffinity(0, mine)
    try:
        p = xfer.WirePool(2)
    finally:
        os.sched_setaffinity(0, set(cores))
    try:
        assert all(t.is_alive() for t in p.threads)
        assert all(os.sched_getaffinity(t.native_id) == mine for t in p.threads)
        assert threading.active_count() == before + 2
    finally:
        p.close()
    assert threading.active_count() == before and not any(t.is_alive() for t in p.threads)


@pytest.mark.parametrize("n,split", [(5 * BLOCK + 11, True), (BLOCK - 1, False)])
def test_pad_wire_splits_rows_no_shorter_than_the_minimum(monkeypatch, pool, n, split):
    """``_pad_wire`` with a pool: rows of at least WIRE_MIN_SEGMENT samples
    are quantized on it, shorter ones inline; the padded bytes are the
    same, and ``wire_split`` counts the pool's segments (0 inline)."""
    ref = pytest.importorskip(JAX_XFER)
    cfg = ExecutorConfig(block_size=BLOCK, time_shards=2, channels=2,
                         max_frames_per_block=4, wire_format="sc16")
    ex = AdaptiveStreamExecutor(exec_cfg=cfg, device="cpu")
    assert ex._wire_pool is None                 # the CPU device stages inline
    ex._wire_pool = pool
    monkeypatch.setattr(pexec, "WIRE_MIN_SEGMENT", BLOCK)
    x = _stream(np.random.default_rng(n), 2, n)
    want = np.zeros((2, ex.padded_out_len(n), 2), np.int16)
    for ch in range(2):
        want[ch, pexec.HALO_LEFT: pexec.HALO_LEFT + n] = ref.quantize_wire(
            ref.to_riq(x[ch]), "sc16")
    got = ex._pad_wire(x)
    assert got.tobytes() == want.tobytes()
    report = ex.tracer.report()["wire_split"]
    assert report.calls == (2 * min(3, n // BLOCK) if split else 0)
    assert report.samples == (2 * n if split else 0)


def test_executors_share_one_pool_and_cpu_ones_start_none():
    cfg = ExecutorConfig(block_size=BLOCK, time_shards=2, channels=2,
                         max_frames_per_block=4, wire_format="sc16")
    before = threading.active_count()
    assert all(AdaptiveStreamExecutor(exec_cfg=cfg, device="cpu")._wire_pool is None
               for _ in range(3))
    assert threading.active_count() == before
    assert xfer.wire_pool() is xfer.wire_pool()
