"""The port's native host runtime loader (runtime/native.py) over its
copy of native/gwt_native.cpp (csrc/gwt_native.cpp): twins of
tests/test_native.py's 9 cases, the
atomic first build, the port's frame_batch on both paths, and the UDP
source's receive stamps and drop count.

The library builds into the port's own git-ignored _build/ (or a test's
temporary directory), never into native/. A test skips only when g++ is
missing, decided inside a fixture."""

import threading
import zlib

import numpy as np
import pytest

from gnuradio_wifi_imagetransfer_tpu.phy import mac as jmac
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("g++ is unavailable: the native library cannot be built")
    return native


def test_crc32_matches_zlib(lib):
    rng = np.random.default_rng(0)
    for n in (1, 7, 24, 500, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert lib.crc32(data.tobytes()) == (zlib.crc32(data.tobytes()) & 0xFFFFFFFF)
        assert lib.crc32(data) == lib.crc32(data.tobytes())


def test_frame_batch_matches_python(lib):
    rng = np.random.default_rng(1)
    payloads = rng.integers(0, 256, (16, 50), dtype=np.uint8)
    got = lib.frame_batch(payloads, 4093, mac.DEFAULT_SRC, mac.DEFAULT_DST, mac.DEFAULT_BSS)
    # the JAX package's stateful Python framer (sequence wraparound too)
    m = jmac.Mac()
    m.seq_no = 4093
    want = np.stack([np.frombuffer(m.frame(payloads[i].tobytes()), dtype=np.uint8)
                     for i in range(16)])
    np.testing.assert_array_equal(got, want)


def test_check_fcs_batch(lib):
    rng = np.random.default_rng(2)
    payloads = rng.integers(0, 256, (8, 30), dtype=np.uint8)
    mpdus = lib.frame_batch(payloads, 0, mac.DEFAULT_SRC, mac.DEFAULT_DST, mac.DEFAULT_BSS)
    assert lib.check_fcs_batch(mpdus).all()
    bad = mpdus.copy()
    bad[3, 10] ^= 0xFF
    ok2 = lib.check_fcs_batch(bad)
    assert not ok2[3] and ok2[[0, 1, 2, 4, 5, 6, 7]].all()


def test_ring_roundtrip(lib):
    ring = lib.RingBuffer(1024)
    assert ring.capacity == 1024
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(700) + 1j * rng.standard_normal(700)).astype(np.complex64)
    assert ring.write(x) == 700
    assert ring.available() == 700
    np.testing.assert_array_equal(ring.read(700), x)
    y = x[:600]                         # wraparound
    assert ring.write(y) == 600
    np.testing.assert_array_equal(ring.read(600), y)
    ring.close()


def test_ring_backpressure(lib):
    ring = lib.RingBuffer(256)
    x = np.ones(300, dtype=np.complex64)
    assert ring.write(x) == 256          # partial write when full
    assert ring.space() == 0
    ring.read(100)
    assert ring.write(x) == 100
    ring.close()


def test_ring_cross_thread_stream(lib):
    ring = lib.RingBuffer(1 << 12)
    total = 50_000
    rng = np.random.default_rng(4)
    data = (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(np.complex64)
    out = np.empty(total, dtype=np.complex64)

    def produce():
        sent = 0
        while sent < total:
            sent += ring.write(data[sent:sent + 1024])

    t = threading.Thread(target=produce)
    t.start()
    got = 0
    while got < total:
        chunk = ring.read(min(777, total - got))
        out[got:got + chunk.size] = chunk
        got += chunk.size
    t.join(timeout=10.0)
    assert not t.is_alive()
    np.testing.assert_array_equal(out, data)
    ring.close()


def test_udp_bridge_roundtrip(lib):
    src = lib.NativeUdpSource(host="127.0.0.1", port=0).start()
    sink = lib.NativeUdpSink("127.0.0.1", src.port)
    msgs = [bytes([i]) * (10 + i) for i in range(5)]
    for msg in msgs:
        sink.send(msg)
    got: list[bytes] = []
    for _ in range(50):
        got.extend(src.drain(8, timeout=0.1))
        if len(got) >= len(msgs):
            break
    assert sorted(got) == sorted(msgs)
    src.stop()
    sink.close()


def _send_all(port, msgs):
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for m in msgs:
        s.sendto(m, ("127.0.0.1", port))
    s.close()


def _drain_all(src, want, stamped=False):
    got, stamps = [], []
    st = np.empty(8, dtype=np.int64)
    for _ in range(50):
        out = src.drain(8, 0.1, st if stamped else None)
        if stamped:
            stamps.extend(st[:len(out)].tolist())
        got.extend(out)
        if len(got) >= want:
            break
    return got, stamps


def test_udp_source_stamps_lie_between_send_and_drain(lib):
    import time

    src = lib.NativeUdpSource(host="127.0.0.1", port=0)
    msgs = [bytes([i]) * (20 + i) for i in range(6)]
    try:
        t0 = time.monotonic_ns()
        _send_all(src.port, msgs)
        got, stamps = _drain_all(src, len(msgs), stamped=True)
        t1 = time.monotonic_ns()
        assert got == msgs and len(stamps) == len(msgs)
        assert all(t0 <= t <= t1 for t in stamps), (t0, stamps, t1)
        assert stamps == sorted(stamps)
        assert src.dropped == 0
        _send_all(src.port, msgs[:2])                 # drain() hands over what it always did
        assert _drain_all(src, 2)[0] == msgs[:2]
        st = np.full(4, -1, dtype=np.int64)
        assert src.drain(4, 0.0, st) == [] and (st == -1).all()
    finally:
        src.stop()


def test_udp_source_drops_the_oldest_and_counts_them(lib):
    import time

    q, k = 4, 3
    src = lib.NativeUdpSource(host="127.0.0.1", port=0, max_queue=q)
    msgs = [bytes([i]) * 12 for i in range(q + k)]
    try:
        _send_all(src.port, msgs)
        deadline = time.monotonic() + 10.0
        while src.dropped < k and time.monotonic() < deadline:
            time.sleep(0.01)
        assert src.dropped == k
        got, stamps = _drain_all(src, q, stamped=True)
        assert got == msgs[k:] and len(stamps) == q
        assert src.drain(8, timeout=0.05) == [] and src.dropped == k
        with pytest.raises(ValueError, match="stamps"):
            src.drain(8, stamps=np.empty(2, np.int64))
    finally:
        src.stop()


def test_scatter_bursts(lib):
    rng = np.random.default_rng(5)
    bursts = (rng.standard_normal((3, 40)) + 1j * rng.standard_normal((3, 40))).astype(
        np.complex64)
    pos = np.array([10, 100, 480], dtype=np.int64)
    out = lib.scatter_bursts(bursts, pos, 500, scale=0.5)
    want = np.zeros(500, np.complex64)
    for i, p in enumerate(pos):
        seg = bursts[i][: max(0, min(40, 500 - p))]
        want[p:p + seg.size] += np.complex64(0.5) * seg
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_mac_frame_batch_uses_native_and_parses(lib):
    payloads = np.arange(100, dtype=np.uint8).reshape(2, 50)
    mpdus = mac.frame_batch(payloads, seq0=7)
    f = mac.parse(mpdus[1].tobytes())
    assert f.fcs_ok and f.seq_no == 8
    assert f.payload == payloads[1].tobytes()


@pytest.mark.parametrize("seq0,shape", [(0, (3, 1)), (4090, (12, 50)), (17, (1, 267))])
def test_frame_batch_native_equals_numpy(lib, seq0, shape):
    payloads = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    addrs = dict(src=bytes(range(6)), dst=b"\x42" * 6, bss=b"\x01\x02\x03\x04\x05\x06")
    for kw in ({}, addrs):
        got = mac.frame_batch(payloads, seq0, **kw)
        assert np.array_equal(got, lib.frame_batch(
            payloads, seq0, kw.get("src", mac.DEFAULT_SRC), kw.get("dst", mac.DEFAULT_DST),
            kw.get("bss", mac.DEFAULT_BSS)))
        assert np.array_equal(got, mac.frame_batch_numpy(payloads, seq0, **kw))


def test_first_build_from_two_threads_is_atomic(lib, tmp_path):
    """Two threads build into one empty directory at once: each gets the
    same path, loads a working library, and no temporary file is left."""
    build_dir = tmp_path / "build"
    start = threading.Barrier(2)
    results, errors = [], []

    def first_build():
        try:
            start.wait(timeout=10)
            path = native.build(build_dir)
            lib_ = native.bind(path)
            buf = np.frombuffer(b"123456789", np.uint8)
            results.append((path, lib_.gwt_crc32(native._u8(buf), buf.size)))
        except Exception as e:          # reported below: a thread must not hide it
            errors.append(e)

    threads = [threading.Thread(target=first_build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert [r[1] for r in results] == [0xCBF43926, 0xCBF43926]    # CRC-32 check value
    assert results[0][0] == results[1][0] == native.library_path(build_dir)
    assert sorted(p.name for p in build_dir.iterdir()) == [results[0][0].name]


def test_wrappers_validate_shapes(lib):
    with pytest.raises(ValueError, match="6 bytes"):
        lib.frame_batch(np.zeros((1, 4), np.uint8), 0, b"\x00" * 5, mac.DEFAULT_DST,
                        mac.DEFAULT_BSS)
    with pytest.raises(ValueError):
        lib.check_fcs_batch(np.zeros(10, np.uint8))
    with pytest.raises(ValueError):
        lib.scatter_bursts(np.zeros((2, 4), np.complex64), np.zeros(3, np.int64), 10)
