"""The port's radios (runtime/bridge.py), AppConfig and the image wire
format, held against the JAX package on the CPU.

The radio twins repeat tests/test_runtime.py's end-to-end cases on the
port's radios with device="cpu": same images, seeds and radio settings,
every piece delivered. TxRadio: the sc16 sample datagrams of the port and
the JAX package agree within 1 LSB a component for the same 4 payloads
(the largest difference on the CPU for this test's payloads is 1 LSB: the
two libraries' float32 IFFTs differ by a few ulps, which moves a value
that lies next to a rounding midpoint).
RxRadio: ``_process`` hands over the same payloads in the same order, and
ends with the same stats, as the JAX package's on one stream fed in the
radio's passes."""

import dataclasses
import pickle
import socket
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.phy import mac as jmac
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu.runtime import bridge as jbridge
from gnuradio_wifi_imagetransfer_tpu.utils import image as jimage
from gnuradio_wifi_imagetransfer_tpu_torch import config
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import bridge
from gnuradio_wifi_imagetransfer_tpu_torch.runtime.bridge import LoopbackRadio, RxRadio, TxRadio
from gnuradio_wifi_imagetransfer_tpu_torch.utils import image as imgutil
from gnuradio_wifi_imagetransfer_tpu_torch.utils.xfer import SC16_FULL_SCALE, quantize_sc16, to_riq

torch.set_num_threads(2)


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _app_socket(port=0):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    s.bind(("127.0.0.1", port))
    s.settimeout(30.0)
    return s


def _collect_pieces(sock, want, canvas=None, seconds=120):
    """Piece keys received on sock (the radio stripped the 4-byte prefix:
    a datagram is a bare pickled piece), drawn into canvas."""
    got = set()
    deadline = time.time() + seconds
    while len(got) < want and time.time() < deadline:
        try:
            data, _ = sock.recvfrom(65536)
        except socket.timeout:
            break
        piece = pickle.loads(data)
        if canvas is not None:
            imgutil.redraw_image(piece, canvas)
        got.add(piece[0])
    return got


def _send(pieces, port, spacing):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for p in pieces:
        s.sendto(imgutil.encode_piece(p), ("127.0.0.1", port))
        time.sleep(spacing)
    s.close()


# -- the radio twins of tests/test_runtime.py --------------------------------


def test_loopback_radio_end_to_end():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(img, rng=rng)       # 12 pieces
    rx = _app_socket()
    radio = LoopbackRadio(in_port=0, out_port=rx.getsockname()[1], mcs=3,
                          snr_db=25.0, epsilon=5e-6, batch=4, device="cpu").start()
    try:
        _send(pieces, radio.in_port, 0.01)
        canvas = np.zeros_like(img)
        seen = _collect_pieces(rx, len(pieces), canvas)
        assert len(seen) == len(pieces), f"only {len(seen)}/{len(pieces)} pieces"
        assert np.array_equal(canvas, img)
        # no copies are sent, so every decoded frame is a distinct piece
        assert radio.stats["frames_ok"] == len(pieces)
        assert radio.stats["datagrams_in"] == len(pieces)
    finally:
        radio.stop()
        rx.close()


def test_split_radio_topology():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(img, rng=rng)           # 12 pieces
    app_rx = _app_socket()
    rx_cfg = config.ExecutorConfig(block_size=1 << 14, time_shards=4, max_frames_per_block=8)
    rxr = RxRadio(samp_port=0, out_port=app_rx.getsockname()[1], chunk=1 << 15,
                  exec_cfg=rx_cfg, device="cpu").start()
    txr = TxRadio(in_port=0, samp_port=rxr.samp_port, mcs=3, batch=4, device="cpu").start()
    try:
        _send(pieces, txr.in_port, 0.02)
        canvas = np.zeros_like(img)
        seen = _collect_pieces(app_rx, len(pieces), canvas)
        assert len(seen) == len(pieces), (
            f"only {len(seen)}/{len(pieces)} pieces; tx {txr.stats}, rx {rxr.stats}")
        assert np.array_equal(canvas, img)
        assert rxr.stats["frames_ok"] >= len(pieces)
        assert txr.stats["frames_tx"] == len(pieces)
        pts = rxr.constellation.points(100)
        assert pts.shape[0] == 100
        assert float(np.max(np.abs(pts))) > 0.3        # near unit circle
        assert float(np.max(rxr.spectrum.psd_db())) > -150
        assert np.isfinite(rxr.snr_probe.snr_db())
    finally:
        txr.stop()
        rxr.stop()
        app_rx.close()


def test_loopback_live_retune_and_probes():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    pieces = imgutil.detach_image(img, rng=rng)       # 12 pieces
    rx = _app_socket()
    radio = LoopbackRadio(in_port=0, out_port=rx.getsockname()[1], mcs=2,
                          snr_db=25.0, batch=4, probes=True, device="cpu").start()
    try:
        _send(pieces[:6], radio.in_port, 0.01)
        first = _collect_pieces(rx, 6)
        assert len(first) == 6, f"pre-retune: {len(first)}/6"
        # live retune: MCS 2 -> 5, SNR up, small CFO, STA equalizer
        radio.set_encoding(5)
        radio.set_snr(30.0)
        radio.set_epsilon(2e-6)
        radio.set_chan_est(3)
        _send(pieces[6:], radio.in_port, 0.01)
        second = _collect_pieces(rx, 6)
        assert len(second) == 6, f"post-retune: {len(second)}/6"
        assert radio.mcs == 5 and radio.snr_db == 30.0
        assert radio.chan_est == config.ChannelEstimator.STA
        assert radio.constellation.points().shape[0] > 0
        assert radio.spectrum.psd_db().max() > -200.0
        assert np.isfinite(radio.snr_probe.snr_db())
    finally:
        radio.stop()
        rx.close()


# -- TxRadio and RxRadio against the JAX package -----------------------------


def _datagrams(sock, n_samples):
    """sc16 datagrams from sock until n_samples samples have arrived."""
    out, got = [], 0
    while got < n_samples:
        data, _ = sock.recvfrom(65536)
        out.append(np.frombuffer(data, np.int16).reshape(-1, 2))
        got += out[-1].shape[0]
    return out


class _QueuedSource:
    """A radio source holding datagrams queued before start(): the first
    drain hands them all over, as a native source does with datagrams
    that arrived before the radio started, whatever the sockets' timing."""

    port = 0

    def __init__(self, payloads):
        self.pending = list(payloads)

    def start(self):
        return self

    def drain(self, max_items, timeout=0.05):
        out, self.pending = self.pending[:max_items], self.pending[max_items:]
        if not out:
            time.sleep(timeout)
        return out

    def stop(self):
        pass


def test_tx_radio_datagrams_match_jax_within_1_lsb():
    """Both TxRadios get the same 4 equal-length payloads queued before
    start(), so each drains them as one batch: the same frames, seeds 1-4,
    the same pads and scale, the same sc16 datagrams within 1 LSB."""
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, 90, dtype=np.uint8).tobytes() for _ in range(4)]
    want_samples = 4 * (jtx.tx_plan(2, 90 + 28).n_samples + 1100)
    socks = [_app_socket(), _app_socket()]
    radios = [jbridge.TxRadio(in_port=0, samp_port=socks[0].getsockname()[1]),
              TxRadio(in_port=0, samp_port=socks[1].getsockname()[1], device="cpu")]
    try:
        for r in radios:
            r.source.stop()
            r.source = _QueuedSource(payloads)
            r.start()
        want, got = (_datagrams(s, want_samples) for s in socks)
        assert [d.shape for d in got] == [d.shape for d in want]
        assert sum(d.shape[0] for d in got) == want_samples
        assert all(d.shape[0] == bridge._SAMP_CHUNK for d in got[:-1])
        diff = max(int(np.abs(g.astype(np.int32) - w).max()) for g, w in zip(got, want))
        assert diff <= 1, diff
        for r in radios:
            r.stop()                    # the loops have counted the batch
        assert radios[1].stats == radios[0].stats == {
            "datagrams_in": 4, "frames_tx": 4, "samples_tx": want_samples}
    finally:
        for r in radios:
            r.stop()
        for s in socks:
            s.close()


class _ListSink:
    def __init__(self):
        self.payloads = []

    def send_mac_payload(self, payload):
        self.payloads.append(payload[4:])

    def close(self):
        pass


def _pass_spans(n, chunk, tail, datagram=4096):
    """The [lo, hi) sample spans of RxRadio._run's passes over n samples
    arriving in datagrams: a pass whenever ``chunk`` samples are buffered,
    keeping ``tail`` samples of overlap, then the idle flush."""
    spans, lo, hi = [], 0, 0
    while hi < n:
        hi = min(hi + datagram, n)
        if hi - lo >= chunk:
            spans.append((lo, hi))
            lo = hi - min(tail, hi - lo)
    if hi - lo > tail:
        spans.append((lo, hi))
    return spans


def _feed(radio, x, spans):
    """RxRadio._run's passes over x: seen pruned to each pass's base."""
    seen = set()
    for lo, hi in spans:
        seen = {g for g in seen if g >= lo}
        radio._process(x[lo:hi], lo, seen)


_CHUNK, _PHY = 1 << 14, dict(max_psdu_bytes=200)     # tail: window_len(68) = 6160


def _rx_stream(seed, avoid=(), rates=(0, 3, 5, 7, 2, 6, 3, 1, 4, 5, 0, 7, 2), lead=0,
               end_pad=None):
    """Frames of mixed MCS and two lengths as sc16 sample datagrams carry
    them (JAX TX, scale 0.5, pads of 100 and 1 000+ samples, noise 0.01),
    one MPDU with a broken FCS among them. A frame that would lie within
    400 samples of a sample index in ``avoid`` is moved past it; ``lead``
    zeros come first and ``end_pad`` (if given) samples follow the last
    burst. Returns (stream, good payloads in stream order, frame spans)."""
    rng = np.random.default_rng(seed)
    m = jmac.Mac()
    parts, good, frames, pos = [np.zeros(lead, np.complex64)], [], [], lead
    for i, mcs in enumerate(rates):
        payload = rng.integers(0, 256, 60 if i % 3 else 110, dtype=np.uint8).tobytes()
        mpdu = np.frombuffer(m.frame(payload), np.uint8).copy()
        if i == 6:
            mpdu[40] ^= 0x10            # FCS fails
        else:
            good.append(payload[4:])
        b = np.asarray(jtx.transmit(jnp.asarray(mpdu)[None], mcs, scrambler_seed=i + 1))[0]
        span = 100 + b.size + 1000 + 37 * i
        if end_pad is not None and i == len(rates) - 1:
            span = 100 + b.size + end_pad
        start = pos
        for e in avoid:
            if start - 400 < e < start + 100 + b.size + 600:
                start = e + 400
        parts += [np.zeros(start - pos + 100, np.complex64), 0.5 * b,
                  np.zeros(span - 100 - b.size, np.complex64)]
        frames.append((start + 100, start + 100 + b.size))
        pos = start + span
    x = np.concatenate(parts)
    x = x + 0.01 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    sc16 = quantize_sc16(to_riq(x.astype(np.complex64)))
    return ((sc16[:, 0] + 1j * sc16[:, 1]) * (SC16_FULL_SCALE / 32767.0)).astype(
        np.complex64), good, frames


def _rx_radios():
    """The JAX and the port RxRadio at one small configuration, each with
    its sink swapped for a list."""
    ex = dict(block_size=1 << 13, time_shards=2, max_frames_per_block=8)
    radios = [jbridge.RxRadio(samp_port=0, out_port=_free_port(), chunk=_CHUNK,
                              exec_cfg=jconfig.ExecutorConfig(**ex),
                              phy_cfg=jconfig.PhyConfig(**_PHY)),
              RxRadio(samp_port=0, out_port=_free_port(), chunk=_CHUNK,
                      exec_cfg=config.ExecutorConfig(**ex), phy_cfg=config.PhyConfig(**_PHY),
                      device="cpu")]
    for r in radios:
        r.sink.close()
        r.sink = _ListSink()
    assert radios[1].tail == radios[0].tail == 6160
    return radios


def test_rx_radio_process_matches_jax():
    """No frame crosses the end of a pass (placed clear of them); frames
    in a pass's kept tail are decoded again in the next pass and deduped."""
    ends = [hi for _, hi in _pass_spans(1 << 20, _CHUNK, 6160)]
    x, good, frames = _rx_stream(3, avoid=ends)
    spans = _pass_spans(x.size, _CHUNK, 6160)
    assert len(spans) >= 3
    twice = [f for f in frames if sum(lo <= f[0] and f[1] <= hi for lo, hi in spans) > 1]
    assert twice                        # the dedup across passes is exercised
    jr, pr = _rx_radios()
    try:
        for r in (jr, pr):
            _feed(r, x, spans)
        assert pr.sink.payloads == jr.sink.payloads == good
        assert pr.stats == jr.stats
        assert pr.stats["frames_ok"] == len(good) and pr.stats["frames_crc_fail"] == 1
        np.testing.assert_allclose(pr.constellation.points(), jr.constellation.points(),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(pr.spectrum.psd_db(), jr.spectrum.psd_db(), atol=1e-3)
    finally:
        for r in (jr, pr):
            r.stop()


def test_rx_radio_keeps_frames_that_cross_a_pass_end():
    """Frames back to back, so pass ends cut some of them. The port leaves
    a cut frame to the next pass and delivers every good payload in stream
    order; the JAX package marks the cut frame seen after a failed FCS and
    loses it (a fault of the reference): it delivers a subset, in the same
    order, and counts the cuts as FCS failures."""
    x, good, frames = _rx_stream(3)
    spans = _pass_spans(x.size, _CHUNK, 6160)
    cut = [f for f in frames if any(f[0] < hi < f[1] + 200 for _, hi in spans[:-1])]
    assert cut
    jr, pr = _rx_radios()
    try:
        for r in (jr, pr):
            _feed(r, x, spans)
        assert pr.sink.payloads == good
        assert pr.stats["frames_ok"] == len(good) and pr.stats["frames_crc_fail"] == 1
        lost = [p for p in good if p not in jr.sink.payloads]
        assert jr.sink.payloads == [p for p in good if p not in lost]
        assert lost and jr.stats["frames_crc_fail"] == 1 + len(lost)
    finally:
        for r in (jr, pr):
            r.stop()


class _DatagramSocket:
    """A sample socket that hands over the given datagrams, then times out
    as an idle socket does."""

    def __init__(self, datagrams):
        self.datagrams = list(datagrams)

    def recvfrom(self, size):
        if self.datagrams:
            return self.datagrams.pop(0), None
        time.sleep(0.05)
        raise socket.timeout

    def close(self):
        pass


@pytest.mark.parametrize("last_pass", ["idle", "chunk"])
def test_rx_radio_run_delivers_the_frame_at_the_stream_end(last_pass):
    """The last burst ends 8 samples before the stream does, and nothing
    follows. "idle": the stream is shorter than a chunk, so the idle flush
    is its one pass. "chunk": the last datagram completes a chunk pass at
    the stream's end; the port leaves the last frame to the next pass,
    and the idle flush then runs on the kept tail alone. RxRadio._run
    hands over every payload, as the JAX package's does."""
    rates = (3, 0, 5, 2)
    x, good, _ = _rx_stream(7, rates=rates, end_pad=8)
    n = {"idle": 12_000, "chunk": _CHUNK + 1_000}[last_pass]
    assert x.size < n
    x, good, frames = _rx_stream(7, rates=rates, lead=n - x.size, end_pad=8)
    assert x.size == n and frames[-1][1] == n - 8
    wire = quantize_sc16(to_riq(x)).tobytes()          # x is sc16 already
    cuts = [0, 4096, 8192, 12_288, n] if last_pass == "chunk" else [0, 4096, 8192, n]
    jr, pr = _rx_radios()
    try:
        for r in (jr, pr):
            r.samp_sock = _DatagramSocket(wire[4 * lo:4 * hi] for lo, hi in zip(cuts, cuts[1:]))
            r.start()
        deadline = time.time() + 120
        while time.time() < deadline and any(len(r.sink.payloads) < len(good) for r in (jr, pr)):
            time.sleep(0.1)
        time.sleep(0.5)                                  # a copy would follow the last one
        assert jr.sink.payloads == good
        assert pr.sink.payloads == good
        assert pr.stats == jr.stats == {"samples_in": n, "frames_ok": len(good),
                                        "frames_crc_fail": 0}
    finally:
        for r in (jr, pr):
            r.stop()


# -- lifecycle, devices and the app-layer copies ------------------------------


def test_radios_stop_before_start_returns():
    radios = [LoopbackRadio(in_port=0, out_port=_free_port(), device="cpu"),
              TxRadio(in_port=0, samp_port=_free_port(), device="cpu"),
              RxRadio(samp_port=0, out_port=_free_port(), device="cpu")]
    done = threading.Event()

    def stop_all():
        for r in radios:
            r.stop()
        done.set()

    threading.Thread(target=stop_all, daemon=True).start()
    assert done.wait(timeout=10.0), "stop() before start() did not return"


def test_radios_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: LoopbackRadio(in_port=0, out_port=_free_port()),
                 lambda: TxRadio(in_port=0, samp_port=_free_port()),
                 lambda: RxRadio(samp_port=0, out_port=_free_port())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_udp_factories_take_the_native_classes():
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native

    if not native.available():
        pytest.skip("g++ is unavailable: the native library cannot be built")
    src = bridge.make_udp_source("127.0.0.1", 0)
    sink = bridge.make_udp_sink("127.0.0.1", src.port)
    try:
        assert isinstance(src, native.NativeUdpSource)
        assert isinstance(sink, bridge.NativeExtractSink)
        sink.send_mac_payload(b"\x01\x02\x03\x04payload")
        got = []
        for _ in range(20):
            got += src.drain(4, timeout=0.1)
            if got:
                break
        assert got == [b"payload"]
    finally:
        src.stop()
        sink.close()


def test_python_udp_source_and_sink_roundtrip():
    src = bridge.UdpSource("127.0.0.1", 0).start()
    sink = bridge.UdpSink("127.0.0.1", src.port)
    try:
        for i in range(3):
            sink.send_mac_payload(b"pfx" + bytes([i]) + b"data%d" % i)
        got = []
        for _ in range(20):
            got += src.drain(8, timeout=0.1)
            if len(got) == 3:
                break
        assert sorted(got) == [b"data0", b"data1", b"data2"]
    finally:
        src.stop()
        sink.close()
    bridge.UdpSource("127.0.0.1", 0).stop()            # before start()


def test_python_udp_source_stamps_and_no_drops():
    src = bridge.UdpSource("127.0.0.1", 0).start()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        t0 = time.monotonic_ns()
        for i in range(3):
            s.sendto(b"data%d" % i, ("127.0.0.1", src.port))
        got, stamps = [], []
        st = np.empty(8, dtype=np.int64)
        for _ in range(20):
            out = src.drain(8, 0.1, st)
            got += out
            stamps += st[:len(out)].tolist()
            if len(got) == 3:
                break
        t1 = time.monotonic_ns()
        assert got == [b"data0", b"data1", b"data2"] and len(stamps) == 3
        assert all(t0 <= t <= t1 for t in stamps) and stamps == sorted(stamps)
        assert src.dropped == 0
    finally:
        s.close()
        src.stop()


@pytest.mark.parametrize("fault", ["no library", "OSError"])
def test_udp_factories_warn_when_they_fall_back(monkeypatch, fault):
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native

    def refuse(*a, **kw):
        raise OSError("refused")

    if fault == "no library":
        monkeypatch.setattr(native, "available", lambda: False)
        match = "no native library"
    else:
        monkeypatch.setattr(native, "available", lambda: True)
        monkeypatch.setattr(native, "NativeUdpSource", refuse)
        monkeypatch.setattr(native, "NativeUdpSink", refuse)
        match = "OSError: refused"
    with pytest.warns(RuntimeWarning, match=match):
        src = bridge.make_udp_source("127.0.0.1", 0)
    with pytest.warns(RuntimeWarning, match=match):
        sink = bridge.make_udp_sink("127.0.0.1", src.port)
    assert type(src) is bridge.UdpSource and type(sink) is bridge.UdpSink
    src.stop()
    sink.close()


def test_loopback_radio_traces_its_batch_stages_queue_and_drops():
    """One batch of two payload lengths, queued before the radio's loop
    runs: two groups, each a fetch, one batch, every datagram's wait."""
    rx = _app_socket()
    radio = LoopbackRadio(in_port=0, out_port=rx.getsockname()[1], mcs=3, snr_db=25.0,
                          batch=8, device="cpu")
    payloads = [b"\0\0\0\x1e" + bytes([i]) * 30 for i in range(3)]
    payloads += [b"\0\0\0\x28" + bytes([i]) * 40 for i in range(2)]
    process = radio._process

    def once(batch):
        process(batch)
        radio._stop.set()
    radio._process = once
    radio.source.start()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        t0 = time.monotonic_ns()
        for p in payloads:
            s.sendto(p, ("127.0.0.1", radio.in_port))
        time.sleep(0.3)                            # every datagram queued in the source
        radio._run()                               # one batch, on this thread
        waited_max = (time.monotonic_ns() - t0) / 1e9
        got = sorted(rx.recvfrom(65536)[0] for _ in payloads)
        assert got == sorted(p[4:] for p in payloads)
        st = radio.tracer.report()
        assert radio.tracer.prefix == "radio"
        assert (st["batch"].calls, st["batch"].frames) == (1, len(payloads))
        assert (st["group"].calls, st["group"].frames) == (2, len(payloads))
        five = ("frame", "upload", "replay", "fetch", "parse")
        for name in five + ("send",):
            assert st[name].calls == 2 and st[name].seconds > 0, name
        assert sum(st[n].seconds for n in five) <= st["batch"].seconds
        assert st["send"].seconds < st["parse"].seconds         # each send inside `parse`
        assert st["send"].frames == len(payloads)
        assert st["queue"].frames == len(payloads)
        # each waited the sleep, less its own way to the source's thread
        assert 0.2 * len(payloads) <= st["queue"].seconds <= waited_max * len(payloads)
        assert (st["dropped"].calls, st["dropped"].frames) == (0, 0)
    finally:
        s.close()
        radio.stop()
        rx.close()


def test_loopback_radio_sends_each_payload_as_soon_as_it_is_parsed(monkeypatch):
    """Inside a group, each payload leaves before the next frame's parse."""
    rx = _app_socket()
    radio = LoopbackRadio(in_port=0, out_port=rx.getsockname()[1], mcs=3, snr_db=25.0,
                          batch=8, device="cpu")
    events = []
    parse, send = bridge.macmod.parse, radio.sink.send_mac_payload
    monkeypatch.setattr(bridge.macmod, "parse", lambda b: events.append("parse") or parse(b))
    radio.sink.send_mac_payload = lambda p: events.append("send") or send(p)
    try:
        radio._process([b"\0\0\0\x1e" + bytes([i]) * 30 for i in range(3)])
        assert events == ["parse", "send"] * 3
        assert sorted(rx.recvfrom(65536)[0] for _ in range(3)) == [bytes([i]) * 30
                                                                   for i in range(3)]
    finally:
        radio.stop()
        rx.close()


def test_app_config_matches_jax():
    got, want = config.AppConfig(), jconfig.AppConfig()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tx_port, got.rx_port, got.image_size, got.piece_size, got.piece_interval_s,
            got.pdu_length) == (52001, 10010, (300, 300), (10, 10), 0.05, 50)


@pytest.mark.parametrize("shape,dtype", [((20, 20, 3), np.uint8), ((30, 30, 4), np.float32),
                                         ((25, 15, 1), np.uint8)])
def test_image_pieces_match_jax_byte_for_byte(shape, dtype):
    rng = np.random.default_rng(shape[0])
    img = (rng.integers(0, 256, shape) if dtype == np.uint8
           else rng.standard_normal(shape)).astype(dtype)
    got = imgutil.detach_image(img, rng=np.random.default_rng(9))
    want = jimage.detach_image(img, rng=np.random.default_rng(9))
    assert [k for k, _ in got] == [k for k, _ in want]
    wire = [imgutil.encode_piece(p) for p in got]
    assert wire == [jimage.encode_piece(p) for p in want]
    back = [imgutil.decode_piece(w) for w in wire]
    assert all(k == jk and np.array_equal(v, jv) for (k, v), (jk, jv) in
               zip(back, (jimage.decode_piece(w) for w in wire)))
    rebuilt = imgutil.rebuild_image(back, shape)
    assert np.array_equal(rebuilt, img) and rebuilt.dtype == img.dtype
    assert np.array_equal(rebuilt, jimage.rebuild_image(back, shape))
    canvas = np.zeros_like(img)
    for p in back:
        imgutil.redraw_image(p, canvas)
    assert np.array_equal(canvas, img)
    assert imgutil.strip_transport(wire[0]) == jimage.strip_transport(wire[0])
    with pytest.raises(ValueError, match="truncated"):
        imgutil.decode_piece(wire[0][:-1])
