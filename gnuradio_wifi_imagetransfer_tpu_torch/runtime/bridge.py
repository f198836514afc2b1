"""Socket-PDU UDP bridge and the software radios (PyTorch port of the JAX
package's runtime/bridge.py).

Drop-in port compatibility with the reference's process topology:

  app --UDP 52001--> [radio] --UDP 10010--> app

* UdpSource  = network.socket_pdu('UDP_SERVER', '', 52001, 10000)
  (IRS_user.grc:299-318): each datagram becomes one MAC payload.
* UdpSink    = the "Extract Pics" embedded block (IRS_AP_epy_block_2.py:
  27-41): strips the 4-byte length prefix of the MAC payload and forwards
  the rest to localhost:10010.
* LoopbackRadio = the IRS_tranceiver flowgraph: MAC -> 802.11a TX ->
  multiply 10^(snr/20) -> channel_model -> full RX (sync + decode) -> MAC
  parse -> UDP out, with the PHY in torch on the radio's device.
  Datagrams are micro-batched so the device sees frame batches, not single
  frames.
* TxRadio / RxRadio = the IRS_user / IRS_AP two-node topology, with sc16
  I/Q sample datagrams standing in for RF.

The sockets are host code: ``make_udp_source`` / ``make_udp_sink`` take the
native C++ classes (runtime/native.py) when the toolchain is there and the
Python ones otherwise. The PHY runs on ``device`` ("cuda" unless the caller
asks for the CPU), through the hand-written kernels on a card.

On a card each device program is a CUDA graph (parallel/graphs.py), as
each is one jitted program in the JAX package: a LoopbackRadio group
(``loopback_group``: TX, the channel, the receive), keyed (MCS, MPDU
length, group size, equalizer, probes), and a TxRadio group
(``tx_bursts``), keyed (MCS, MPDU length, group size, scale). The host
frames the MPDUs, uploads them with the group's seeds and scalars in one
pinned copy, and fetches the group's outputs in one copy. On the CPU the
same functions run eagerly.

The radio loops catch ``Exception`` and print "dropped ..." so that one bad
datagram does not kill a radio, as the reference's do; a caller that must
see every failure (a test, a smoke run) watches stdout for those lines.
"""

from __future__ import annotations

import functools
import queue
import socket
import threading
import time
import traceback
import warnings

import numpy as np
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.channel import model as chmodel
from gnuradio_wifi_imagetransfer_tpu_torch.config import (
    ChannelEstimator,
    ExecutorConfig,
    PhyConfig,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import AdaptiveStreamExecutor
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.graphs import GraphCache
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac as macmod
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import native
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table, resolve
from gnuradio_wifi_imagetransfer_tpu_torch.utils.xfer import SC16_FULL_SCALE, quantize_sc16, to_riq

# deep kernel receive buffer (capped by net.core.rmem_max): senders burst
# faster than a GIL-bound drain thread during device dispatch, and the
# ~208 KiB default silently drops the overflow
RCVBUF_BYTES = 4 * 1024 * 1024


def _dropped(radio: str, what: str, e: Exception) -> None:
    """Report a batch or chunk a radio loop gave up on, and carry on."""
    print(f"{radio}: dropped {what} ({type(e).__name__}: {e})")
    traceback.print_exc()


class UdpSource:
    """UDP server socket -> payload queue (socket_pdu equivalent). The
    queue is unbounded, so ``dropped`` stays 0."""

    dropped = 0

    def __init__(self, host: str = "0.0.0.0", port: int = 52001, mtu: int = 10000):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.q: "queue.Queue[tuple[int, bytes]]" = queue.Queue()   # (receive ns, datagram)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.mtu = mtu

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(self.mtu)
                self.q.put((time.monotonic_ns(), data))
            except socket.timeout:
                continue
            except OSError:
                break

    def drain(self, max_items: int, timeout: float = 0.05,
              stamps: np.ndarray | None = None) -> list[bytes]:
        """Collect up to max_items pending datagrams (micro-batching). With
        ``stamps`` (an int64 array of at least max_items), each datagram's
        receive time (``time.monotonic_ns()`` at ``recvfrom``) goes into its
        first entries."""
        out = []
        deadline = time.monotonic() + timeout
        while len(out) < max_items:
            try:
                remaining = max(deadline - time.monotonic(), 0)
                t, data = self.q.get(timeout=remaining if not out else 0.0)
            except queue.Empty:
                break
            if stamps is not None:
                stamps[len(out)] = t
            out.append(data)
        return out

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():             # join() before start() raises
            self._thread.join(timeout=1.0)
        self.sock.close()


class UdpSink:
    """MAC payload -> strip 4-byte prefix -> UDP sendto (Extract Pics)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10010):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send_mac_payload(self, payload: bytes):
        """payload = MPDU body after the 24-byte header; the sender's
        4-byte length prefix is dropped (IRS_AP_epy_block_2.py:34-38)."""
        self.sock.sendto(payload[4:], self.addr)

    def close(self):
        self.sock.close()


def _fallback(what: str, reason: str) -> None:
    warnings.warn(f"{what}: the native one is unavailable, the Python one runs ({reason})",
                  RuntimeWarning, stacklevel=3)


def make_udp_source(host: str = "0.0.0.0", port: int = 52001, mtu: int = 10000):
    """socket_pdu source factory: the native C++ receive thread when the
    toolchain is available, the Python thread otherwise, with a
    RuntimeWarning that says why. Both expose start()/drain()/dropped/
    stop()/.port."""
    if not native.available():
        _fallback("UDP source", "no native library: g++ is missing or its build failed")
    else:
        try:
            return native.NativeUdpSource(host, port, mtu)
        except OSError as e:
            _fallback("UDP source", f"OSError: {e}")
    return UdpSource(host, port, mtu)


class NativeExtractSink:
    """UdpSink (Extract Pics) over the native UDP sender."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10010):
        self._sink = native.NativeUdpSink(host, port)

    def send_mac_payload(self, payload: bytes):
        self._sink.send(payload[4:])

    def close(self):
        self._sink.close()


def make_udp_sink(host: str = "127.0.0.1", port: int = 10010):
    """Extract-Pics sink factory (native when available; otherwise the
    Python socket, with a RuntimeWarning that says why)."""
    if not native.available():
        _fallback("UDP sink", "no native library: g++ is missing or its build failed")
    else:
        try:
            return NativeExtractSink(host, port)
        except OSError as e:
            _fallback("UDP sink", f"OSError: {e}")
    return UdpSink(host, port)


def _mpdus(mac: macmod.Mac, group: list[bytes]) -> np.ndarray:
    """Equal-length payloads -> (B, L + 28) uint8 MPDUs, framed in order."""
    return np.stack([np.frombuffer(mac.frame(p), dtype=np.uint8) for p in group])


def _staged(dev: torch.device, mpdus: np.ndarray, seeds, *scalars: float) -> tuple:
    """(B, M) uint8 MPDUs, B int64 scrambler seeds and float32 scalars on
    ``dev`` through one copy from pinned memory, non-blocking (a pinned
    block is not reused before its copy completes). Returns (mpdus, seeds,
    *scalars as 0-d tensors)."""
    b, m = mpdus.shape
    o_m = 8 * b + 4 * len(scalars)
    host = torch.empty(o_m + b * m, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    h = host.numpy()
    h[: 8 * b].view(np.int64)[:] = seeds
    h[8 * b: o_m].view(np.float32)[:] = scalars
    h[o_m:].reshape(b, m)[:] = mpdus
    buf = host.to(dev, non_blocking=True)
    sc = buf[8 * b: o_m].view(torch.float32)
    return (buf[o_m:].view(b, m), buf[: 8 * b].view(torch.int64),
            *(sc[i] for i in range(len(scalars))))


PSD_HEAD = 1 << 13      # channel samples a probed group hands the spectrum probe


def loopback_group(mpdus: torch.Tensor, seeds: torch.Tensor, snr_db: torch.Tensor,
                   foff: torch.Tensor, *, plan: tx.TxPlan, cfg: PhyConfig, algo,
                   probes: bool, generator: torch.Generator) -> torch.Tensor:
    """One LoopbackRadio group on the device, the JAX radio's ``radio_fn``
    (its runtime/bridge.py:273-292): TX, ``pad_burst(100, 400, 0.6)``, the
    channel (noise voltage 1, ``snr_db``, ``foff`` cycles/sample; noise
    from ``generator``) and the receive with 2 B candidate slots. Inputs on
    one device: mpdus (B, M) uint8, seeds (B,) int64, snr_db and foff 0-d
    float32. It reads nothing back and uploads nothing: on a card it is a
    CUDA graph. Returns one uint8 tensor, which ``group_fields`` takes
    apart."""
    b = mpdus.shape[0]
    stream = tx.pad_burst(tx.transmit_traced(mpdus, plan, seeds), 100, 400, scale=0.6)
    y = chmodel.channel_model(generator, stream.reshape(-1),
                              noise_voltage=device_table(np.float32, 1.0, device=mpdus.device),
                              frequency_offset=foff, snr_db=snr_db)
    res, cand = sync.receive_on_device(y, plan, 2 * b, cfg, algo)
    parts = [res.psdu.to(torch.uint8).reshape(-1),
             (cand.valid & res.sig["parity_ok"]).to(torch.uint8)]
    if probes:
        parts[:0] = [torch.view_as_real(v).reshape(-1).view(torch.uint8)
                     for v in (res.eq_symbols, y[:PSD_HEAD])]
    return torch.cat(parts)


def group_fields(packed: np.ndarray, plan: tx.TxPlan, b: int, probes: bool) -> tuple:
    """A fetched ``loopback_group`` output -> (psdu (2B, M) uint8, ok (2B,)
    bool: SIGNAL parity on a valid candidate, equalized symbols (2B, n_sym,
    48) complex64 and the channel's first PSD_HEAD samples, or None and None
    without probes)."""
    k, m = 2 * b, plan.psdu_len
    off = packed.size - k * m - k                   # psdu and ok close the buffer
    eq = head = None
    if probes:
        n_eq = k * plan.n_sym * 48 * 8
        eq = packed[:n_eq].view(np.complex64).reshape(k, plan.n_sym, 48)
        head = packed[n_eq: off].view(np.complex64)
    return (packed[off: off + k * m].reshape(k, m), packed[off + k * m:].astype(bool),
            eq, head)


def tx_bursts(mpdus: torch.Tensor, seeds: torch.Tensor, *, plan: tx.TxPlan,
              scale: float) -> torch.Tensor:
    """One TxRadio group on the device: TX and ``pad_burst(100, 1000,
    scale)``, flattened to one complex64 sample stream (the JAX TxRadio's
    ``transmit`` + ``pad_burst``). On a card it is a CUDA graph."""
    return tx.pad_burst(tx.transmit_traced(mpdus, plan, seeds), 100, 1000,
                        scale=scale).reshape(-1)


def _by_length(payloads: list[bytes]) -> list[list[bytes]]:
    """Payloads grouped by length, groups in order of first appearance."""
    by_len: dict[int, list[bytes]] = {}
    for p in payloads:
        by_len.setdefault(len(p), []).append(p)
    return list(by_len.values())


class LoopbackRadio:
    """Software transceiver: UDP in -> 802.11a PHY loopback -> UDP out.

    Equivalent to running IRS_tranceiver.grc: the de-facto integration
    harness, with SNR/CFO knobs matching its GUI sliders (snr 20-30 dB,
    epsilon +-20e-6; IRS_tranceiver.py:98,121).

    A batch of up to ``batch`` datagrams is grouped by payload length, and
    each group goes through TX, the channel and RX as one frame batch of
    its own size. The JAX package pads each group up to ``batch`` with
    copies of its last payload, which bounds its jit compiles; eager torch
    compiles nothing, so the port sends no copies, and ``stats["frames_ok"]``
    counts each decoded frame once (the JAX package's also counts the
    copies).

    The noise of a group comes from the radio's ``torch.Generator`` on its
    device, seeded from the radio's numpy ``default_rng(seed)``, one draw a
    group, as the JAX package seeds its PRNG key. On a card a group is one
    CUDA graph replay (``self.graphs``, one graph a key (MCS, MPDU length,
    group size, equalizer, probes), at most ``batch`` group sizes a length;
    the generator registered with each graph); its first group of a key
    captures the graph, on the radio's thread.

    ``tracer`` (a ``Tracer(prefix="radio")``) times each group's stages,
    which together cover the batch: ``frame`` (MAC framing), ``upload``
    (the group's inputs on the device), ``replay`` (the graph, or the eager
    call), ``fetch`` (the host's wait on the group's device work) and
    ``parse`` (fields, FCS, probes, and each payload's send as soon as it
    is parsed); while a profiler records on the radio's thread each is a
    ``radio.<stage>`` range, inside a ``radio.batch`` range around the
    whole ``_process`` call (a call a batch, frames its datagrams). ``send``
    is the sends' own time inside ``parse``. It counts ``group`` (a call a
    group, frames its size), ``queue`` (each datagram's wait from its
    receive to its batch's start, summed into seconds) and ``dropped``
    (datagrams the source discarded, in frames).
    """

    def __init__(
        self,
        in_port: int = 52001,
        out_host: str = "127.0.0.1",
        out_port: int = 10010,
        mcs: int = 3,                    # loopback default QPSK 3/4 (IRS_tranceiver.py:91)
        snr_db: float = 22.0,
        epsilon: float = 0.0,
        phy_cfg: PhyConfig = PhyConfig(),
        batch: int = 8,
        seed: int = 0,
        probes: bool = False,
        device="cuda",
    ):
        self.device = resolve(device)
        self.tracer = tracing.Tracer(prefix="radio")
        self.source = make_udp_source(port=in_port)
        self.sink = make_udp_sink(out_host, out_port)
        self.mcs = mcs
        self.snr_db = snr_db
        self.epsilon = epsilon
        self.chan_est = ChannelEstimator(phy_cfg.chan_est)
        self.cfg = phy_cfg
        self.batch = batch
        self.mac = macmod.Mac()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device)
        self.graphs = GraphCache()
        self.stats = {"datagrams_in": 0, "frames_ok": 0, "frames_crc_fail": 0}
        # headless GUI-sink analogues (constellation / spectrum / SNR),
        # populated when probes=True
        self.probes = probes
        self.constellation = tracing.ConstellationProbe()
        self.spectrum = tracing.SpectrumProbe()
        self.snr_probe = tracing.SnrProbe(alpha=0.05)

    @property
    def in_port(self) -> int:
        return self.source.port

    # -- live reconfiguration (the GUI-variable setters of the reference
    #    top blocks: set_encoding IRS_user.py:221-273, snr/epsilon sliders
    #    IRS_tranceiver.py:370-375,429-434). Attribute stores are atomic;
    #    the radio thread reads mcs and chan_est once a batch, snr and
    #    epsilon once a group. ---------------------------------------------

    def set_encoding(self, mcs: int) -> None:
        """Live MCS change (reference wifi_phy_hier.set_encoding)."""
        self.mcs = int(mcs)

    set_mcs = set_encoding

    def set_snr(self, snr_db: float) -> None:
        self.snr_db = float(snr_db)

    def set_epsilon(self, epsilon: float) -> None:
        self.epsilon = float(epsilon)

    def set_chan_est(self, algo) -> None:
        """Live equalizer-algorithm change (IRS_AP.py:139-141)."""
        self.chan_est = ChannelEstimator(algo)

    def start(self):
        self.source.start()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():             # join() before start() raises
            self._thread.join(timeout=5.0)
        self.source.stop()
        self.sink.close()

    # -- the radio loop ----------------------------------------------------

    def _process(self, payloads: list[bytes]) -> None:
        """One batch of datagrams through MAC, PHY, channel and back."""
        # snapshot the live-tunable settings ONCE a batch, so a concurrent
        # set_encoding()/set_chan_est() never splits a batch between two
        # settings
        mcs_now = self.mcs
        algo_now = self.chan_est
        dev = self.device
        stage = self.tracer.stage
        # the host's time between two stages lies in a range too
        with stage("batch", frames=len(payloads)):
            for group in _by_length(payloads):
                b = len(group)
                self.tracer.count("group", frames=b)
                with stage("frame", frames=b):
                    mpdus = _mpdus(self.mac, group)
                    plan = tx.tx_plan(mcs_now, mpdus.shape[1])
                with stage("upload", frames=b):
                    probes = self.probes
                    self._gen.manual_seed(int(self._rng.integers(0, 2**31)))
                    foff = chmodel.epsilon_to_frequency_offset(self.epsilon, self.cfg.frequency)
                    inputs = _staged(dev, mpdus, np.arange(b) % 127 + 1, self.snr_db, foff)
                with stage("replay", frames=b):
                    fn = functools.partial(loopback_group, plan=plan, cfg=self.cfg, algo=algo_now,
                                           probes=probes, generator=self._gen)
                    if dev.type == "cuda":
                        key = (mcs_now, mpdus.shape[1], b, int(algo_now), probes)
                        packed = self.graphs(key, fn, inputs, generators=(self._gen,))
                    else:
                        packed = fn(*inputs)
                with stage("fetch", frames=b):          # the host waits on the group's device work
                    packed = packed.cpu().numpy()
                send_s, sent = 0.0, 0
                with stage("parse", frames=b):
                    psdu, ok, eq, head = group_fields(packed, plan, b, probes)
                    if head is not None:
                        self.spectrum.update(head)
                    for i in np.flatnonzero(ok):
                        frame = macmod.parse(psdu[i].tobytes())
                        if not frame.fcs_ok:
                            self.stats["frames_crc_fail"] += 1
                            continue
                        self.stats["frames_ok"] += 1
                        if eq is not None:
                            self.constellation.push(eq[i])
                            self.snr_probe.update(eq[i])
                        t = time.perf_counter()
                        self.sink.send_mac_payload(frame.payload)
                        send_s += time.perf_counter() - t
                        sent += 1
                self.tracer.add("send", send_s, frames=sent)     # inside `parse`

    def _run(self):
        stamps = np.empty(self.batch, dtype=np.int64)    # the datagrams' receive times, ns
        dropped = self.source.dropped
        while not self._stop.is_set():
            payloads = self.source.drain(self.batch, 0.1, stamps)
            if not payloads:
                continue
            n = len(payloads)
            self.stats["datagrams_in"] += n
            t = time.monotonic_ns()
            # each datagram's wait from its receive to its batch's start
            self.tracer.add("queue", seconds=float(np.sum(t - stamps[:n])) / 1e9, frames=n)
            now = self.source.dropped
            self.tracer.count("dropped", frames=now - dropped, calls=0)
            dropped = now
            try:
                self._process(payloads)
            except Exception as e:  # keep the radio alive on bad input
                _dropped("LoopbackRadio", "batch", e)


# ---------------------------------------------------------------------------
# Split TX / RX radios (the IRS_user / IRS_AP two-node topology)
# ---------------------------------------------------------------------------

_SAMP_CHUNK = 4096      # samples per UDP sample datagram (16 KiB of sc16)


class TxRadio:
    """The IRS_user node: UDP payloads -> MAC -> 802.11a TX -> sc16 I/Q
    sample datagrams (the role of the SoapySDR HackRF sink,
    IRS_user.py:161-173, with UDP standing in for RF).

    Samples leave as raw interleaved int16 I/Q (UHD's native over-the-wire
    format) in _SAMP_CHUNK-sample datagrams. A batch is grouped by payload
    length and each group is sent as it is, with scrambler seeds 1..B (the
    JAX package pads a group up to ``batch`` with copies for its jit
    cache; the port sends no copies). On a card a group is one CUDA graph
    replay (``tx_bursts`` through ``self.graphs``, one graph a key (MCS,
    MPDU length, group size, scale)).
    """

    def __init__(self, in_port: int = 52001, samp_host: str = "127.0.0.1",
                 samp_port: int = 52100, mcs: int = 2, scale: float = 0.5,
                 batch: int = 4, phy_cfg: PhyConfig = PhyConfig(), device="cuda"):
        self.device = resolve(device)
        self.source = make_udp_source(port=in_port)
        self.samp_addr = (samp_host, samp_port)
        self.samp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.mcs = mcs
        self.scale = scale
        self.batch = batch
        self.cfg = phy_cfg
        self.mac = macmod.Mac()
        self.graphs = GraphCache()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.stats = {"datagrams_in": 0, "frames_tx": 0, "samples_tx": 0}

    @property
    def in_port(self) -> int:
        return self.source.port

    def start(self):
        self.source.start()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():     # join() before start() raises
            self._thread.join(timeout=5.0)
        self.source.stop()
        self.samp_sock.close()

    def _emit(self, samples: np.ndarray):
        sc16 = quantize_sc16(to_riq(samples))              # (N, 2) int16
        for lo in range(0, sc16.shape[0], _SAMP_CHUNK):
            self.samp_sock.sendto(sc16[lo: lo + _SAMP_CHUNK].tobytes(), self.samp_addr)
        self.stats["samples_tx"] += int(sc16.shape[0])

    def _process(self, payloads: list[bytes]) -> None:
        dev = self.device
        for group in _by_length(payloads):
            mpdus = _mpdus(self.mac, group)
            b = len(group)
            plan = tx.tx_plan(self.mcs, mpdus.shape[1])
            inputs = _staged(dev, mpdus, np.arange(1, b + 1))
            fn = functools.partial(tx_bursts, plan=plan, scale=self.scale)
            if dev.type == "cuda":
                stream = self.graphs((plan.mcs, plan.psdu_len, b, self.scale), fn, inputs)
            else:
                stream = fn(*inputs)
            self._emit(stream.cpu().numpy())
            self.stats["frames_tx"] += len(group)

    def _run(self):
        while not self._stop.is_set():
            payloads = self.source.drain(self.batch, timeout=0.1)
            if not payloads:
                continue
            self.stats["datagrams_in"] += len(payloads)
            try:
                self._process(payloads)
            except Exception as e:
                _dropped("TxRadio", "batch", e)


class RxRadio:
    """The IRS_AP node: sc16 I/Q sample datagrams -> SIGNAL-steered
    streaming RX (AdaptiveStreamExecutor) -> MAC parse/FCS -> Extract-Pics
    UDP out (IRS_AP.py:163-316 with UDP standing in for the USRP source).

    Samples accumulate into a buffer; a processing pass runs when it holds
    ``chunk`` samples, or after 0.3 s without a datagram. Each pass keeps a
    worst-case-frame tail as overlap and dedups frames across passes by
    their absolute sample index (within 2 samples).

    A frame whose burst may run past the end of a chunk pass's buffer is
    left for the next pass, which holds it whole (the tail is the longest
    window); when a pass left one, the idle flush runs even on a buffer of
    just the tail. The idle flush leaves nothing: it decodes a cut burst
    from the zero padding, as every JAX pass does. The JAX package thus
    counts an FCS failure for a frame cut by a chunk pass and marks its
    index seen, so the whole frame is skipped as a duplicate in the next
    pass and lost.
    """

    def __init__(self, samp_port: int = 52100, out_host: str = "127.0.0.1",
                 out_port: int = 10010, chunk: int = 1 << 17,
                 exec_cfg: ExecutorConfig | None = None, phy_cfg: PhyConfig = PhyConfig(),
                 algo=None, probes: bool = True, device="cuda"):
        if exec_cfg is None:
            exec_cfg = ExecutorConfig(block_size=1 << 15, time_shards=4,
                                      max_frames_per_block=16)
        self.ex = AdaptiveStreamExecutor(mesh=None, exec_cfg=exec_cfg, phy_cfg=phy_cfg,
                                         algo=algo, capture_symbols=probes, device=device)
        self.samp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # sample datagrams arrive at wire rate: deep kernel buffer so a
        # processing pass doesn't drop the next chunk burst
        self.samp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
        self.samp_sock.bind(("0.0.0.0", samp_port))
        self.samp_sock.settimeout(0.1)
        self.samp_port = self.samp_sock.getsockname()[1]
        self.sink = make_udp_sink(out_host, out_port)
        self.chunk = chunk
        # headless GUI-sink analogues (IRS_AP's constellation / freq sinks
        # + probe_mpsk_snr_est_c): equalized symbols, PSD, running SNR
        self.probes = probes
        self.constellation = tracing.ConstellationProbe()
        self.spectrum = tracing.SpectrumProbe()
        self.snr_probe = tracing.SnrProbe(alpha=0.05)
        # overlap tail: the worst-case frame span at the slowest rate
        self.tail = sync.window_len(params.n_symbols(0, phy_cfg.max_psdu_bytes))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.stats = {"samples_in": 0, "frames_ok": 0, "frames_crc_fail": 0}

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():     # join() before start() raises
            self._thread.join(timeout=10.0)
        self.samp_sock.close()
        self.sink.close()

    def _run(self):
        buf = np.zeros(0, np.complex64)
        base = 0                       # absolute index of buf[0]
        seen: set[int] = set()
        last_rx = time.monotonic()
        deferred = False               # the last pass left a cut frame
        while not self._stop.is_set():
            try:
                data, _ = self.samp_sock.recvfrom(65536)
                sc16 = np.frombuffer(data, np.int16).reshape(-1, 2)
                samples = ((sc16[:, 0] + 1j * sc16[:, 1])
                           * (SC16_FULL_SCALE / 32767.0)).astype(np.complex64)
                buf = np.concatenate([buf, samples])
                self.stats["samples_in"] += samples.size
                last_rx = time.monotonic()
            except socket.timeout:
                pass
            except OSError:
                break
            idle = time.monotonic() - last_rx > 0.3
            full = buf.size >= self.chunk
            if full or (idle and (buf.size > self.tail or deferred)):
                deferred = False
                try:
                    deferred = self._process(buf, base, seen, final=not full)
                except Exception as e:
                    _dropped("RxRadio", "chunk", e)
                keep = min(self.tail, buf.size)
                base += buf.size - keep
                buf = buf[-keep:].copy()
                seen = {g for g in seen if g >= base}
                last_rx = time.monotonic()

    def _process(self, buf: np.ndarray, base: int, seen: set[int],
                 final: bool = False) -> bool:
        """One pass over buf (absolute index of buf[0] is base): decode,
        dedup against seen (updated), parse and forward. Unless ``final``,
        a frame whose burst may run past buf's end is left for the next
        pass; returns whether one was."""
        if self.probes:
            self.spectrum.update(buf[: 1 << 14])
        deferred = False
        for rec in self.ex.run(buf):
            if not rec.parity_ok:
                continue
            # the sync edge lies inside the STF: the burst ends by this
            n_sym = params.n_symbols(rec.rate_idx, rec.length)
            burst_end = rec.global_start + params.PREAMBLE_LEN + (1 + n_sym) * params.N_SYM
            if not final and burst_end > buf.size:
                deferred = True         # cut by the buffer's end: next pass
                continue
            if self.probes and rec.eq_symbols is not None:
                self.constellation.push(rec.eq_symbols)
                self.snr_probe.update(rec.eq_symbols)
            gidx = base + rec.global_start
            if gidx in seen or any(abs(gidx - s) <= 2 for s in seen):
                continue
            seen.add(gidx)
            frame = macmod.parse(rec.psdu.tobytes())
            if not frame.fcs_ok:
                self.stats["frames_crc_fail"] += 1
                continue
            self.stats["frames_ok"] += 1
            self.sink.send_mac_payload(frame.payload)
        return deferred
