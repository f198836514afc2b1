"""The functions that the local executors capture as CUDA graphs
(parallel/graphs.py), on the CPU, where they run eagerly:

  (a) stage-B buckets of 1, 3, 5 and 17 candidates, padded to 64 rows
      (the smallest of the executor's ROW_SIZES; the JAX package pads to
      a power of two, with the same padded rows), give the FrameRecords of
      JAX's AdaptiveStreamExecutor on the same numpy stream, and no padded
      row reaches a record (local, resident mode);
  (b) the fixed step (and the adaptive stage A) fed through its span, as
      its graph's static input is, at every super-block offset of the
      stream, the last included, equals JAX's jitted step at that offset;
  (c) the captured functions read nothing back to the host (no
      ``_local_scalar_dense``, ``nonzero`` or ``masked_select``) and their
      second call makes no tensor from numpy;
  (d) the phy tables cached per device equal the numpy tables and are the
      same objects on a second call;
and the launch accounting of a capture and its replays (``ops.build``,
``utils.tracing.replayed``).

Records: channel, global_start, rate_idx, length, parity_ok and psdu
exactly; cfo within 1e-5 rad/sample and snr_db within 1e-3 dB (float32
arithmetic of two libraries). Step outputs of the valid slots likewise.

The tests marked ``cuda`` need a card and skip here: a replay equals the
eager function bit for bit, the launch counters advance once a replay,
and a capture succeeds while another thread allocates. JAX is imported
inside the tests that compare with it, so that on the card, where JAX is
not installed, ``python -m pytest --noconftest -m cuda
tests/test_torch_graphs.py`` collects this file.
"""

import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, ExecutorConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveStreamExecutor,
    StreamExecutor,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor as pexec
from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits, mac, mapping, ofdm, params, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import device_table, param_table

torch.set_num_threads(2)

MCS, L = 4, 40            # 4 data symbols: an 800-sample burst
BLOCK, SHARDS = 8192, 4   # one 32 768-sample super-block holds every bucket


def _jax():
    import jax.numpy as jnp

    from gnuradio_wifi_imagetransfer_tpu import config as jconfig
    from gnuradio_wifi_imagetransfer_tpu.parallel import executor as jexec
    from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx

    return jnp, jconfig, jexec, jtx


def _place(n, frames, positions, mcs, seed, snr_db=30.0):
    """Frames (F, L) of one MCS at the given positions (the JAX package's
    TX), with noise at snr_db below the 0.5 burst amplitude."""
    jnp, _, _, jtx = _jax()
    rng = np.random.default_rng(seed)
    bursts = np.asarray(jtx.transmit(jnp.asarray(frames), mcs,
                                     scrambler_seed=jnp.arange(1, len(frames) + 1)))
    x = np.zeros(n, np.complex64)
    for pos, b in zip(positions, bursts):
        x[pos: pos + b.size] += 0.5 * b
    noise = 0.5 * 10 ** (-snr_db / 20) / np.sqrt(2)
    return (x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok) == (
            w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
        assert np.array_equal(g.psdu, w.psdu)
        assert abs(g.cfo - w.cfo) <= 1e-5
        assert abs(g.snr_db - w.snr_db) <= 1e-3


# -- (a) padded stage-B buckets --------------------------------------------


@pytest.mark.parametrize("b,b_pad", [(1, 64), (3, 64), (5, 64), (17, 64)])
def test_padded_buckets_match_jax(monkeypatch, b, b_pad):
    _, jconfig, jexec, _ = _jax()
    frames = np.random.default_rng(b).integers(0, 256, (b, L), dtype=np.uint8)
    x = _place(BLOCK * SHARDS, frames, [500 + 1000 * i for i in range(b)], MCS, seed=b)
    kw = dict(block_size=BLOCK, time_shards=SHARDS, max_frames_per_block=10)
    seen = []
    decode, finish = (AdaptiveStreamExecutor.bucket_decode,
                      AdaptiveStreamExecutor._finish_bucket)

    def spy_decode(self, plan, windows, scalars):
        seen.append((windows.shape[0], scalars.clone(), windows.clone(),
                     self._dev_stream[0, :windows.shape[1]].clone()))
        return decode(self, plan, windows, scalars)

    def spy_finish(self, bucket, plan, packed):
        assert packed.shape[0] == len(bucket)         # the padded rows dropped
        return finish(self, bucket, plan, packed)

    monkeypatch.setattr(AdaptiveStreamExecutor, "bucket_decode", spy_decode)
    monkeypatch.setattr(AdaptiveStreamExecutor, "_finish_bucket", spy_finish)
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw), device="cpu")
    got = ex.run(x)
    want = jexec.AdaptiveStreamExecutor(mesh=None,
                                        exec_cfg=jconfig.ExecutorConfig(**kw)).run(x)
    _same_records(got, want)
    assert sorted(tuple(r.psdu) for r in got if r.parity_ok) == sorted(map(tuple, frames))
    assert len(got) == b and len(ex.graphs) == 0          # the CPU runs eagerly
    (rows, scalars, windows, origin0), = seen
    assert rows == b_pad
    # padded rows: channel 0 at origin 0, CFO 0, frame start 0
    assert torch.count_nonzero(scalars[b:]) == 0
    assert all(torch.equal(w, origin0) for w in windows[b:])


# -- (b) the fixed step and stage A through their span -----------------------


def _step_stream(channels=2, n_blocks=4, seed=3):
    """Per channel: MCS-2 frames of 50 bytes across the block seams, the
    super-block seam (2 blocks a step) and near the stream's end."""
    rng = np.random.default_rng(seed)
    n = n_blocks * BLOCK
    rows = []
    for c in range(channels):
        pos = [300 + 150 * c, BLOCK - 400, n // 2 - 300, n - 2 * BLOCK // 3, n - 1500]
        frames = rng.integers(0, 256, (len(pos), 50), dtype=np.uint8)
        rows.append(_place(n, frames, pos, 2, seed + c))
    return np.stack(rows)


def _jax_step_outputs(jex, offset):
    out = np.asarray(jex._step(jex._dev_stream, np.int32(offset)))
    if hasattr(jex, "_unpack_a"):
        return jex._unpack_a(out)
    return jex._unpack(out)


@pytest.mark.parametrize("kind", ["fixed", "stage_a"])
def test_step_through_its_span_matches_jax(kind):
    _, jconfig, jexec, jtx = _jax()
    stream = _step_stream()
    kw = dict(block_size=BLOCK, time_shards=2, channels=2, max_frames_per_block=4,
              wire_format="sc16")
    if kind == "fixed":
        ex = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(**kw), device="cpu")
        jex = jexec.StreamExecutor(jtx.tx_plan(2, 50), mesh=None,
                                   exec_cfg=jconfig.ExecutorConfig(**kw))
        names = ["psdu", "valid", "starts", "cfo", "rate_idx", "length", "parity_ok", "snr_db"]
    else:
        ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw), device="cpu")
        jex = jexec.AdaptiveStreamExecutor(mesh=None, exec_cfg=jconfig.ExecutorConfig(**kw))
        names = ["valid", "starts", "cfo", "frame_start", "rate_idx", "length", "sig_ok"]
    ex.stage_resident(stream)
    jex._stage_resident(stream)
    offsets = list(range(0, ex.effective_len(stream.shape[1]), 2 * BLOCK))
    assert len(offsets) == 2
    n_valid = 0
    for offset in offsets:            # the last super-block included
        span = ex.span(offset)
        assert span.shape == (2, pexec.HALO_LEFT + 2 * BLOCK + ex.halo_right, 2)
        got = ex.span_step(span)
        want = dict(zip(names, _jax_step_outputs(jex, offset)))
        valid = got.valid.numpy()
        assert np.array_equal(valid, want["valid"].astype(bool))
        n_valid += valid.sum()
        for name in names:
            g, w = getattr(got, name).numpy()[valid], np.asarray(want[name])[valid]
            if name in ("cfo", "snr_db"):
                np.testing.assert_allclose(g, w, atol=1e-5 if name == "cfo" else 1e-3, rtol=0)
            else:
                assert np.array_equal(g, w.astype(g.dtype)), name
        # the step's own entry point runs the same function on the CPU
        eager = ex.step(offset)
        assert all(torch.equal(getattr(eager, f), getattr(got, f)) for f in names)
    assert n_valid >= 2 * 5                 # every frame, once


# -- (c) no host reads, no numpy uploads on the second call ------------------


class _NoHostReads(TorchDispatchMode):
    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                 torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN or func.overloadpacket in {
                torch.ops.aten.nonzero, torch.ops.aten.masked_select}:
            raise AssertionError(f"host read in a captured function: {func}")
        return func(*args, **(kwargs or {}))


def _captured(kind):
    """(function, inputs) of one of the captured functions on the CPU."""
    stream = _step_stream(channels=1, n_blocks=2, seed=5)
    kw = dict(block_size=BLOCK, time_shards=2, max_frames_per_block=4)
    if kind == "fixed":
        ex = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(**kw), device="cpu")
        ex.stage_resident(stream)
        return ex.span_step, (ex.span(0),)
    algo = ChannelEstimator.LMS if kind == "stage_b_lms" else ChannelEstimator.LS
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw), algo=algo,
                                capture_symbols=True, device="cpu")
    ex.stage_resident(stream)
    if kind == "stage_a":
        return ex.span_step, (ex.span(0),)
    plan = tx.tx_plan(2, 50)
    cands = pexec._Candidates(channel=np.zeros(3, np.int64),
                              global_start=500 + 1000 * np.arange(3, dtype=np.int64),
                              cfo=np.zeros(3, np.float32), frame_start=np.full(3, 160),
                              rate_idx=np.full(3, 2), length=np.full(3, 50))
    windows, scalars = ex._bucket_inputs(stream, cands, sync.window_len(plan.n_sym))
    return (lambda w, s: ex.bucket_decode(plan, w, s)), (windows, scalars)


@pytest.mark.parametrize("kind", ["fixed", "stage_a", "stage_b_ls", "stage_b_lms"])
def test_captured_functions_read_nothing_back(monkeypatch, kind):
    fn, inputs = _captured(kind)
    first = fn(*inputs)                       # builds the cached tables
    uploads = []

    def counted(real):
        def f(*a, **k):
            uploads.append(real.__name__)
            return real(*a, **k)
        return f

    monkeypatch.setattr(torch, "as_tensor", counted(torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy", counted(torch.from_numpy))
    with _NoHostReads():
        second = fn(*inputs)
    monkeypatch.undo()
    assert uploads == []
    leaves = [second] if isinstance(second, torch.Tensor) else [
        getattr(second, f) for f in second.__dataclass_fields__]
    firsts = [first] if isinstance(first, torch.Tensor) else [
        getattr(first, f) for f in first.__dataclass_fields__]
    assert all(torch.equal(a, b) for a, b in zip(leaves, firsts))


def test_no_host_reads_mode_catches_a_host_read():
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostReads():
            int(torch.ones(2).sum())


# -- (d) the phy tables cached per device ------------------------------------


TABLES = [
    (getattr, (params, "USED_BINS"), torch.long),
    (getattr, (params, "LTF_USED"), None),
    (getattr, (params, "PILOT_PATTERN"), None),
    (getattr, (params, "POLARITY"), None),
    (getattr, (params, "MCS_RATE_BITS"), torch.long),
    (getattr, (params, "LTF_TIME"), None),
    (params.constellation, (6,), None),
    (bits.puncture_indices, ("3/4", 96), None),
    (bits._tiled_perm, (5, 3, True), None),
    (bits._windows, (), None),
    (mapping._point_bits, (4,), torch.float32),
    (ofdm.sync_time_symbols, (), None),
    (mac._crc32_table64, (), None),
    (k2._np_table, (0,), torch.long),
]


@pytest.mark.parametrize("make,args,dtype", TABLES, ids=[
    a[1] if m is getattr else f"{m.__name__}{a}" for m, a, _ in TABLES])
def test_device_tables_equal_numpy_and_are_cached(make, args, dtype):
    table = device_table(make, *args, device="cpu", dtype=dtype)
    want = torch.as_tensor(np.asarray(make(*args)))
    if dtype is not None:
        want = want.to(dtype)
    assert table.dtype == want.dtype and torch.equal(table, want)
    assert device_table(make, *args, device=torch.device("cpu"), dtype=dtype) is table
    if make is getattr:
        assert param_table(args[1], "cpu", dtype) is table


# -- launch accounting of a capture and its replays --------------------------


def test_capture_logs_launches_and_replays_count_and_record():
    llr = torch.randn(3, 24, 2)
    before = k2.viterbi_decode.launches
    log = []
    with tracing.recording((k2, "viterbi_decode")) as calls:
        with build.capture_log(log):
            assert build.capturing()
            k2.viterbi_decode(llr, True)             # a call inside a capture:
            build.count_launch(k2.viterbi_decode, (llr, True))   # ... its launch
        assert not build.capturing()
        assert calls["viterbi_decode"] == [] and k2.viterbi_decode.launches == before
        (wrapper, args), = log
        for _ in range(2):                           # two replays
            tracing.replayed(wrapper, args)
    assert k2.viterbi_decode.launches == before + 2
    assert len(calls["viterbi_decode"]) == 2
    for got_args, got_kw in calls["viterbi_decode"]:
        assert got_args[0] is not llr and torch.equal(got_args[0], llr)
        assert got_args[1] is True and got_kw == {}
    # outside a capture the count is the wrapper's own
    build.count_launch(k2.viterbi_decode, (llr, True))
    assert k2.viterbi_decode.launches == before + 3
    k2.viterbi_decode.launches = before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_stream(seed=5):
    """Frames made by the port's TX (no JAX on the card)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (6, 50), dtype=np.uint8)
    bursts = tx.transmit(frames, 2, device="cpu").numpy()
    x = np.zeros((1, 2 * 2 * BLOCK), np.complex64)
    for i, b in enumerate(bursts):
        pos = 500 + 5000 * i
        x[0, pos: pos + b.size] += 0.5 * b
    x += 0.005 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), frames


def _leaves(out):
    return [getattr(out, f) for f in out.__dataclass_fields__]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "stage_a"])
def test_step_replay_equals_eager_bit_for_bit(dev, kind):
    x, _ = _card_stream()
    kw = dict(block_size=BLOCK, time_shards=2, max_frames_per_block=4)
    ex = (StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(**kw), device=dev)
          if kind == "fixed" else AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw),
                                                         device=dev))
    ex.stage_resident(x)
    for offset in (0, 2 * BLOCK):
        eager = ex.span_step(ex.span(offset))
        first = ex.step(offset)              # the warm-up, then the capture
        replay = ex.step(offset)
        again = ex.step(offset)
        assert len(ex.graphs) == 1
        for e, f, r, a in zip(*map(_leaves, (eager, first, replay, again))):
            assert torch.equal(e, f) and torch.equal(e, r) and torch.equal(e, a)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", [ChannelEstimator.LS, ChannelEstimator.LMS])
def test_bucket_replay_equals_eager_and_counts_once(dev, algo):
    x, frames = _card_stream()
    kw = dict(block_size=BLOCK, time_shards=2, max_frames_per_block=4)
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw), algo=algo,
                                capture_symbols=True, device=dev)
    eager = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(**kw), algo=algo,
                                   capture_symbols=True, device="cpu").run(x)
    for run in range(3):
        before = {k: getattr(k2, k).launches for k in ("viterbi_decode", "viterbi_decode_many")}
        got = ex.run(x)
        steps = 2
        buckets = ex.tracer.report()["stage_b_slots"].calls
        ex.tracer.reset()
        assert k2.viterbi_decode.launches - before["viterbi_decode"] == steps
        assert k2.viterbi_decode_many.launches - before["viterbi_decode_many"] == buckets
        assert [(r.global_start, tuple(r.psdu)) for r in got] == [
            (r.global_start, tuple(r.psdu)) for r in eager]
        assert {tuple(r.psdu) for r in got if r.parity_ok} == set(map(tuple, frames))
    assert ex.graphs.captured == len(ex.graphs) >= 2


@pytest.mark.cuda
def test_replay_records_its_kernel_calls(dev):
    x, _ = _card_stream()
    ex = StreamExecutor(tx.tx_plan(2, 50), exec_cfg=ExecutorConfig(
        block_size=BLOCK, time_shards=2, max_frames_per_block=4), device=dev)
    ex.stage_resident(x)
    ex.step(0)
    with tracing.recording((k2, "viterbi_decode_many")) as calls:
        ex.step(0)
    (args, kw), = calls["viterbi_decode_many"]
    got, want = k2.viterbi_decode_many(*args, **kw), k2.viterbi_decode_many_plain(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_capture_while_another_thread_allocates(dev):
    x, _ = _card_stream()
    ex = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(
        block_size=BLOCK, time_shards=2, max_frames_per_block=4), device=dev)
    want = AdaptiveStreamExecutor(exec_cfg=ExecutorConfig(
        block_size=BLOCK, time_shards=2, max_frames_per_block=4), device="cpu").run(x)
    stop = threading.Event()

    def churn():
        """Allocations of new sizes (new device memory), kernels, draws
        from a generator of its own and fetches to the host on the default
        stream, until the run ends."""
        gen = torch.Generator(device=dev).manual_seed(0)
        n = 1 << 16
        while not stop.is_set():
            t = torch.empty(n, device=dev).normal_(generator=gen)
            (t * 2).sum().cpu()
            n = n * 2 if n < 1 << 24 else 1 << 16

    failed = []

    def worker_main():
        try:
            churn()
        except Exception as e:        # a failure in the thread fails the test
            failed.append(e)

    worker = threading.Thread(target=worker_main)
    worker.start()
    try:
        got = ex.run(x)
    finally:
        stop.set()
        worker.join()
    assert not failed
    assert ex.graphs.captured >= 2
    assert [(r.global_start, tuple(r.psdu)) for r in got] == [
        (r.global_start, tuple(r.psdu)) for r in want]
