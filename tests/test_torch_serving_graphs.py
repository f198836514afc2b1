"""The serving programs that the radios and the codec capture as CUDA
graphs (parallel/graphs.py), on the CPU, where they run eagerly:

  (a) the loopback radio's group (``bridge.loopback_group``), fed as the
      radio feeds it (its inputs from ``bridge._staged``, a seeded
      generator): its psdu and ok (a valid candidate with SIGNAL parity)
      equal JAX's ``sync.receive`` run on the port's own channel output,
      exactly, at MCS 0, 3 and 7, LS and STA, groups of 1, 3 and 8;
  (b) the TX radio's group (``bridge.tx_bursts``) equals JAX's
      ``transmit_traced`` + ``pad_burst`` within 2e-6 (float32 IFFTs of
      two libraries, as tests/test_torch_port.py holds ``transmit``);
  (c) the codec's encode and decode, through their graph inputs, equal
      JAX's ``_enc_apply`` and ``_dec_apply``: the latent within 1e-5, the
      reconstruction within 1 LSB (tests/test_torch_mode1.py's tolerances);
  (d) each of these functions reads nothing back to the host and, on its
      second call, makes no tensor from numpy or from Python numbers;
and the radios and the codec run CPU tensors eagerly, without a graph.

The tests marked ``cuda`` need a card and skip here: a replay equals the
eager call bit for bit (probes on and off, the TX, the codec); a replay
after ``manual_seed(s)`` draws what a fresh generator seeded ``s`` draws;
the codec captures while a radio replays in another thread. JAX is
imported inside the tests that compare with it, so that on the card,
where JAX is not installed, ``python -m pytest --noconftest -m cuda
tests/test_torch_serving_graphs.py`` collects this file.
"""

import functools
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator, PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.graphs import GraphCache
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.runtime import bridge

torch.set_num_threads(2)

L = 40                          # payload bytes: MPDUs of 68
SNR_DB, EPSILON = 30.0, 2e-6
IMG_HW, C = 48, 16              # the codec at a (6, 6, 16) latent
USERS = ["3-4", "13-10"]


def _mpdus(b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = mac.Mac()
    return np.stack([np.frombuffer(m.frame(bytes(rng.integers(0, 256, L, dtype=np.uint8))),
                                   np.uint8) for _ in range(b)])


def _group_inputs(b: int, seed: int, dev="cpu"):
    """A group's inputs as LoopbackRadio._process makes them."""
    foff = bridge.chmodel.epsilon_to_frequency_offset(EPSILON, PhyConfig().frequency)
    return bridge._staged(torch.device(dev), _mpdus(b, seed), np.arange(b) % 127 + 1,
                          SNR_DB, foff)


def _group_fn(mcs, algo, probes, gen):
    return functools.partial(bridge.loopback_group, plan=tx.tx_plan(mcs, L + 28),
                             cfg=PhyConfig(), algo=ChannelEstimator(algo), probes=probes,
                             generator=gen)


# -- (a) the loopback group against JAX's receive ---------------------------


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("algo", [ChannelEstimator.LS, ChannelEstimator.STA])
@pytest.mark.parametrize("mcs", [0, 3, 7])
def test_loopback_group_matches_jax_receive(monkeypatch, mcs, algo, b):
    import jax
    import jax.numpy as jnp

    from gnuradio_wifi_imagetransfer_tpu import config as jconfig
    from gnuradio_wifi_imagetransfer_tpu.phy import sync as jsync
    from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx

    seen = []
    receive = sync.receive_on_device

    def spy(y, *a, **k):
        seen.append(y.clone())
        return receive(y, *a, **k)

    monkeypatch.setattr(sync, "receive_on_device", spy)
    gen = torch.Generator().manual_seed(1000 * mcs + b)
    inputs = _group_inputs(b, seed=mcs + b)
    plan = tx.tx_plan(mcs, L + 28)
    psdu, ok, _, _ = bridge.group_fields(_group_fn(mcs, algo, False, gen)(*inputs).numpy(),
                                         plan, b, False)
    (y,), jplan = seen, jtx.tx_plan(mcs, L + 28)

    def jreceive(v):
        res, cand = jsync.receive(v, jplan, max_frames=2 * b, cfg=jconfig.PhyConfig(),
                                  algo=jconfig.ChannelEstimator(int(algo)))
        return res.psdu, cand.valid & res.sig["parity_ok"]

    want_psdu, want_ok = map(np.asarray, jax.jit(jreceive)(jnp.asarray(y.numpy())))
    assert np.array_equal(ok, want_ok)
    assert np.array_equal(psdu[ok], want_psdu[ok])
    # every frame of the group decoded, its FCS good
    frames = {bytes(r) for r in psdu[ok] if mac.parse(bytes(r)).fcs_ok}
    assert frames == {bytes(r) for r in inputs[0].numpy()}


def test_loopback_group_packs_the_probes():
    """With probes the group also hands back the equalized symbols and the
    channel's first samples; psdu and ok are those of the unprobed group
    on the same draws."""
    b, mcs = 3, 3
    plan = tx.tx_plan(mcs, L + 28)
    inputs = _group_inputs(b, seed=4)
    got = {}
    for probes in (False, True):
        gen = torch.Generator().manual_seed(9)
        got[probes] = bridge.group_fields(
            _group_fn(mcs, ChannelEstimator.LS, probes, gen)(*inputs).numpy(), plan, b, probes)
    psdu, ok, eq, head = got[True]
    assert np.array_equal(psdu, got[False][0]) and np.array_equal(ok, got[False][1])
    assert got[False][2] is None and got[False][3] is None
    assert eq.shape == (2 * b, plan.n_sym, 48) and eq.dtype == np.complex64
    n_stream = b * (plan.n_samples + 500)
    assert head.shape == (min(bridge.PSD_HEAD, n_stream),) and np.isfinite(head).all()
    # the constellation of a decoded frame sits near QPSK's points
    assert np.abs(np.abs(eq[np.flatnonzero(ok)[0]]) - 1).mean() < 0.2


def test_staged_inputs_carry_the_values():
    mpdus = _mpdus(3, seed=2)
    got = bridge._staged(torch.device("cpu"), mpdus, np.array([1, 64, 127]), 22.0, 1e-3)
    assert np.array_equal(got[0].numpy(), mpdus) and got[0].dtype == torch.uint8
    assert got[1].tolist() == [1, 64, 127] and got[1].dtype == torch.int64
    assert got[2].shape == () and got[2].item() == np.float32(22.0)
    assert got[3].dtype == torch.float32 and got[3].item() == np.float32(1e-3)


# -- (b) the TX radio's group against JAX -----------------------------------


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("mcs", [0, 2, 5, 7])
def test_tx_bursts_match_jax(mcs, b):
    import jax.numpy as jnp

    from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx

    mpdus = _mpdus(b, seed=mcs)
    mp, seeds = bridge._staged(torch.device("cpu"), mpdus, np.arange(1, b + 1))
    got = bridge.tx_bursts(mp, seeds, plan=tx.tx_plan(mcs, mpdus.shape[1]), scale=0.5)
    jplan = jtx.tx_plan(mcs, mpdus.shape[1])
    want = np.asarray(jtx.pad_burst(jtx.transmit_traced(
        jnp.asarray(mpdus), jplan, scrambler_seed=jnp.arange(1, b + 1)), 100, 1000,
        scale=0.5).reshape(-1))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_transmit_traced_defaults_to_the_mapper_seeds():
    frames = torch.from_numpy(_mpdus(3, seed=1))
    plan = tx.tx_plan(4, frames.shape[1])
    assert torch.equal(tx.transmit_traced(frames, plan),
                       tx.transmit(frames, 4, scrambler_seed=torch.arange(1, 4), device="cpu"))


# -- (c) the codec's encode and decode against JAX --------------------------


@pytest.fixture(scope="module")
def codecs():
    from gnuradio_wifi_imagetransfer_tpu.models.jsce import JSCE as JaxJSCE

    jcodec = JaxJSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C)
    return jcodec, JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C,
                        params=(jcodec.enc_vars, jcodec.dec_vars), device="cpu")


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (IMG_HW, IMG_HW, 3), dtype=np.uint8)


@pytest.mark.parametrize("user", USERS)
def test_codec_encode_and_decode_match_jax(codecs, user):
    import jax.numpy as jnp

    jcodec, codec = codecs
    pre = codec._preprocess(_image(1))
    label = codec._label(user)
    with torch.inference_mode():
        lat = codec.encode(torch.from_numpy(pre), label)
    want = np.asarray(jcodec._enc_apply(jcodec.enc_vars, jnp.asarray(pre)[None],
                                        jcodec._label(user)))          # (1, h, w, c)
    assert lat.shape == (1, C, IMG_HW // 8, IMG_HW // 8)
    np.testing.assert_allclose(lat[0].permute(1, 2, 0).numpy(), want[0], atol=1e-5)

    latent = want[0]
    with torch.inference_mode():
        rec = codec.decode(torch.from_numpy(latent.copy()), label)
    x = latent / np.maximum(np.linalg.norm(latent, axis=-1, keepdims=True), 1e-12)
    jrec = np.asarray(jcodec._dec_apply(jcodec.dec_vars, jnp.asarray(x)[None],
                                        jcodec._label(user)))[0]
    assert rec.shape == (IMG_HW, IMG_HW, 3)

    def u8(r):
        from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import denormalize

        return (np.clip(denormalize(np.asarray(r)), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    assert int(np.abs(u8(rec.numpy()).astype(int) - u8(jrec).astype(int)).max()) <= 1
    # the facade is the same function
    assert np.array_equal(np.asarray(codec.msg2img(latent, user)), u8(rec.numpy()))


def test_codec_keeps_each_label_on_the_device_and_runs_the_cpu_eagerly(codecs):
    _, codec = codecs
    a = codec._label("3-4")
    assert codec._label("3-4") is a and not torch.equal(a, codec._label("13-10"))
    codec.img2msg({u: _image(2) for u in USERS})
    codec.msg2img(np.ones((IMG_HW // 8, IMG_HW // 8, C), np.float32), USERS[0])
    assert len(codec.graphs) == 0 and codec.graphs.captured == 0


def test_radios_run_the_cpu_eagerly():
    radio = bridge.LoopbackRadio(in_port=0, out_port=9, device="cpu")
    txr = bridge.TxRadio(in_port=0, samp_port=9, device="cpu")
    sent = []
    txr._emit = sent.append
    try:
        radio.sink.close()
        radio.sink = type("Sink", (), {"send_mac_payload": lambda self, p: sent.append(p),
                                       "close": lambda self: None})()
        payloads = [bytes(range(L))] * 3
        radio._process(payloads)
        txr._process(payloads)
    finally:
        radio.stop()
        txr.stop()
    assert radio.stats["frames_ok"] == 3 and len(sent) == 4
    assert len(radio.graphs) == len(txr.graphs) == 0


# -- (d) no host reads, no uploads on the second call -----------------------


class _NoHostReads(TorchDispatchMode):
    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                 torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN or func.overloadpacket in {
                torch.ops.aten.nonzero, torch.ops.aten.masked_select}:
            raise AssertionError(f"host read in a captured function: {func}")
        return func(*args, **(kwargs or {}))


def _captured(kind, codecs):
    """(function, inputs, generator or None) of one captured function on the
    CPU."""
    if kind.startswith("loopback"):
        algo, probes = {"loopback": (ChannelEstimator.LS, False),
                        "loopback_probes_sta": (ChannelEstimator.STA, True),
                        "loopback_probes_lms": (ChannelEstimator.LMS, True)}[kind]
        gen = torch.Generator()
        return _group_fn(3, algo, probes, gen), _group_inputs(2, seed=3), gen
    if kind == "tx":
        mpdus = _mpdus(2, seed=3)
        return (functools.partial(bridge.tx_bursts, plan=tx.tx_plan(2, mpdus.shape[1]),
                                  scale=0.5),
                bridge._staged(torch.device("cpu"), mpdus, np.arange(1, 3)), None)
    _, codec = codecs
    label = codec._label(USERS[1])
    if kind == "encode":
        return codec.encode, (torch.from_numpy(codec._preprocess(_image(3))), label), None
    latent = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (IMG_HW // 8, IMG_HW // 8, C)).astype(np.float32))
    return codec.decode, (latent, label), None


@pytest.mark.parametrize("kind", ["loopback", "loopback_probes_sta", "loopback_probes_lms",
                                  "tx", "encode", "decode"])
def test_serving_functions_read_nothing_back(monkeypatch, codecs, kind):
    fn, inputs, gen = _captured(kind, codecs)
    with torch.inference_mode():
        if gen is not None:
            gen.manual_seed(7)
        first = fn(*inputs)                       # builds the cached tables
        uploads = []

        def counted(real):
            def f(*a, **k):
                if not isinstance(a[0], torch.Tensor):      # a tensor passes through
                    uploads.append(real.__name__)
                return real(*a, **k)
            return f

        for name in ("as_tensor", "from_numpy", "tensor"):
            monkeypatch.setattr(torch, name, counted(getattr(torch, name)))
        if gen is not None:
            gen.manual_seed(7)
        with _NoHostReads():
            second = fn(*inputs)
        monkeypatch.undo()
    assert uploads == []
    assert torch.equal(first, second)


def test_no_host_reads_mode_catches_a_host_read():
    with pytest.raises(AssertionError, match="host read"):
        with _NoHostReads():
            float(torch.ones(2).sum())


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [False, True])
def test_loopback_replay_equals_eager_bit_for_bit(dev, probes):
    gen = torch.Generator(device=dev)
    cache = GraphCache()
    fn = _group_fn(3, ChannelEstimator.STA if probes else ChannelEstimator.LS, probes, gen)
    before = (k1.sync_detect.launches, k2.viterbi_decode_many.launches)
    for seed in (11, 12, 13):
        inputs = _group_inputs(4, seed=seed, dev=dev)
        gen.manual_seed(seed)
        eager = fn(*inputs)
        gen.manual_seed(seed)
        got = cache(("group", probes), fn, inputs, generators=(gen,))
        assert torch.equal(got, eager)
    assert cache.captured == len(cache) == 1
    # each call, eager or replayed, launches the detector and K2 once
    assert (k1.sync_detect.launches - before[0], k2.viterbi_decode_many.launches - before[1]) \
        == (6, 6)
    plan = tx.tx_plan(3, L + 28)
    _, ok, _, _ = bridge.group_fields(got.cpu().numpy(), plan, 4, probes)
    assert ok.sum() == 4


@pytest.mark.cuda
def test_replay_draws_what_a_fresh_generator_draws(dev):
    gen = torch.Generator(device=dev)
    cache = GraphCache()
    x = torch.zeros(3, 1000, device=dev)

    def noisy(v):
        return v + torch.randn(v.shape, generator=gen, device=dev) + 1j * torch.randn(
            v.shape, generator=gen, device=dev)

    outs = {}
    for s in (5, 6, 5, 6, 7):
        gen.manual_seed(s)
        outs.setdefault(s, []).append(cache("noisy", noisy, (x,), generators=(gen,)))
    assert cache.captured == 1
    for s, got in outs.items():
        fresh = torch.Generator(device=dev).manual_seed(s)
        want = x + torch.randn(x.shape, generator=fresh, device=dev) + 1j * torch.randn(
            x.shape, generator=fresh, device=dev)
        assert all(torch.equal(g, want) for g in got)
    assert not torch.equal(outs[5][0], outs[6][0])


@pytest.mark.cuda
def test_tx_and_codec_replays_equal_eager(dev):
    mpdus = _mpdus(3, seed=8)
    fn = functools.partial(bridge.tx_bursts, plan=tx.tx_plan(5, mpdus.shape[1]), scale=0.5)
    cache = GraphCache()
    for _ in range(3):
        inputs = bridge._staged(dev, mpdus, np.arange(1, 4))
        assert torch.equal(cache("tx", fn, inputs), fn(*inputs))
    codec = JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C, device=dev)
    eager = JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C, device=dev)
    eager.graphs = lambda key, f, inputs, generators=(): f(*inputs)
    images = {u: _image(i) for i, u in enumerate(USERS)}
    for _ in range(3):
        lat = codec.img2msg(images)
        assert np.array_equal(lat, eager.img2msg(images))
        for u in USERS:
            assert np.array_equal(np.asarray(codec.msg2img(lat, u)),
                                  np.asarray(eager.msg2img(lat, u)))
    assert codec.graphs.captured == len(codec.graphs) == 2


@pytest.mark.cuda
def test_codec_captures_while_a_radio_replays(dev):
    gen = torch.Generator(device=dev)
    cache = GraphCache()
    fn = _group_fn(3, ChannelEstimator.LS, False, gen)
    inputs = _group_inputs(2, seed=21, dev=dev)
    gen.manual_seed(21)
    want = cache("group", fn, inputs, generators=(gen,))
    stop, failed, replays = threading.Event(), [], [0]

    def radio():
        try:
            while not stop.is_set():
                gen.manual_seed(21)
                out = cache("group", fn, inputs, generators=(gen,))
                if not torch.equal(out, want):
                    failed.append("a replay differs")
                replays[0] += 1
        except Exception as e:        # a failure in the thread fails the test
            failed.append(e)

    worker = threading.Thread(target=radio)
    worker.start()
    try:
        codec = JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C, device=dev).warm()
        lat = codec.img2msg({u: _image(4) for u in USERS})
    finally:
        stop.set()
        worker.join()
    assert not failed and replays[0] > 0
    assert codec.graphs.captured == 2
    eager = JSCE(img_size=(IMG_HW, IMG_HW), compressed_channel=C, device=dev)
    eager.graphs = lambda key, f, inputs, generators=(): f(*inputs)
    assert np.array_equal(lat, eager.img2msg({u: _image(4) for u in USERS}))
