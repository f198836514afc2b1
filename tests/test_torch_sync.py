"""The port's sync front-end (ops/sync_stats.py plain path and phy/sync.py)
against the JAX package on the CPU.

Tolerances of the statistics are those tests/test_pallas_sync.py holds the
TPU kernel to: atol 2e-4 on a and p, 1e-3 on c where p > 1e-3. Candidate
starts, valid flags and decoded bytes must match exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from gnuradio_wifi_imagetransfer_tpu.ops import pallas_sync
from gnuradio_wifi_imagetransfer_tpu.phy import sync as jsync
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx

torch.set_num_threads(2)


def _random_stream(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _burst_stream():
    """An 802.11a burst at sample 500 of a 4096-sample noisy stream."""
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, 50, dtype=np.uint8)
    burst = np.asarray(jtx.transmit(jnp.asarray(payload)[None], 2))[0]
    x = np.zeros(4096, np.complex64)
    x[500: 500 + burst.size] = 0.5 * burst
    x += (0.01 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
          ).astype(np.complex64)
    return x


STREAMS = {
    "random5000": lambda: _random_stream(5000, 0),
    "burst": _burst_stream,
    "batched": lambda: _random_stream((2, 3000), 2),
}


def _ref_stats(x, ref):
    if ref == "xla":
        return [np.asarray(v) for v in jsync.sync_stats(jnp.asarray(x))]
    return [np.asarray(v) for v in pallas_sync.sync_stats(jnp.asarray(x), interpret=True)]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("stream", ["random5000", "burst", "batched"])
def test_sync_stats_matches_jax(stream, ref):
    x = STREAMS[stream]()
    a_o, p_o, c_o = _ref_stats(x, ref)
    a, p, c = (v.numpy() for v in sync.sync_stats(torch.from_numpy(x)))
    assert (a.dtype, p.dtype, c.dtype) == (np.complex64, np.float32, np.float32)
    np.testing.assert_allclose(a, a_o, atol=2e-4, rtol=0)
    np.testing.assert_allclose(p, p_o, atol=2e-4, rtol=0)
    mask = p_o > 1e-3
    np.testing.assert_allclose(c[mask], c_o[mask], atol=1e-3, rtol=0)
    if stream == "burst":
        assert c[560:640].min() > 0.56       # plateau inside the STF
        assert c[:400].max() < 0.56          # noise floor below threshold


def test_sync_stats_silence_is_exactly_zero():
    """Windows wholly inside a silent stretch give exact zeros, even after
    a loud stretch (the segmented sums do not leak cancellation residue)."""
    x = _random_stream(6000, 3) * 3
    x[2000:4000] = 0
    a, p, c = sync.sync_stats(torch.from_numpy(x))
    assert torch.count_nonzero(a[..., 2064:4000]) == 0
    assert torch.count_nonzero(p[..., 2064:4000]) == 0
    assert torch.count_nonzero(c[..., 2064:4000]) == 0


@pytest.fixture(scope="module")
def example_block():
    return graft._example_block(1 << 15, 4)


@pytest.mark.parametrize("lo,hi", [(0, None), (300, 20000)])
def test_detect_matches_jax(example_block, lo, hi):
    x, _ = example_block
    want = [np.asarray(v) for v in jax.jit(lambda x: _fields(
        jsync.detect(x, 8, search_lo=lo, search_hi=hi)))(jnp.asarray(x))]
    got = _fields(sync.detect(torch.from_numpy(x), 8, search_lo=lo, search_hi=hi))
    assert np.array_equal(got[0].numpy(), want[0])                  # starts
    assert np.array_equal(got[1].numpy(), want[1])                  # valid
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=1e-3, rtol=0)


def _fields(cand):
    return cand.starts, cand.valid, cand.cfo, cand.ratio


def test_extract_clamps_like_dynamic_slice():
    x = _random_stream(3000, 4)
    starts = np.array([0, 100, 1500, 2950, 2999], np.int32)
    want = np.asarray(jsync.extract(jnp.asarray(x), jnp.asarray(starts), 900))
    got = sync.extract(torch.from_numpy(x), torch.from_numpy(starts), 900)
    assert np.array_equal(got.numpy(), want)


def test_receive_matches_jax_on_the_flagship_block(example_block):
    """The flagship: a 32 768-sample block, MCS 2, 50-byte PSDUs, 8 slots."""
    x, frames = example_block
    plan = tx.tx_plan(2, 50)
    jplan = jtx.tx_plan(2, 50)

    def jax_receive(x):
        res, cand = jsync.receive(x, jplan, max_frames=8)
        return (res.psdu,) + _fields(cand)

    jpsdu, jstarts, jvalid, jcfo, _ = (np.asarray(v) for v in
                                       jax.jit(jax_receive)(jnp.asarray(x)))
    res, cand = sync.receive(x, plan, max_frames=8, device="cpu")
    assert np.array_equal(cand.starts.numpy(), jstarts)
    assert np.array_equal(cand.valid.numpy(), jvalid)
    assert np.array_equal(res.psdu.numpy(), jpsdu)
    np.testing.assert_allclose(cand.cfo.numpy(), jcfo, atol=1e-5, rtol=0)
    valid = cand.valid.numpy()
    assert valid.sum() == 4 and np.array_equal(res.psdu.numpy()[valid], frames)


def test_synchronize_matches_jax_with_cfo():
    """A frequency offset of 0.01 rad/sample: windows, frame starts and the
    coarse+fine CFO agree."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, (2, 40), dtype=np.uint8)
    bursts = np.asarray(jtx.transmit(jnp.asarray(payload), 4))
    x = np.zeros(12000, np.complex64)
    for pos, b in zip((700, 6000), bursts):
        x[pos: pos + b.size] = 0.5 * b
    x = (x * np.exp(1j * 0.01 * np.arange(x.size))).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
          ).astype(np.complex64)
    n_sym = jtx.tx_plan(4, 40).n_sym

    def jax_sync(x):
        w, fs, cand = jsync.synchronize(x, n_sym, 4)
        return (w, fs) + _fields(cand)

    jw, jfs, _, jvalid, jcfo, _ = (np.asarray(v) for v in
                                   jax.jit(jax_sync)(jnp.asarray(x)))
    w, fs, c = sync.synchronize(torch.from_numpy(x), n_sym, 4)
    assert np.array_equal(fs.numpy(), jfs)
    assert np.array_equal(c.valid.numpy(), jvalid)
    np.testing.assert_allclose(c.cfo.numpy(), jcfo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-4, rtol=0)
