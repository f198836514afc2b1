"""The port's MAC framing and batched CRC-32 against zlib and the JAX
package on the CPU: framed bytes exactly, CRC values exactly."""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.phy import mac as jmac
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac

torch.set_num_threads(2)


@pytest.mark.parametrize("b,l,seq0", [(1, 1, 0), (5, 22, 4090), (16, 200, 7)])
def test_frame_batch_equals_jax(b, l, seq0):
    payloads = np.random.default_rng(l).integers(0, 256, (b, l), dtype=np.uint8)
    got = mac.frame_batch(payloads, seq0)
    assert got.dtype == np.uint8 and got.shape == (b, l + 28)
    assert np.array_equal(got, jmac.frame_batch(payloads, seq0))
    addrs = dict(src=bytes(range(6)), dst=bytes(range(6, 12)), bss=bytes(range(12, 18)))
    assert np.array_equal(mac.frame_batch(payloads, seq0, **addrs),
                          jmac.frame_batch(payloads, seq0, **addrs))


def test_mac_frame_and_parse_round_trip():
    ours, theirs = mac.Mac(), jmac.Mac()
    for i, payload in enumerate([b"", b"x" * 5, bytes(range(256)) * 3]):
        mpdu = ours.frame(payload)
        assert mpdu == theirs.frame(payload)
        f = mac.parse(mpdu)
        assert (f.frame_control, f.duration, f.seq_no, f.payload, f.fcs_ok) == (
            mac.FRAME_CONTROL, mac.DURATION, i, payload, True)
        assert (f.addr1, f.addr2, f.addr3) == (mac.DEFAULT_DST, mac.DEFAULT_SRC, mac.DEFAULT_BSS)
        assert f == mac.MacFrame(**vars(jmac.parse(mpdu)))
        bad = bytearray(mpdu)
        bad[-5] ^= 0x10
        assert not mac.parse(bytes(bad)).fcs_ok
    ours.seq_no = 0xFFF
    ours.frame(b"")
    assert ours.seq_no == 0
    with pytest.raises(ValueError):
        mac.parse(bytes(27))
    with pytest.raises(ValueError):
        mac.Mac(src=bytes(5))


@pytest.mark.parametrize("shape", [(1, 1), (7, 46), (3, 2, 100), (64, 824)])
def test_crc32_equals_zlib_and_jax(shape):
    data = np.random.default_rng(shape[-1]).integers(0, 256, shape, dtype=np.uint8)
    got = mac.crc32(torch.from_numpy(data))
    assert got.dtype == torch.int64 and got.shape == shape[:-1]
    want = np.array([zlib.crc32(row.tobytes()) for row in data.reshape(-1, shape[-1])],
                    dtype=np.int64).reshape(shape[:-1])
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jmac.crc32_jax(jnp.asarray(data))).astype(
        np.int64))


def test_check_fcs_batch_finds_one_flipped_bit():
    rng = np.random.default_rng(3)
    mpdus = mac.frame_batch(rng.integers(0, 256, (12, 22), dtype=np.uint8))
    assert mac.check_fcs_batch(torch.from_numpy(mpdus)).tolist() == [True] * 12
    flipped = mpdus.copy()
    for i in range(12):                       # one bit a frame, header to FCS
        pos = int(rng.integers(0, mpdus.shape[1]))
        flipped[i, pos] ^= np.uint8(1 << int(rng.integers(0, 8)))
    assert mac.check_fcs_batch(torch.from_numpy(flipped)).tolist() == [False] * 12
    assert np.array_equal(np.asarray(jmac.check_fcs_batch(jnp.asarray(flipped))), [False] * 12)
