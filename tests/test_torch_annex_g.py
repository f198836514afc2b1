"""The Annex G anchor of tests/test_annex_g.py held against the PyTorch
port: its TX stages, waveform and RX decode against the independent
oracle (tests/oracle_modem.py, a sequential numpy transmitter written from
the standard's prose) and the frozen per-stage fixtures
(tests/golden/annex_g_stages.npz), with that file's tolerances: bits
exactly, constellation points within 1e-6, waveforms within 2e-4."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import oracle_modem as oracle
from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits as bitops
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, mapping, params, rx, signal_field, tx

torch.set_num_threads(2)

# 802.11a-1999 17.3.5.4: the 127-bit scrambler sequence from the all-ones
# state, as published
SCRAMBLER_127 = np.array([int(b) for b in (
    "00001110" "11110010" "11001001" "00000010" "00100110" "00101110"
    "10110110" "00001100" "11010100" "11100111" "10110100" "00101010"
    "11111010" "01010001" "10111000" "1111111")], dtype=np.uint8)
# Annex G SIGNAL field: RATE 1011 (36 Mb/s), LENGTH 100 LSB first, parity 0
ANNEX_G_SIGNAL_BITS = np.array([int(b) for b in "101100010011000000000000"], dtype=np.uint8)
ANNEX_G_SEED_INT = 0b1011101  # x7..x1 = 1011101
PUNCTURE_MASKS = {"2/3": np.array([1, 1, 1, 0], bool), "3/4": np.array([1, 1, 1, 0, 0, 1], bool)}
ORACLE_RATE = {"2/3": (2, 3), "3/4": (3, 4)}


@pytest.fixture(scope="module")
def annex_g():
    psdu = oracle.annex_g_psdu()
    return psdu, oracle.transmit(psdu, 36, oracle.ANNEX_G_SEED)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(os.path.dirname(__file__), "golden", "annex_g_stages.npz")))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_scrambler_and_signal_bits_match_the_standard():
    np.testing.assert_array_equal(params.scrambler_sequence(0x7F, 127), SCRAMBLER_127)
    np.testing.assert_array_equal(bitops.scrambler_bits(127, 0x7F).numpy(), SCRAMBLER_127)
    np.testing.assert_array_equal(params.POLARITY, 1 - 2 * SCRAMBLER_127.astype(np.int32))
    seeded = bitops.scrambler_bits(127, ANNEX_G_SEED_INT).numpy()
    np.testing.assert_array_equal(seeded, oracle.scrambler_stream(list(oracle.ANNEX_G_SEED), 127))
    got = signal_field.signal_bits(5, torch.tensor(100)).numpy()
    np.testing.assert_array_equal(got, ANNEX_G_SIGNAL_BITS)
    np.testing.assert_array_equal(got, oracle.signal_field_bits(36, 100))


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_puncture_matches_figure_114(rate):
    ramp = np.arange(24, dtype=np.uint8)
    want = ramp[np.tile(PUNCTURE_MASKS[rate], 24 // PUNCTURE_MASKS[rate].size)]
    np.testing.assert_array_equal(bitops.puncture(_t(ramp), rate).numpy(), want)
    np.testing.assert_array_equal(oracle.puncture(ramp, ORACLE_RATE[rate]), want)


def test_preamble_matches_oracle():
    np.testing.assert_allclose(params.PREAMBLE, oracle.preamble().astype(np.complex64), atol=1e-5)


def _tx_stages(psdu: np.ndarray):
    """The port's TX products of the Annex G frame (16-QAM 3/4, seed
    1011101): data bits, scrambled, coded, punctured, interleaved, data
    points, SIGNAL points and the waveform."""
    plan = tx.tx_plan(5, psdu.size)
    raw = torch.cat([torch.zeros(16, dtype=torch.uint8), bitops.bytes_to_bits(_t(psdu)),
                     torch.zeros(6 + plan.n_pad_bits, dtype=torch.uint8)])
    scr = bitops.scramble(raw, ANNEX_G_SEED_INT).clone()
    scr[16 + 8 * psdu.size: 16 + 8 * psdu.size + 6] = 0
    coded = bitops.conv_encode(scr)
    punct = bitops.puncture(coded, "3/4")
    inter = bitops.interleave(punct, 5)
    return {
        "data_bits": raw.numpy(), "scrambled": scr.numpy(), "coded": coded.numpy(),
        "punctured": punct.numpy(), "interleaved": inter.numpy(),
        "data_points": mapping.map_bits(inter, 5).numpy(),
        "signal_points": signal_field.encode(5, torch.tensor(100)).numpy(),
        "samples": tx.transmit(psdu, 5, scrambler_seed=ANNEX_G_SEED_INT, device="cpu").numpy(),
    }


def _assert_stages(got, want):
    for k in ("data_bits", "scrambled", "coded", "punctured", "interleaved"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("data_points", "signal_points"):
        np.testing.assert_allclose(got[k], want[k].astype(np.complex64), atol=1e-6, err_msg=k)
    assert got["samples"].shape == want["samples"].shape
    np.testing.assert_allclose(got["samples"], want["samples"].astype(np.complex64), atol=2e-4)


def test_tx_stages_match_oracle(annex_g):
    psdu, st = annex_g
    _assert_stages(_tx_stages(np.frombuffer(psdu, dtype=np.uint8).copy()), vars(st))


def test_tx_matches_golden_fixtures(golden):
    _assert_stages(_tx_stages(golden["psdu"]), golden)


@pytest.mark.parametrize("source", ["oracle", "golden"])
def test_rx_decodes_the_annex_g_waveform(annex_g, golden, source):
    """The port's RX decodes the Annex G waveform (the oracle's, and the
    frozen one) bit-exactly, and the FCS verifies on the tensor's device."""
    samples = annex_g[1].samples if source == "oracle" else golden["samples"]
    res = rx.decode_aligned(_t(samples.astype(np.complex64))[None], tx.tx_plan(5, 100),
                            algo=ChannelEstimator.LS)
    got = res.psdu.numpy()[0]
    np.testing.assert_array_equal(got, golden["psdu"])
    np.testing.assert_array_equal(got, np.frombuffer(annex_g[0], dtype=np.uint8))
    assert (int(res.sig["rate_idx"][0]), int(res.sig["length"][0])) == (5, 100)
    assert bool(res.sig["parity_ok"][0])
    assert bool(mac.check_fcs_batch(res.psdu)[0])
    assert bytes(got[24:-4]) == oracle.ANNEX_G_MESSAGE


@pytest.mark.parametrize("mcs", range(8))
def test_rx_decodes_oracle_waveforms_at_every_mcs(mcs):
    """Oracle TX -> the port's RX at every MCS (a 60-byte PSDU whose last
    4 bytes are its FCS)."""
    payload = np.random.default_rng(7).integers(0, 256, 56, dtype=np.uint8).tobytes()
    psdu = payload + oracle.fcs(payload)
    st = oracle.transmit(psdu, int(params.MCS_MBPS[mcs]), (1, 0, 1, 1, 1, 0, 1))
    res = rx.decode_aligned(_t(st.samples.astype(np.complex64))[None],
                            tx.tx_plan(mcs, len(psdu)))
    np.testing.assert_array_equal(res.psdu.numpy()[0], np.frombuffer(psdu, dtype=np.uint8))
    assert int(res.sig["rate_idx"][0]) == mcs
    assert int(mac.crc32(res.psdu[:, :-4])[0]) == int.from_bytes(psdu[-4:], "little")
