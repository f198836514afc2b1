"""The yardstick on the CPU: the vectorised TX against the frozen oracle,
the frozen bounds against the port's kernel table, the reference SNR, and
the traffic generators' seeds.

    python -m pytest benchmark/test_benchmark_yardstick.py
"""

from __future__ import annotations

import pathlib
import pickle
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

from yardstick import oracle_modem as om  # noqa: E402
from yardstick import pieces, reference, roofline, streams, vtx  # noqa: E402


@pytest.mark.parametrize("mcs", range(8))
@pytest.mark.parametrize("length", [1, 50, 294, 597])
def test_vectorised_tx_equals_the_oracle(mcs, length):
    rng = np.random.default_rng(1000 * mcs + length)
    psdus = rng.integers(0, 256, (3, length), dtype=np.uint8)
    seeds = rng.integers(1, 128, 3)
    bursts, points = vtx.transmit(psdus, mcs, seeds)
    assert bursts.shape == (3, vtx.burst_len(mcs, length))
    for i in range(3):
        st = om.transmit(psdus[i].tobytes(), vtx.MCS_MBPS[mcs], vtx.seed_bits(int(seeds[i])))
        np.testing.assert_allclose(bursts[i], st.samples, rtol=0, atol=1e-12)
        np.testing.assert_allclose(points[i].reshape(-1), st.data_points, rtol=0, atol=1e-12)


def test_annex_g_through_the_vectorised_tx():
    """The Annex G frame (36 Mb/s, seed 1011101) as the oracle sends it."""
    psdu = np.frombuffer(om.annex_g_psdu(), np.uint8)[None]
    bursts, _ = vtx.transmit(psdu, 5, np.array([0b1011101]))
    st = om.transmit(om.annex_g_psdu(), 36)
    np.testing.assert_allclose(bursts[0], st.samples, rtol=0, atol=1e-12)


# PERF.md's kernel table (§6) at its shapes: (bound, key, value, decimals)
BOUNDS = {
    "detector bytes at (64, 263 840), 4 slots": (
        lambda: roofline.sync_detect_bound(64 * 263_840, 64, 4), "bytes", 0.040, 3),
    "detector operations at the instruction rate": (
        lambda: roofline.sync_detect_bound(64 * 263_840, 64, 4), "operations", 0.022, 3),
    "K2 operations on (256 x 422) + (256 x 24)": (
        lambda: roofline.viterbi_bound(256 * (422 + 24)), "operations", 0.00113, 5),
    "K2 operations on stage A's 512 x 24": (
        lambda: roofline.viterbi_bound(512 * 24), "operations", 0.00012, 5),
    "K2 operations on 13 x 2 398": (lambda: roofline.viterbi_bound(13 * 2398), "operations",
                                    0.00031, 5),
    "K2 operations on 16 x 4 822": (lambda: roofline.viterbi_bound(16 * 4822), "operations",
                                    0.00076, 5),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_frozen_bounds_reproduce_the_kernel_table(case):
    fn, key, want, places = BOUNDS[case]
    assert round(fn()[key], places) == want


@pytest.mark.parametrize("steps,ms,places", [(422, 0.045, 3), (24, 0.0025, 4),
                                             (2374, 0.252, 3), (4798, 0.509, 3)])
def test_frozen_chain_floor_at_1980_mhz(steps, ms, places):
    assert round(roofline.chain_floor_ms(steps, 1980.0), places) == ms


def test_the_instruction_rate_is_half_the_fma_rate():
    assert roofline.FP32_INSTR_PER_S == pytest.approx(132 * 128 * 1.98e9, rel=2e-3)
    assert roofline.FP32_FMA_OPS_PER_S == 2 * roofline.FP32_INSTR_PER_S


@pytest.mark.parametrize("mcs,length", [(0, 50), (3, 294), (7, 597)])
def test_reference_snr_reads_the_noise_it_was_given(mcs, length):
    """A frame with a CFO in AWGN of known power: the reference's
    data-aided SNR lands on the injected SNR (the LS estimate from two
    long symbols adds half the noise again: -1.76 dB), and a clean frame
    reads far above it."""
    rng = np.random.default_rng(7)
    psdu = rng.integers(0, 256, (1, length), dtype=np.uint8)
    burst, points = vtx.transmit(psdu, mcs, np.array([93]))
    cfo = 0.02
    n = burst.shape[1]
    x = np.zeros(n + 400, np.complex128)
    x[200: 200 + n] = 0.5 * burst[0] * np.exp(1j * (0.7 + cfo * np.arange(n)))
    clean = reference.snr_db(x, 200, cfo, mcs, length, points[0])
    assert clean > 100.0
    snr = 25.0
    sigma = np.sqrt(0.25 * 10 ** (-snr / 10) / 2)
    noisy = x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    got = reference.snr_db(noisy, 200, cfo, mcs, length, points[0])
    assert got == pytest.approx(snr - 10 * np.log10(1.5), abs=1.0)


TRAFFIC = {"mcs": [0, 3, 7], "psdu_lengths": [50, 100], "pool_per_combo": 2,
           "placement": {"mode": "back_to_back", "per_combo_per_channel": 2, "lead": 300,
                         "gap": [200, 600], "tail_margin": 2000},
           "amplitude": 0.5, "snr_db": 30.0, "cfo_ppm": 20.0, "carrier_hz": 5.89e9,
           "sample_rate_hz": 20e6, "streams": 2}


def _loopback_heads(noise_voltage, snr_db=22.0, groups=40, mpdu=322, mcs=3, seed=5):
    """Heads of the loopback channel's output as the radio probes them:
    100 zeros, a burst at 0.6 scaled by 10^(snr/20), 400 zeros, noise of
    ``noise_voltage`` over all of it."""
    rng = np.random.default_rng(seed)
    psdus = rng.integers(0, 256, (groups, mpdu), dtype=np.uint8)
    x, _ = vtx.transmit(psdus, mcs, np.arange(groups) % 127 + 1)
    y = np.zeros((groups, 100 + x.shape[1] + 400), np.complex128)
    y[:, 100: 100 + x.shape[1]] = 0.6 * 10 ** (snr_db / 20) * x
    y += noise_voltage / np.sqrt(2) * (rng.standard_normal(y.shape)
                                       + 1j * rng.standard_normal(y.shape))
    return [(mpdu, row.astype(np.complex64)) for row in y]


@pytest.mark.parametrize("noise_voltage,gap", [(1.0, (0.0, 0.1)),
                                               (10 ** (-3 / 20), (2.8, 3.2)),
                                               (0.0, (999.0, 999.0))])
def test_channel_snr_reads_the_noise_it_was_given(noise_voltage, gap):
    heads = _loopback_heads(noise_voltage)
    res = reference.channel_snr(heads, 3, [100, 400], 0.6, 22.0, 1.0, seed=1)
    assert res["groups"] == len(heads) and gap[0] <= res["gap_db"] <= gap[1]


def test_streams_repeat_their_seed_and_keep_their_sizes_across_seeds():
    n = 1 << 16
    a_pool, a = streams.make_streams(TRAFFIC, 2, n, 1 << 14, 2**31 + 5)
    _, b = streams.make_streams(TRAFFIC, 2, n, 1 << 14, 2**31 + 5)
    _, c = streams.make_streams(TRAFFIC, 2, n, 1 << 14, 12)
    np.testing.assert_array_equal(a[0].x, b[0].x)
    assert not np.array_equal(a[0].x, c[0].x)
    for s in a + c:
        sizes = sorted(zip(s.channel, s.mcs, s.length))
        assert sizes == sorted(zip(a[0].channel, a[0].mcs, a[0].length))
        ends = s.start + np.array([vtx.burst_len(int(m), int(n_))
                                   for m, n_ in zip(s.mcs, s.length)])
        assert ends.max() <= n and s.cfo.max() <= 2 * np.pi * 20e-6 * 5.89e9 / 20e6
    assert a[0].psdu(a_pool, 0).shape == (int(a[0].length[0]),)


def test_per_block_placement_puts_each_frame_in_its_part_of_a_block():
    tr = {**TRAFFIC, "mcs": [2], "psdu_lengths": [50],
          "placement": {"mode": "per_block", "per_block": 3, "margin": 400}}
    _, (s, _) = streams.make_streams(tr, 2, 4 * 8192, 8192, 3)
    assert s.frames == 2 * 4 * 3
    part = (s.start % 8192) // (8192 // 3)
    assert sorted(np.bincount(part)) == [8, 8, 8]


def test_pieces_are_the_reference_senders():
    dgrams, payloads = pieces.make_pieces((30, 30, 3), (10, 10), 2**31 + 9)
    assert len(dgrams) == 27
    for d, p in zip(dgrams, payloads):
        assert int.from_bytes(d[:4], sys.byteorder) == len(p) and d[4:] == p
        (y, x, c), patch = pickle.loads(p)
        assert patch.shape == (10, 10, 1) and patch.dtype == np.uint8
    again, _ = pieces.make_pieces((30, 30, 3), (10, 10), 2**31 + 9)
    assert again == dgrams


def test_schedules():
    np.testing.assert_allclose(pieces.schedule(4, 100.0, "steady"), [0, 0.01, 0.02, 0.03])
    np.testing.assert_allclose(pieces.schedule(6, 100.0, "bursty", 3), [0, 0, 0, .03, .03, .03])
