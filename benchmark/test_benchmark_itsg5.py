"""The ITS-G5 cell on the CPU: the vehicular channel (tap powers, the
Doppler spectrum's edge, the seed), the layout's busy share, and
``correct`` at the rehearsal's sizes: a sound run passes, and its controls
in the program (the LS equalizer, the sc8 wire format) are refused while
the plain receiver keeps the configuration's STA and sc16.

    python -m pytest benchmark/test_benchmark_itsg5.py      (about a minute)
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402
from yardstick import vehicular, vtx  # noqa: E402

CELL = "rx-itsg5-sta-4ch.highway"
TRAFFIC = json.loads((HERE / "traffic" / "highway.json").read_text())
CHANNEL = TRAFFIC["channel"]
FS = TRAFFIC["sample_rate_hz"]
SEED = 2**31 + 23


def test_the_profile_has_its_rms_delay_and_sums_to_one():
    p = vehicular.profile(CHANNEL["taps"], CHANNEL["rms_delay_s"], FS)
    k = np.arange(p.size)
    mean = (p * k).sum()
    assert p.sum() == pytest.approx(1.0)
    assert np.sqrt((p * k * k).sum() - mean ** 2) / FS == pytest.approx(0.3e-6, rel=1e-6)
    assert np.all(np.diff(p) < 0)


def test_tap_powers_follow_the_profile():
    p = vehicular.profile(CHANNEL["taps"], CHANNEL["rms_delay_s"], FS)
    rng = np.random.default_rng(1)
    g = np.stack([vehicular.tap_gains(rng, p, 64, CHANNEL, FS)[0] for _ in range(4000)])
    # 4 000 Rayleigh draws a tap: the mean power within 5 % of the profile
    np.testing.assert_allclose((np.abs(g) ** 2).mean(0), p, rtol=0.05)


def test_the_doppler_spectrum_ends_at_the_maximum_doppler():
    p = vehicular.profile(CHANNEL["taps"], CHANNEL["rms_delay_s"], FS)
    rng = np.random.default_rng(2)
    n = 1 << 17                                       # 13 ms: 10 Hz bins a 1310 Hz edge
    f = np.fft.fftfreq(n, 1.0 / FS)
    psd = np.zeros(n)
    for _ in range(40):
        g = vehicular.tap_gains(rng, p, n, CHANNEL, FS)[:, 0]
        psd += np.abs(np.fft.fft(g * np.hanning(n))) ** 2
    fd = CHANNEL["doppler_hz"]
    a = np.abs(f)
    assert psd[a > 1.05 * fd].sum() < 1e-4 * psd.sum()                 # nothing past the edge
    # Clarke's U: more power just inside the edge than around 0 Hz
    assert psd[(a > 0.9 * fd) & (a <= fd)].sum() > 2 * psd[a < 0.1 * fd].sum()


def test_streams_repeat_their_seed_and_keep_their_sizes():
    t = {**TRAFFIC, **TRAFFIC["rehearse"]}
    (_, a), (_, b), (_, c) = (vehicular.make_streams(t, 2, 4 * 8192, 8192, s)
                              for s in (SEED, SEED, SEED + 1))
    for x, y in zip(a, b):
        assert np.array_equal(x.x, y.x) and np.array_equal(x.start, y.start)
    assert not np.array_equal(a[0].x, c[0].x)
    assert sorted(zip(a[0].mcs, a[0].length)) == sorted(zip(c[0].mcs, c[0].length))


def test_each_channel_is_busy_its_share_of_the_span():
    rng = np.random.default_rng(3)
    frames = vehicular._layout(TRAFFIC, 16 * 262144, rng)
    ends = [s + vtx.burst_len(m, ln) for s, m, ln in frames]
    busy = sum(e - s for e, (s, _, _) in zip(ends, frames))
    assert len(frames) == 3 * sum(TRAFFIC["mcs_frames"].values())
    assert busy / (ends[-1] - frames[0][0]) == pytest.approx(TRAFFIC["busy_share"], abs=0.01)
    assert all(e < s for e, (s, _, _) in zip(ends, frames[1:]))


def _run(phy=None, wire=None, monkeypatch=None):
    if phy:
        import gnuradio_wifi_imagetransfer_tpu_torch.config as cfg

        real = cfg.PhyConfig
        monkeypatch.setattr(cfg, "PhyConfig", lambda **kw: real(**{**kw, **phy}))
    over = {"wire_format": wire} if wire else None
    return run.run_cell(CELL, SEED, 1.0, 0, rehearse=True, overrides=over)


def test_a_sound_run_passes():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["snr_gap_max_db"]["value"] < 0.01


@pytest.mark.parametrize("control", ["ls", "sc8"])
def test_the_controls_are_refused(control, monkeypatch):
    res = (_run(phy={"chan_est": 0}, monkeypatch=monkeypatch) if control == "ls"
           else _run(wire="sc8"))
    assert not res["correct"]
    assert res["failed"] > 0 or any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_rehearsal_command_passes():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--rehearse", "--workload", CELL],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "correct=True" in out.stdout
