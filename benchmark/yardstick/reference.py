"""The plain reference that decides ``correct``.

Receiver cells. The traffic's truth is the reference for what a frame
carries: its PSDU bytes, its rate and length (the SIGNAL field) and its
first preamble sample and CFO (sync). ``check_stream`` holds one run's
frame records to it: a truth frame is delivered when a record on its
channel has its sync edge inside the frame's short training field (the
160 samples from its first preamble sample), SIGNAL parity, the truth's
rate and length and the truth's bytes, all of them. The per-frame SNR is
held to ``snr_db``, a data-aided EVM SNR worked out here from the
generated samples: derotate by the truth CFO, LS channel estimate from the
two long training symbols, a common pilot phase a symbol, then the error
against the transmitted constellation points. It reads the program's
records only to judge them.

Radio cells. A piece's reference is the bytes the load generator sent;
the load process holds each arrival to them (loadgen.py). The channel is
held to its configured SNR by ``channel_snr``, from the head of the
channel's output of each probed group: the noise power where the TX sends
zeros around the first burst, the power of the burst's own samples, and
the power that the configuration gives a burst of the reference TX there.
NumPy only.
"""

from __future__ import annotations

import numpy as np

from yardstick import oracle_modem as om
from yardstick import vtx

STF_LEN = 160
LTF1, LTF2 = 192, 256                      # first samples of the two long symbols
_USED = np.flatnonzero(om.LTF_FREQ != 0)   # the 52 used bins, shifted order
_DATA = np.array(om.DATA_CARRIERS) + 32
_PILOT = np.array(om.PILOT_CARRIERS) + 32
_PILOT_VALUES = np.array(om.PILOT_VALUES)


def _spectrum(t: np.ndarray) -> np.ndarray:
    """(..., 64) time samples -> shifted spectra on the oracle's scale."""
    return np.fft.fftshift(np.fft.fft(t, axis=-1), axes=-1) / om.IFFT_SCALE


def snr_db(x: np.ndarray, start: int, cfo: float, mcs: int, length: int,
           points: np.ndarray) -> float:
    """Data-aided EVM SNR (dB) of the frame whose first preamble sample is
    x[start], rotating by ``cfo`` rad/sample, carrying ``points`` (n_sym,
    48) on its data carriers."""
    ns = vtx.n_sym(mcs, length)
    n = vtx.burst_len(mcs, length)
    seg = x[start: start + n].astype(np.complex128) * np.exp(-1j * cfo * np.arange(n))
    y1, y2 = _spectrum(seg[LTF1: LTF1 + 64]), _spectrum(seg[LTF2: LTF2 + 64])
    h = np.ones(64, np.complex128)
    h[_USED] = 0.5 * (y1[_USED] + y2[_USED]) / om.LTF_FREQ[_USED]
    first = vtx.PREAMBLE_LEN + vtx.SYM + 16               # data symbol 0, past its CP
    t = seg[first + vtx.SYM * np.arange(ns)[:, None] + np.arange(64)]
    eq = _spectrum(t) / h                                 # (n_sym, 64)
    want = om.POLARITY[(1 + np.arange(ns)) % 127][:, None] * _PILOT_VALUES
    phase = np.angle((eq[:, _PILOT] * np.conj(want)).sum(-1))
    data = eq[:, _DATA] * np.exp(-1j * phase)[:, None]
    err = np.mean(np.abs(data - points) ** 2)
    return float(10.0 * np.log10(np.mean(np.abs(points) ** 2) / err))


def records_arrays(records) -> dict:
    """Frame records (anything with the FrameRecord fields) -> arrays."""
    return {
        "channel": np.array([r.channel for r in records], np.int64),
        "start": np.array([r.global_start for r in records], np.int64),
        "ok": np.array([bool(r.parity_ok) for r in records], bool),
        "mcs": np.array([r.rate_idx for r in records], np.int64),
        "length": np.array([r.length for r in records], np.int64),
        "cfo": np.array([r.cfo for r in records], np.float64),
        "snr": np.array([r.snr_db for r in records], np.float64),
        "psdu": [np.asarray(r.psdu, np.uint8) for r in records],
    }


def check_stream(stream, pool, recs: dict) -> dict:
    """One run's records against one stream's truth -> {"frames": truth
    frames, "bad": [truth index] not delivered, "matched": {truth index:
    record index}, "spurious": parity-good records that match no frame}."""
    order = np.lexsort((recs["start"], recs["channel"]))
    key = recs["channel"][order] * (1 << 40) + recs["start"][order]
    bad, matched = [], {}
    used = np.zeros(len(order), bool)
    for i in range(stream.frames):
        lo = stream.channel[i] * (1 << 40) + stream.start[i]
        a, b = np.searchsorted(key, [lo, lo + STF_LEN])
        want = stream.psdu(pool, i)
        hit = None
        for j in order[a:b]:
            if (recs["ok"][j] and recs["mcs"][j] == stream.mcs[i]
                    and recs["length"][j] == stream.length[i]
                    and np.array_equal(recs["psdu"][j], want)):
                hit = int(j)
                break
        if hit is None:
            bad.append(i)
        else:
            matched[i] = hit
            used[hit] = True
    spurious = int((recs["ok"] & ~used).sum())
    return {"frames": stream.frames, "bad": bad, "matched": matched, "spurious": spurious}


NO_NOISE_GAP_DB = 999.0     # the gap reported where the channel shows no noise at all


def channel_snr(heads: list, mcs: int, pad: list, scale: float, snr_db: float,
                noise_voltage: float, seed: int, margin: int = 8) -> dict:
    """The loopback channel's SNR over its first burst, as the probed groups
    saw it, against the configuration's. ``heads`` holds (MPDU length,
    the channel's first output samples) a group; a group's stream starts
    with ``pad[0]`` zeros, the first burst and ``pad[1]`` zeros (the TX's
    padding), with the burst at ``scale`` and the signal at ``snr_db``
    over noise of ``noise_voltage`` (total power). Samples within
    ``margin`` of a burst edge are left out. Returns {"gap_db": |measured
    - reference|, "snr_db", "ref_snr_db", "noise_power", "groups"}; with
    no noise measured, or no group, the gap is NO_NOISE_GAP_DB."""
    front, tail = int(pad[0]), int(pad[1])
    sig = noise = ref = 0.0
    n_sig = n_noise = groups = 0
    ref_power: dict = {}
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xC4]))
    for mpdu_len, y in heads:
        nb = vtx.burst_len(mcs, mpdu_len)
        if y.size < front + nb + tail:
            continue
        if mpdu_len not in ref_power:
            psdus = rng.integers(0, 256, (16, mpdu_len), dtype=np.uint8)
            x, _ = vtx.transmit(psdus, mcs, np.arange(16) % 127 + 1)
            ref_power[mpdu_len] = float(np.mean(np.abs(x[:, margin: nb - margin]) ** 2))
        y = y.astype(np.complex128)
        s = y[front + margin: front + nb - margin]
        z = np.concatenate([y[: front - margin], y[front + nb + margin: front + nb + tail]])
        sig += float(np.sum(np.abs(s) ** 2))
        noise += float(np.sum(np.abs(z) ** 2))
        ref += ref_power[mpdu_len] * s.size
        n_sig += s.size
        n_noise += z.size
        groups += 1
    gain = (scale * 10.0 ** (snr_db / 20.0)) ** 2
    ref_snr = 10.0 * np.log10(gain * ref / n_sig / noise_voltage ** 2) if n_sig else None
    p_noise = noise / n_noise if n_noise else 0.0
    p_sig = sig / n_sig - p_noise if n_sig else 0.0
    if not groups or p_noise <= 0.0 or p_sig <= 0.0:
        return {"gap_db": NO_NOISE_GAP_DB, "snr_db": None, "ref_snr_db": ref_snr,
                "noise_power": p_noise, "groups": groups}
    snr = 10.0 * np.log10(p_sig / p_noise)
    return {"gap_db": float(abs(snr - ref_snr)), "snr_db": float(snr),
            "ref_snr_db": float(ref_snr), "noise_power": p_noise, "groups": groups}
