"""The WLAN cell on the CPU: the IP-mix traffic (its lengths, its
variable-length TX against ``vtx.transmit``, its seed), and ``correct`` at
the rehearsal's sizes: a sound run passes and the sc8 control is refused.

    python -m pytest benchmark/test_benchmark_wlan.py      (about two minutes)
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402
from yardstick import ip_mix, vtx  # noqa: E402

CELL = "rx-wlan-mtu1500-4ch.ip-mix"
TRAFFIC = json.loads((HERE / "traffic" / "ip-mix.json").read_text())
SEED = 2**31 + 29


def test_lengths_follow_simple_imix():
    rng = np.random.default_rng(1)
    psdu = ip_mix.psdu_lengths(TRAFFIC, rng, 120_000)
    ip = psdu - TRAFFIC["overhead"]
    assert psdu.min() == 94 and psdu.max() == 1554
    assert np.mean(ip <= 120) == pytest.approx(7 / 12, abs=0.01)
    assert np.mean(ip == 1500) == pytest.approx(1 / 12, abs=0.005)
    assert np.mean((ip > 120) & (ip < 1500)) == pytest.approx(4 / 12, abs=0.01)


@pytest.mark.parametrize("mcs,lengths", [(0, [1554, 1552, 1553]), (3, [94, 96]),
                                         (7, [1200, 1210, 1190, 1205]), (5, [1])])
def test_transmit_is_vtx_frame_by_frame(mcs, lengths):
    rng = np.random.default_rng(mcs)
    psdus = [rng.integers(0, 256, n, dtype=np.uint8) for n in lengths]
    seeds = rng.integers(1, 128, len(lengths))
    bursts, points = ip_mix.transmit(psdus, mcs, seeds)
    for i, p in enumerate(psdus):
        b, pt = vtx.transmit(p[None], mcs, seeds[i: i + 1])
        assert np.array_equal(bursts[i], b[0]) and np.array_equal(points[i], pt[0])


def test_transmit_refuses_two_symbol_counts():
    with pytest.raises(ValueError):
        ip_mix.transmit([np.zeros(50, np.uint8), np.zeros(500, np.uint8)], 0, np.array([1, 2]))


def test_a_channel_is_filled_back_to_back():
    rng = np.random.default_rng(3)
    n = 16 * 262144
    start, mcs, length = ip_mix._layout(TRAFFIC, n, rng)
    ends = start + np.array([vtx.burst_len(int(m), int(ln)) for m, ln in zip(mcs, length)])
    gaps = start[1:] - ends[:-1]
    assert 580 <= start.size <= 660                    # about 2 490 frames a run on 4 channels
    assert gaps.min() >= TRAFFIC["gap"][0] and gaps.max() <= TRAFFIC["gap"][1]
    assert ends[-1] <= n - TRAFFIC["tail_margin"]
    assert set(mcs.tolist()) == set(TRAFFIC["mcs"])


def test_streams_repeat_their_seed():
    t = {**TRAFFIC, **TRAFFIC["rehearse"]}
    (pa, a), (_, b), (_, c) = (ip_mix.make_streams(t, 2, 4 * 8192, 8192, s)
                               for s in (SEED, SEED, SEED + 1))
    for x, y in zip(a, b):
        assert np.array_equal(x.x, y.x) and np.array_equal(x.start, y.start)
    assert not np.array_equal(a[0].x, c[0].x)
    s = a[0]
    for i in range(s.frames):              # the pool holds each frame's own bytes and points
        key = (int(s.mcs[i]), int(s.length[i]))
        assert pa.psdus[key][s.entry[i]].size == s.length[i]
        assert pa.points[key][s.entry[i]].shape == (vtx.n_sym(*key), 48)


def _run(wire=None):
    over = {"wire_format": wire} if wire else None
    return run.run_cell(CELL, SEED, 1.0, 0, rehearse=True, overrides=over)


def test_a_sound_run_passes():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0


def test_the_sc8_control_is_refused():
    res = _run(wire="sc8")
    assert not res["correct"]
    assert res["failed"] > 0 or any(c["value"] > c["limit"] for c in res["checks"].values())


def test_set_up_ends_the_cell_once_the_cache_has_evicted():
    from harness import wlan

    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.graphs import GraphCache

    graphs = GraphCache()
    graphs.captured = GraphCache.MAX_GRAPHS          # every graph still held
    wlan.resident(graphs)
    graphs.captured += 1
    with pytest.raises(SystemExit, match="cannot run the cell"):
        wlan.resident(graphs)
