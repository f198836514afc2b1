"""``correct`` on the CPU, at the rehearsal's sizes: a sound run of each
kind of cell is correct; its control and each fault it can have, planted
underneath the timed path (control.py's FAULTS), make it not correct.

    python -m pytest benchmark/test_benchmark_correct.py      (about 4 minutes)

Receiver cells: the control is the program's sc8 wire format (the next
precision below the configuration's sc16), which the SNR bias catches;
the faults are a byte altered where stage B decodes it and half of each
stage-B batch left out. Radio cells: the control sends every payload
twice (the exactly-once guarantee broken); the faults are a byte altered
where the radio produces the payload, half of each batch left out, and
the channel's noise 3 dB low or left out. No cell spans chips or trains,
so the exchange between chips and a state left unchanged are faults they
cannot have.
"""

from __future__ import annotations

import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import control  # noqa: E402
import run  # noqa: E402

RX, RADIO = "rx-adaptive-4ch.dense-mixed", "radio-mode2.bursty"
SEED = 2**31 + 11


def _run(cell, seconds=1.0, fault=None, **kw):
    system = "rx" if cell.startswith("rx-") else "radio"
    with control.planted(system, fault):
        return run.run_cell(cell, SEED, seconds, 0, rehearse=True, **kw)


@pytest.mark.parametrize("cell", [RX, "rx-adaptive-4ch.sparse-mcs2"])
def test_receiver_sound_run_and_its_control(cell):
    sound = _run(cell)
    assert sound["correct"] and sound["failed"] == 0 and sound["attempted"] > 0
    ctrl = _run(cell, overrides=control.CONTROLS["rx"])
    assert not ctrl["correct"]
    bias = ctrl["checks"]["snr_bias_db"]
    assert bias["value"] > bias["limit"] > sound["checks"]["snr_bias_db"]["value"]


@pytest.mark.parametrize("fault", ["alter", "half"])
def test_receiver_faults_make_the_run_not_correct(fault):
    res = _run(RX, fault=fault)
    assert not res["correct"] and res["failed"] > 0


def test_radio_sound_run_and_its_control():
    sound = _run(RADIO, seconds=2.0)
    assert sound["correct"] and sound["failed"] == 0 and sound["attempted"] > 0
    gap = sound["checks"]["channel_snr_gap_db"]
    assert gap["value"] < gap["limit"]
    ctrl = _run(RADIO, seconds=2.0, overrides=control.CONTROLS["radio"])
    assert not ctrl["correct"] and ctrl["checks"]["pieces_duplicated"]["value"] > 0


@pytest.mark.parametrize("fault,check", [("alter", "pieces_corrupt"), ("half", "pieces_lost"),
                                         ("quiet-3db", "channel_snr_gap_db"),
                                         ("no-noise", "channel_snr_gap_db")])
def test_radio_faults_make_the_run_not_correct(fault, check):
    res = _run(RADIO, seconds=2.0, fault=fault)
    c = res["checks"][check]
    assert not res["correct"] and c["value"] > c["limit"]
