"""The controls of ``correct``, its planted faults, and the program's own
readings, over many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] \
        --seconds <s> [--program | --fault <name>] [--rehearse]

Each seed is a whole cell (set-up, a window of ``--seconds``, the
reference check) through ``run.run_cell``, at the cell's own sizes, with
the cell's control switched on, unless ``--program`` runs the program as
configured or ``--fault`` plants one of FAULTS underneath the timed path:

    receiver cells   control: the program's own next lower precision, the
                     sc8 wire format (int8 I/Q) in place of the
                     configuration's sc16. Faults: "alter", a byte of each
                     stage-B bucket's first frame altered where it is
                     decoded; "half", half of each stage-B batch left out.
    radio cells      the configuration states no precision, so the control
                     breaks its exactly-once guarantee: the sink sends
                     every payload twice. Faults: "alter", a byte of each
                     payload altered where the radio hands it to its sink;
                     "half", the second half of each batch left out;
                     "quiet-3db", the channel's noise 3 dB below its
                     voltage; "no-noise", the channel's noise left out.

It prints one JSON line a seed: the seed, what was switched on,
``correct``, the attempted and failed counts, and every number compared
with its limit. The benchmark's own runs switch none of them on. Needs the
card unless ``--rehearse``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
from unittest import mock

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402
from harness import common  # noqa: E402

CONTROLS = {"rx": {"wire_format": "sc8"}, "radio": {"control": "twice"}}


def _rx_alter(orig):
    def finish(self, bucket, plan, packed):
        recs = orig(self, bucket, plan, packed)
        if recs:
            recs[0].psdu = recs[0].psdu.copy()
            recs[0].psdu[0] ^= 0x5A
        return recs
    return finish


def _rx_half(orig):
    return lambda self, stream, cands: orig(self, stream, cands[: len(cands) // 2])


def _radio_alter(orig):
    return lambda self, p: orig(self, p[:-1] + bytes([p[-1] ^ 0x5A]))


def _radio_half(orig):
    return lambda self, payloads: orig(self, payloads[: (len(payloads) + 1) // 2])


def _noise_scaled(factor):
    return lambda orig: (lambda generator, x, noise_voltage=1.0:
                         orig(generator, x, noise_voltage * factor))


def _no_noise(orig):
    return lambda generator, x, noise_voltage=1.0: x


# fault -> [(module, attribute path, wrapper of the original)]
FAULTS = {
    "rx": {
        "alter": [("parallel.executor", "AdaptiveStreamExecutor._finish_bucket", _rx_alter)],
        "half": [("parallel.executor", "AdaptiveStreamExecutor._stage_b_dispatch", _rx_half)],
    },
    "radio": {
        "alter": [("runtime.bridge", "UdpSink.send_mac_payload", _radio_alter),
                  ("runtime.bridge", "NativeExtractSink.send_mac_payload", _radio_alter)],
        "half": [("runtime.bridge", "LoopbackRadio._process", _radio_half)],
        "quiet-3db": [("channel.model", "awgn", _noise_scaled(10 ** (-3 / 20)))],
        "no-noise": [("channel.model", "awgn", _no_noise)],
    },
}


@contextlib.contextmanager
def planted(system: str, fault: str | None):
    """The program with ``fault`` planted in its classes or modules for
    the block, or as it is for None."""
    with contextlib.ExitStack() as stack:
        for module, path, wrap in FAULTS[system][fault] if fault else ():
            mod = __import__(f"gnuradio_wifi_imagetransfer_tpu_torch.{module}",
                             fromlist=["_"])
            *owner, name = path.split(".")
            obj = mod
            for part in owner:
                obj = getattr(obj, part)
            stack.enter_context(mock.patch.object(obj, name, wrap(getattr(obj, name))))
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--program", action="store_true", help="the program as configured")
    ap.add_argument("--fault", default=None, help="a fault of FAULTS, planted")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    _, conf, _ = common.cell(common.bench(), args.workload)
    system = conf["system"]
    overrides = None if args.program or args.fault else CONTROLS[system]
    cpus = None if args.rehearse else common.cpu_plan()
    if cpus:
        common.pin(cpus["rest"])
    for seed in args.seeds:
        with planted(system, args.fault):
            res = run.run_cell(args.workload, seed, args.seconds, 0, rehearse=args.rehearse,
                               overrides=overrides, cpus=cpus)
        print(json.dumps({"seed": seed, "control": overrides, "fault": args.fault,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"],
                          "info": res["extra"]["info"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
