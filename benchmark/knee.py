"""Find the radio's knee: the highest offered rate at which every piece
arrives and the backlog does not grow.

    python3 benchmark/knee.py --workload radio-mode2.bursty --seed <n> \
        --rates 1000 1250 ... --seconds 10 [--out knee.json]

One set-up (the radio and its graphs, as a run of the cell makes it),
then one phase a rate, in order, through the same radio and load
process, with the pieces at fixed spacing whatever the cell's pattern. Each phase prints one JSON line: the rate, the pieces offered,
delivered, lost, corrupt and duplicated, the latency's p50 and p95 over
all pieces, the p50 of the first and of the last tenth of the pieces (a
backlog that grows shows as the last tenth far above the first), and how
late the generator ran. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import common  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--wait", type=float, default=5.0,
                    help="seconds a phase waits past its last due time for missing pieces")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = common.bench()
    work, conf, traffic = common.cell(spec, args.workload)
    cpus = common.cpu_plan()
    if cpus:
        common.pin(cpus["rest"])
    common.require_cards(int(work["chips"]))
    from harness import radio

    cell = radio.Cell(work, {**conf, "wait_s": args.wait}, traffic, args.seed, rehearse=False,
                      cpus=cpus)
    rows = []
    try:
        cell.setup()
        for rate in args.rates:
            t = time.perf_counter()
            res = cell.phase(rate, args.seconds, pattern="steady")
            res.update(rate=rate, phase_s=time.perf_counter() - t)
            rows.append(res)
            print(json.dumps(res), flush=True)
    finally:
        cell.release()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
