"""The radio cells' load generator and receiving socket, a process of its own.

It imports neither torch nor the program. It makes the pieces from the
seed, binds the receiving socket on a free localhost port and prints
``{"recv_port": ..., "payload_lengths": [...]}``. Then it takes commands,
one JSON object a line on standard input:

    {"cmd": "target", "port": p}     send to the radio at localhost:p
    {"cmd": "phase", "t0": t, "rate": r, "seconds": s, "pattern": "steady",
     "burst": 1, "wait_s": 60}       one window, see below
    {"cmd": "quit"}

A phase offers round(r x s) pieces, cycling through the image's pieces,
each due at t (on the system-wide monotonic clock, ``time.monotonic``)
plus its offset in the schedule; a piece is sent at its due time or, when
the generator runs late, at once: the schedule never slows for the radio.
One thread sends and receives (select with a timeout up to a millisecond
before the next due time, then polling, since a wake-up from a sleep
comes late), so sends leave on time and arrival times are taken as the
datagrams land. After the last
due time it waits until every piece has arrived, ``wait_s`` at most. Each
arrival is held to the bytes sent: it takes the earliest outstanding send
of the same bytes (the image repeats every lap); bytes that no piece
carries are corrupt, and bytes of a piece with no outstanding send are a
duplicate. A piece's latency runs from its due time to its arrival; a
piece that never arrives counts as failed. The phase's result is one JSON
line on standard output.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import pathlib
import select
import socket
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from yardstick import pieces  # noqa: E402

RCVBUF_BYTES = 16 * 1024 * 1024
SPIN_S = 0.001       # the last stretch before a due time is polled, not slept: a wake-up is late


def _drain(sock, out: list) -> None:
    while True:
        try:
            data = sock.recv(65536)
        except BlockingIOError:
            return
        out.append((time.monotonic(), data))


def phase(send, rsock, target, dgrams, payloads, cmd) -> dict:
    n = int(round(cmd["rate"] * cmd["seconds"]))
    t0 = float(cmd["t0"])
    due = t0 + pieces.schedule(n, float(cmd["rate"]), cmd["pattern"], int(cmd.get("burst", 1)))
    sent = np.empty(n)
    arrivals: list = []
    i = 0
    while i < n:
        now = time.monotonic()
        if now >= due[i]:
            send.sendto(dgrams[i % len(dgrams)], target)
            sent[i] = time.monotonic()
            i += 1
            continue
        if select.select([rsock], [], [], max(due[i] - now - SPIN_S, 0.0))[0]:
            _drain(rsock, arrivals)
    deadline = due[-1] + float(cmd.get("wait_s", 60.0)) if n else time.monotonic()
    outstanding = collections.defaultdict(collections.deque)
    for k in range(n):
        outstanding[payloads[k % len(payloads)]].append(k)
    arrived = np.full(n, np.nan)
    corrupt = dup = early = 0
    known = set(payloads)

    def settle(batch):
        nonlocal corrupt, dup, early
        for t, data in batch:
            if t < t0:
                early += 1               # warm-up traffic of the set-up
            elif data not in known:
                corrupt += 1
            elif outstanding[data]:
                arrived[outstanding[data].popleft()] = t
            else:
                dup += 1

    settle(arrivals)
    while np.isnan(arrived).any() and time.monotonic() < deadline:
        if select.select([rsock], [], [], min(0.05, max(deadline - time.monotonic(), 0)))[0]:
            batch: list = []
            _drain(rsock, batch)
            settle(batch)
    quiet = time.monotonic() + 0.3                # stragglers: duplicates or corrupt
    while time.monotonic() < quiet:
        if select.select([rsock], [], [], 0.05)[0]:
            batch = []
            _drain(rsock, batch)
            settle(batch)
    lat = (arrived - due) * 1e3
    lost = int(np.isnan(arrived).sum())
    full = np.where(np.isnan(lat), np.inf, lat)
    late = (sent - due) * 1e3
    tenth = max(n // 10, 1)
    ok = lat[~np.isnan(lat)]

    def pct(a, q):
        v = float(np.percentile(a, q)) if a.size else float("nan")
        return v if np.isfinite(v) else None

    return {"attempted": n, "delivered": n - lost, "lost": lost, "corrupt": corrupt,
            "duplicated": dup, "early": early,
            "lat_p50_ms": pct(full, 50), "lat_p95_ms": pct(full, 95),
            "lat_max_ms": float(ok.max()) if ok.size else None,
            "lat_p50_first_tenth_ms": pct(full[:tenth], 50),
            "lat_p50_last_tenth_ms": pct(full[-tenth:], 50),
            "late_p50_ms": float(np.median(late)) if n else None,
            "late_max_ms": float(late.max()) if n else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--image", type=int, nargs=3, required=True)
    ap.add_argument("--piece", type=int, nargs=2, required=True)
    ap.add_argument("--cpu", type=int, default=None, help="the one core this process runs on")
    args = ap.parse_args()
    if args.cpu is not None:
        os.sched_setaffinity(0, {args.cpu})
    dgrams, payloads = pieces.make_pieces(args.image, args.piece, args.seed)
    gc.freeze()
    rsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rsock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
    rsock.bind(("127.0.0.1", 0))
    rsock.setblocking(False)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    target = None
    try:
        print(json.dumps({"recv_port": rsock.getsockname()[1],
                          "payload_lengths": sorted({len(d) for d in dgrams})}), flush=True)
        for line in sys.stdin:
            cmd = json.loads(line)
            if cmd["cmd"] == "target":
                target = ("127.0.0.1", int(cmd["port"]))
            elif cmd["cmd"] == "phase":
                gc.disable()          # no collector pause inside the instrument's clock
                try:
                    res = phase(send, rsock, target, dgrams, payloads, cmd)
                finally:
                    gc.enable()
                    gc.collect()
                print(json.dumps(res), flush=True)
            elif cmd["cmd"] == "quit":
                break
    finally:
        rsock.close()
        send.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
