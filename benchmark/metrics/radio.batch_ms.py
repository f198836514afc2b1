"""radio.batch_ms: host time of one LoopbackRadio._process call, ms
(framing, staging, the groups' replays and fetches, parse, sends), the
mean over the window's calls, from a benchmark span wrapped around the
bound method. Moves piece_latency_p95_ms."""


def read(ctx):
    spans = ctx.get("batch_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
