"""radio.batch_size: datagrams a LoopbackRadio._process call takes from
the host socket source (runtime/native.py drain), the mean over the
window's calls. Moves piece_latency_p95_ms."""


def read(ctx):
    sizes = ctx.get("batch_sizes") or []
    return sum(sizes) / len(sizes) if sizes else None
