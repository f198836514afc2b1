"""radio.captures: CUDA graphs the radio's GraphCache captured inside the
window (each one a stall; the warm-up should leave none). Moves
piece_latency_p95_ms."""


def read(ctx):
    return ctx.get("captures")
