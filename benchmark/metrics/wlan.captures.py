"""wlan.captures: CUDA graphs the executor's GraphCache captured inside
the WLAN cell's window (each one a stall; the warm-up over every stream
should leave none). Moves rx_msamples_per_s."""


def read(ctx):
    return ctx.get("captures")
