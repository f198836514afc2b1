"""rx.captures: CUDA graphs the executor's GraphCache captured inside the
window (each one a stall; the warm-up should leave none). Moves
rx_msamples_per_s."""


def read(ctx):
    return ctx.get("captures")
