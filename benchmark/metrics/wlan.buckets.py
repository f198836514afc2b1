"""wlan.buckets: stage-B buckets a run in the WLAN cell: the calls of the
executor's Tracer counter ``stage_b_slots`` (one a dispatched bucket) over
the window's runs. Nothing where the program keeps no such counter. Moves
rx_msamples_per_s."""


def read(ctx):
    slots, runs = ctx.get("stage_b_slots"), ctx.get("runs")
    if slots is None or not runs:
        return None
    return slots.calls / runs
