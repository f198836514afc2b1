"""wlan.pad_share: stage B's padding in the WLAN cell, %: 1 - the frames'
own data symbols (Tracer counter ``stage_b_symbols``) over the symbol
slots the buckets decode (``stage_b_slots``: padded rows x each bucket's
class symbols), over the window. Nothing where the program keeps no such
counters. Moves rx_msamples_per_s."""


def read(ctx):
    slots, symbols = ctx.get("stage_b_slots"), ctx.get("stage_b_symbols")
    if slots is None or symbols is None or not slots.samples:
        return None
    return 100.0 * (1.0 - symbols.samples / slots.samples)
