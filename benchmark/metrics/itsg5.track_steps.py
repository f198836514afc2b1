"""itsg5.track_steps: the data symbols the tracker equalizes a run, from
the executor's ``track`` counter over the window (the frames of each
stage-B bucket times its data symbols). Nothing where the program keeps
no such counter. Moves rx_msamples_per_s."""


def read(ctx):
    return ctx.get("track_steps")
