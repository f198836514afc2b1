"""rx.staging_ms: host staging a run, ms: the Tracer's ``layout`` (the
executor's _pad_wire, quantizing the stream into the wire buffer) and
``transfer`` (its upload) over the window's runs. Moves rx_msamples_per_s."""


def read(ctx):
    st, runs = ctx.get("stages") or {}, ctx.get("runs")
    if not runs or "layout" not in st:
        return None
    return 1e3 * (st["layout"] + st.get("transfer", 0.0)) / runs
