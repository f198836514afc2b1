"""rx.dispatch_ms: host dispatch a run, ms: the Tracer's ``collect`` (the
candidate loop, _collect_candidates) and ``stage_b`` (bucketing and
_dispatch_bucket's launches) over the window's runs. Moves
rx_msamples_per_s."""


def read(ctx):
    st, runs = ctx.get("stages") or {}, ctx.get("runs")
    if not runs or "collect" not in st:
        return None
    return 1e3 * (st["collect"] + st.get("stage_b", 0.0)) / runs
