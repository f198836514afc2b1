"""The port's observability (utils/tracing.py) against the JAX package's:
the Tracer's summary and reset, the three GUI-sink probes on the same
numpy input (equal outputs: both run the same numpy arithmetic), and the
torch.profiler scope. The port's own: ``Tracer.add`` and a prefixed
Tracer's stages as profiler ranges."""

import json
import pathlib

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.utils import tracing as jtracing
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

torch.set_num_threads(2)


def test_tracer_counts_summary_and_reset():
    tr = tracing.Tracer()
    with tr.stage("demod", samples=1000, frames=2):
        pass
    tr.count("demod", samples=500)
    rep = tr.report()
    assert rep["demod"].samples == 1500
    assert rep["demod"].frames == 2
    assert rep["demod"].calls == 2
    assert rep["demod"].throughput_msps() > 0
    assert tracing.StageStats().throughput_msps() == 0.0
    assert "demod" in tr.summary()
    # the same table as the JAX Tracer's for the same counts
    jt = jtracing.Tracer()
    jt.count("demod", samples=1500, frames=2, calls=2)
    tr.reset()
    assert tr.report() == {}
    tr.count("demod", samples=1500, frames=2, calls=2)
    assert tr.summary() == jt.summary()
    assert tracing.default_tracer() is tracing.default_tracer()


def test_tracer_add_attributes_a_duration_measured_elsewhere():
    tr = tracing.Tracer()
    tr.add("queue", 0.25, frames=3)
    tr.add("queue", 0.5, samples=7, frames=1, calls=2)
    tr.count("queue", frames=1, calls=0)
    q = tr.report()["queue"]
    assert (q.calls, q.seconds, q.samples, q.frames) == (3, 0.75, 7, 5)


def _ranges(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def test_prefixed_stage_is_a_range_inside_the_callers_under_a_profiler():
    tr = tracing.Tracer(prefix="radio")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            with tr.stage("fetch", frames=2):
                torch.ones(8).sum()
    (outer,), (fetch,) = _ranges(prof, "outer"), _ranges(prof, "radio.")
    assert fetch.name == "radio.fetch"
    assert outer.time_range.start <= fetch.time_range.start
    assert fetch.time_range.end <= outer.time_range.end
    assert any(e.name == "aten::sum" and fetch.time_range.start <= e.time_range.start
               and e.time_range.end <= fetch.time_range.end for e in prof.events())
    st = tr.report()["fetch"]
    assert (st.calls, st.frames) == (1, 2) and st.seconds > 0


def test_stage_opens_no_range_without_a_profiler_or_a_prefix(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with tracing.Tracer(prefix="radio").stage("fetch"):        # no profiler
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.Tracer().stage("fetch"):                  # no prefix
            pass
    assert opened == []
    assert not [e for e in prof.events() if "fetch" in e.name]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.Tracer(prefix="radio").stage("fetch"):
            pass
    assert opened == ["radio.fetch"]


def _qpsk(rng, n, snr_db):
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    s = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    return s + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def test_snr_probe_matches_jax():
    rng = np.random.default_rng(1)
    probe, jprobe = tracing.SnrProbe(alpha=0.05), jtracing.SnrProbe(alpha=0.05)
    assert np.isnan(probe.snr_db()) and np.isnan(jprobe.snr_db())
    for _ in range(200):
        s = _qpsk(rng, 256, 15.0)
        est = probe.update(s)
        assert est == jprobe.update(s)
    assert abs(est - 15.0) < 2.0, est


def test_constellation_probe_matches_jax():
    p, jp = tracing.ConstellationProbe(capacity=8), jtracing.ConstellationProbe(capacity=8)
    for chunk in (np.arange(5) + 1j * np.arange(5), np.arange(5, 11) + 0j,
                  np.arange(20) * (1 - 1j), np.array([], np.complex64)):
        p.push(chunk)
        jp.push(chunk)
        for n in (None, 3, 100):
            assert np.array_equal(p.points(n), jp.points(n))
    pts = p.points()
    assert pts.shape == (8, 2) and pts.dtype == np.float32
    np.testing.assert_allclose(pts[:, 0], np.arange(12, 20))


def test_constellation_probe_is_empty_before_a_push():
    """An empty probe holds no points. The JAX package's returns the whole
    zeroed ring there (``[-0:]`` in its ``points``), so an RF panel with the
    probes off shows 512 points at the origin; the port does not."""
    p = tracing.ConstellationProbe(capacity=8)
    assert p.points().shape == (0, 2) and p.points(512).shape == (0, 2)
    assert jtracing.ConstellationProbe(capacity=8).points().shape == (8, 2)
    p.push(np.array([1 + 2j, 3 + 4j]))
    np.testing.assert_array_equal(p.points(512), [[1, 2], [3, 4]])
    assert p.points(0).shape == (0, 2)


def test_spectrum_probe_matches_jax():
    p, jp = tracing.SpectrumProbe(nfft=256, alpha=0.5), jtracing.SpectrumProbe(nfft=256, alpha=0.5)
    assert np.array_equal(p.psd_db(), jp.psd_db())
    assert np.all(p.psd_db() <= -199)      # empty floor
    n = np.arange(4096)
    rng = np.random.default_rng(2)
    for x in (np.exp(2j * np.pi * 0.125 * n).astype(np.complex64),
              rng.standard_normal(1000) + 1j * rng.standard_normal(1000),
              np.ones(100, np.complex64)):           # shorter than nfft: ignored
        p.update(x)
        jp.update(x)
        assert np.array_equal(p.psd_db(), jp.psd_db())
    # fftshifted: +fs/8 lands at bin nfft/2 + nfft/8
    assert int(np.argmax(p.psd_db())) == 256 // 2 + 256 // 8


def test_profile_none_is_a_noop():
    with tracing.profile(None) as prof:
        torch.ones(4).sum()
    assert prof is None


def test_profile_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tracing.profile(str(logdir)):
        with torch.profiler.record_function("executor.test"):
            (torch.arange(64.0) * 2).sum()
    files = list(pathlib.Path(logdir).glob("torch_trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "executor.test" in names


def test_evm_snr_db_tracks_noise():
    """The executors' per-frame metric, as tests/test_tracing.py checks
    the JAX one."""
    rng = np.random.default_rng(0)
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import mapping

    bits = torch.from_numpy(rng.integers(0, 2, (4, 6 * 48), dtype=np.uint8))
    clean = mapping.map_bits(bits, 0).reshape(4, 6, 48).numpy()
    for snr_db in (10.0, 25.0):
        sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
        noise = sigma * (rng.standard_normal(clean.shape) + 1j * rng.standard_normal(clean.shape))
        est = tracing.evm_snr_db(torch.from_numpy((clean + noise).astype(np.complex64)), 0)
        assert est.shape == (4,)
        assert bool((est - snr_db).abs().max() < 2.0), (snr_db, est)


# parameters the port adds after the JAX package's, each with a default
PORT_ONLY_PARAMETERS = {"Tracer": ["prefix"]}


@pytest.mark.parametrize("name", ["SnrProbe", "ConstellationProbe", "SpectrumProbe",
                                  "Tracer", "StageStats", "profile", "default_tracer"])
def test_tracing_api_matches_jax(name):
    import inspect

    ours, theirs = getattr(tracing, name), getattr(jtracing, name)
    params = inspect.signature(ours).parameters
    extra = PORT_ONLY_PARAMETERS.get(name, [])
    assert list(params) == list(inspect.signature(theirs).parameters) + extra
    assert all(params[p].default is not inspect.Parameter.empty for p in extra)
    if inspect.isclass(ours):
        public = {n for n in dir(theirs) if not n.startswith("_")}
        assert public <= set(dir(ours)), public - set(dir(ours))
