"""The port's root scripts on the CPU: demo_torch.py recovers the canvas,
tune_equalizer_torch.py gives tune_equalizer.py's PER for every setting
when both decode the same noisy samples, and scaling_report_torch.py runs
its legs over 2 gloo processes and prints its result line. Every
subprocess has its own timeout."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gnuradio_wifi_imagetransfer_tpu.phy import rx as jrx

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_recovers_the_canvas(tmp_path):
    """demo_torch.py --device cpu --size 48: every piece through the port's
    SenderApp, LoopbackRadio and ReceiverApp; the written canvas is the
    resized image, bit for bit."""
    from PIL import Image

    r = subprocess.run([sys.executable, str(REPO / "demo_torch.py"), "--device", "cpu",
                        "--size", "48", "--timeout", "100"], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "converged bit-exact" in r.stdout
    img = np.asarray(Image.open(REPO / "assets" / "kodim01.png").convert("RGB"), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((48, 48)), dtype=np.uint8)
    got = np.asarray(Image.open(tmp_path / "demo_received.png"))
    assert np.array_equal(got, want)


def test_tune_equalizer_gives_jax_per_on_the_same_samples():
    """2 frames: the port's scenarios built with JAX's AWGN draws are JAX's
    noisy samples (within 1e-6), and the sweep on them gives JAX's decode's
    PER for every LMS and STA setting on every scenario."""
    jt, pt = _load("tune_equalizer"), _load("tune_equalizer_torch")
    psdu, scen = jt.build_scenarios(2)
    bursts = np.asarray(jt.tx.transmit(jnp.asarray(psdu), jt.MCS,
                                       scrambler_seed=jnp.arange(2) % 127 + 1))
    noise = {name: scen[name] - np.stack([jt.fading_burst(b, np.random.default_rng(100 + i), w)
                                          for i, b in enumerate(bursts)])
             for name, w in pt.SCENARIOS}
    ppsdu, pscen = pt.build_scenarios(2, "cpu", noise=noise)
    assert np.array_equal(ppsdu, psdu) and list(pscen) == list(scen)
    for name in scen:
        np.testing.assert_allclose(pscen[name].numpy(), scen[name], atol=1e-6, rtol=0)
    got = pt.sweep(ppsdu, pscen, log=lambda s: None)

    plan = jt.tx.tx_plan(jt.MCS, jt.PSDU_L)
    ys = jnp.asarray(np.concatenate(list(scen.values())))
    decode = {a: jax.jit(lambda y, g, a=a: jrx.decode_aligned(y, plan, start=0, algo=a, **g).psdu)
              for a in (jt.ChannelEstimator.LMS, jt.ChannelEstimator.STA)}

    def jper(algo, **gains):
        out = np.asarray(decode[algo](ys, {k: jnp.float32(v) for k, v in gains.items()}))
        wrong = (out.reshape(len(scen), *psdu.shape) != psdu).any(axis=-1).mean(axis=-1)
        return dict(gains, **{n: float(v) for n, v in zip(scen, wrong)})

    assert got["lms"] == [jper(jt.ChannelEstimator.LMS, lms_mu=mu) for mu in pt.LMS_MU]
    assert got["sta"] == [jper(jt.ChannelEstimator.STA, sta_alpha=a, sta_beta=b)
                          for a in pt.STA_GAINS for b in pt.STA_GAINS]
    assert {row["static"] for row in got["lms"]} == {0.0}


def test_scaling_report_runs_two_gloo_processes(tmp_path):
    """scaling_report_torch.py --device cpu --procs 2 at small settings: the
    fixed and adaptive legs over 2 gloo ranks and the pod leg, every frame
    back bit-exact, the result in --out and on the last line."""
    out = tmp_path / "scaling.json"
    r = subprocess.run([sys.executable, str(REPO / "scaling_report_torch.py"), "--device", "cpu",
                        "--procs", "2", "--channels", "1", "--block", "16384", "--iters", "2",
                        "--adaptive-block", "8192", "--pod-channels", "4", "--pod-block", "8192",
                        "--timeout", "100", "--out", str(out)],
                       cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == json.loads(out.read_text())
    assert last["backend"] == "gloo" and last["device"] == "cpu"
    fixed, adaptive, pod = last["fixed"]["2"], last["adaptive"]["2"], last["pod"]
    assert fixed["bitexact"] == fixed["frames"] == 4 and fixed["msps"] > 0
    assert adaptive["bitexact"] == adaptive["frames"] > 0
    assert pod["frames_bitexact"] == pod["frames"] == 8 and 0 <= pod["collect_share"] <= 1
