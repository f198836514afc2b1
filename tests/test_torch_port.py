"""The PyTorch port's package rules, wire formats, carried-over state and TX,
held against the JAX package on the CPU."""

import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import config as jconfig
from gnuradio_wifi_imagetransfer_tpu.phy import params as jparams
from gnuradio_wifi_imagetransfer_tpu.phy import tx as jtx
from gnuradio_wifi_imagetransfer_tpu.utils import xfer as jxfer
from gnuradio_wifi_imagetransfer_tpu_torch import config, state
from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
    AdaptiveReceiver,
    AdaptiveStreamExecutor,
    StreamExecutor,
    make_mesh,
)
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import HALO_LEFT
from gnuradio_wifi_imagetransfer_tpu_torch.phy import equalizer, sync, tx
from gnuradio_wifi_imagetransfer_tpu_torch.utils import device, xfer

torch.set_num_threads(2)


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of the port, chip_smoke.py and the port's root scripts
    load with jax blocked and pull in no module of the JAX package (names
    compared exactly: the port's own name starts with the same string)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import gnuradio_wifi_imagetransfer_tpu_torch as port
        for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke, demo_torch, scaling_report_torch, tune_equalizer_torch
        bad = [n for n, m in sys.modules.items() if m is not None and (
               n == "gnuradio_wifi_imagetransfer_tpu"
               or n.startswith("gnuradio_wifi_imagetransfer_tpu.")
               or n == "jax" or n.startswith("jax."))]
        assert not bad, bad
        new = {port.__name__ + "." + m for m in (
            "channel", "channel.model", "phy.mac", "parallel.adaptive", "parallel.executor",
            "runtime.bridge", "runtime.native", "utils.image", "utils.tracing",
            "models.layers", "models.rcb", "models.afb", "models.encoder", "models.decoder",
            "models.weights", "models.jsce", "utils.metrics", "runtime.apps",
            "runtime.socket_demo", "runtime.misc_demos", "control", "control.dqn_irs",
            "models.pos_embed", "models.vit", "models.mae", "models.swin", "models.vit_codec",
            "models.csa", "models.gnn", "models.propagnet", "models.vae", "parallel.mesh")}
        assert new <= set(sys.modules), new - set(sys.modules)
        print("OK", len([n for n in sys.modules if n.startswith(port.__name__)]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


@pytest.mark.parametrize("wire", ["f32", "sc16", "sc8"])
def test_from_wire_is_exact(wire):
    rng = np.random.default_rng(7)
    x = (0.5 * (rng.standard_normal(4000) + 1j * rng.standard_normal(4000))).astype(np.complex64)
    w = jxfer.quantize_wire(jxfer.to_riq(x), wire)
    assert np.array_equal(xfer.quantize_wire(xfer.to_riq(x), wire), w)
    want = np.asarray(jxfer.from_wire(jnp.asarray(w)))
    got = xfer.from_wire(torch.from_numpy(w)).numpy()
    assert got.dtype == want.dtype == np.complex64
    assert np.array_equal(got, want)


def _jax_cfg(**executor):
    return {"phy": dataclasses.asdict(jconfig.PhyConfig()),
            "executor": dataclasses.asdict(jconfig.ExecutorConfig(**executor))}


def test_load_reference_state_accepts_the_jax_tables():
    arrays = state.reference_arrays(jparams)
    phy, ex = state.load_reference_state(arrays, _jax_cfg(wire_format="sc16", block_size=4096))
    assert phy == config.PhyConfig()
    assert isinstance(phy.encoding, config.Encoding)
    assert ex == config.ExecutorConfig(wire_format="sc16", block_size=4096)
    assert len(arrays) > 40


def test_load_reference_state_converts_the_frontend_config():
    fe = dict(resample=(3, 4), ppm=-12.5, sub_block=256)
    cfg = _jax_cfg(frontend=jconfig.FrontendConfig(**fe))
    _, ex = state.load_reference_state(state.reference_arrays(jparams), cfg)
    assert ex == config.ExecutorConfig(frontend=config.FrontendConfig(**fe))


def test_load_reference_state_rejects_a_changed_table():
    arrays = state.reference_arrays(jparams)
    arrays["POLARITY"] = arrays["POLARITY"].copy()
    arrays["POLARITY"][5] *= -1
    with pytest.raises(ValueError, match="POLARITY"):
        state.load_reference_state(arrays, _jax_cfg())
    arrays = state.reference_arrays(jparams)
    arrays["conv_tables/prev_state"] = arrays["conv_tables/prev_state"].astype(np.int64)
    with pytest.raises(ValueError, match="prev_state"):
        state.load_reference_state(arrays, _jax_cfg())


def test_unported_options_raise():
    """Every option is ported; the mesh refuses what the JAX package's
    refuses: a span that leaves no trusted stride interval
    (tests/test_executor.py:154-165) and a general-ratio front-end, which
    runs in local mode only (the JAX package raises at the run); every
    channel estimator runs."""
    plan = tx.tx_plan(2, 50)
    mesh = make_mesh(channels=1, time_shards=1)
    too_small = sync.window_len(plan.n_sym) + HALO_LEFT      # span == halo total
    with pytest.raises(ValueError, match="trusted"):
        StreamExecutor(plan, mesh=mesh, device="cpu", exec_cfg=config.ExecutorConfig(
            block_size=too_small, time_shards=1))
    with pytest.raises(ValueError, match="trusted"):
        AdaptiveStreamExecutor(mesh=mesh, device="cpu", exec_cfg=config.ExecutorConfig(
            block_size=sync.window_len(0) - sync.MARGIN + HALO_LEFT))
    StreamExecutor(plan, mesh=mesh, device="cpu", exec_cfg=config.ExecutorConfig(
        block_size=too_small + 1, time_shards=1))
    general = config.ExecutorConfig(frontend=config.FrontendConfig(resample=(3, 4)))
    with pytest.raises(ValueError, match="general rational"):
        StreamExecutor(plan, mesh=mesh, exec_cfg=general, device="cpu")
    with pytest.raises(ValueError, match="general rational"):
        AdaptiveStreamExecutor(mesh=mesh, exec_cfg=general, device="cpu")
    StreamExecutor(plan, exec_cfg=general, device="cpu")            # local mode takes it
    h = torch.ones(1, 52, dtype=torch.complex64)
    for algo in config.ChannelEstimator:
        eq, csi = equalizer.equalize(torch.ones(1, 2, 64, dtype=torch.complex64), h, algo=algo)
        assert eq.shape == csi.shape == (1, 2, 48)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.transmit(np.zeros((1, 10), np.uint8), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        AdaptiveStreamExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        AdaptiveReceiver()


@pytest.mark.parametrize("mcs", range(8))
def test_transmit_matches_jax(mcs):
    rng = np.random.default_rng(mcs)
    frames = rng.integers(0, 256, (3, 23 + 11 * mcs), dtype=np.uint8)
    seeds = np.array([1, 64, 127])
    want = np.asarray(jtx.transmit(jnp.asarray(frames), mcs,
                                   scrambler_seed=jnp.asarray(seeds)))
    got = tx.transmit(frames, mcs, scrambler_seed=torch.as_tensor(seeds), device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape
    # float32 IFFTs of two libraries: a few ulps of the unit-scale samples
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    plan, jplan = tx.tx_plan(mcs, frames.shape[1]), jtx.tx_plan(mcs, frames.shape[1])
    assert (plan.n_sym, plan.n_samples, plan.n_pad_bits) == (
        jplan.n_sym, jplan.n_samples, jplan.n_pad_bits)


@pytest.mark.parametrize("kernel", ["sync_stats", "viterbi_decode"])
def test_wrappers_use_the_plain_version_only_for_cpu_tensors(kernel):
    """A CPU tensor goes through the plain version (no launch counted); a
    tensor on another non-CUDA device is refused, never computed plainly."""
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats, viterbi_acs

    if kernel == "sync_stats":
        fn, plain, x = (sync_stats.sync_stats, sync_stats.sync_stats_plain,
                        torch.ones(2, 300, dtype=torch.complex64))
    else:
        fn, plain, x = (viterbi_acs.viterbi_decode, viterbi_acs.viterbi_decode_plain,
                        torch.linspace(-1, 1, 2 * 30 * 2).reshape(2, 30, 2))
    before = fn.launches
    got, want = fn(x), plain(x)
    if kernel == "sync_stats":
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert torch.equal(got, want)
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x.to("meta"))
