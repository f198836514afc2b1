"""The port covers the JAX package's whole public surface.

Both packages are parsed by AST and neither is imported for that: every
public top-level function or class of every module of
``gnuradio_wifi_imagetransfer_tpu/`` must exist in the port's module of the
same path, or stand in ``NAME_MAP`` with a counterpart that exists. Every
root script of the JAX side must have its twin. Then ``demap_hard``, the
last public modem function to be ported, against JAX's."""

import ast
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "gnuradio_wifi_imagetransfer_tpu"
PORT_PKG = ROOT / "gnuradio_wifi_imagetransfer_tpu_torch"

# The JAX package's Pallas files and the port's modules of their kernels.
PALLAS = {
    "ops/pallas_sync.py": "ops/sync_stats.py",
    "ops/pallas_viterbi.py": "ops/viterbi_acs.py",
    "ops/pallas_fir.py": "ops/fir.py",
}

# Each public name of the JAX package that the port's module of the same
# path does not define -> (its counterpart, why). A counterpart is
# "<file>:<name>[.<attribute>]", the file under the port package or, for a
# root script, under the repo root; or "torch:<attribute path>" where the
# port uses PyTorch's own.
NAME_MAP = {
    "phy/rx.py:jitted_decode_aligned": (
        "phy/rx.py:decode_aligned", "eager torch compiles nothing: decode_aligned serves "
                                    "every (MCS, length, algo) as it is"),
    "phy/mac.py:crc32_jax": ("phy/mac.py:crc32", "the batched byte-table CRC-32"),
    "utils/xfer.py:to_host": ("torch:Tensor.numpy", "a tensor's .cpu().numpy() routes "
                                                    "every dtype"),
    "utils/trainer.py:TrainState": ("utils/trainer.py:Trainer", "the module, its Adam "
                                                                "state and the step count "
                                                                "live on the Trainer"),
    "models/layers.py:PReLU": ("torch:nn.PReLU", "torch's per-channel nn.PReLU(C)"),
    "models/layers.py:hard_swish": ("torch:nn.functional.hardswish", "torch's own"),
    "models/rcb.py:ConvTransposeTorch": ("models/rcb.py:conv_transpose",
                                         "torch's nn.ConvTranspose2d, made to measure"),
    "models/rcb.py:DepthwiseConvTransposeTorch": ("models/rcb.py:depthwise_conv_transpose",
                                                  "a grouped nn.ConvTranspose2d"),
    "ops/resampler.py:fir_filter": ("ops/fir.py:fir_filter", "K3's wrapper, re-exported"),
    "ops/resampler.py:polyphase_resample": ("ops/fir.py:polyphase_resample",
                                            "K4's wrapper, re-exported"),
    "ops/pallas_sync.py:sync_stats": ("ops/sync_stats.py:sync_stats", "K1"),
    "ops/pallas_viterbi.py:acs_forward": ("ops/viterbi_acs.py:viterbi_decode",
                                          "K2 runs the ACS and the traceback in one launch"),
    "ops/pallas_viterbi.py:decode": ("ops/viterbi_acs.py:viterbi_decode", "K2"),
    "ops/pallas_fir.py:fir_filter": ("ops/fir.py:fir_filter", "K3"),
    "ops/pallas_fir.py:polyphase_resample": ("ops/fir.py:polyphase_resample", "K4"),
}

# Each root script of the JAX side -> its twin.
SCRIPTS = {
    "__graft_entry__.py": "chip_smoke.py",
    "bench.py": "benchmark/run.py",
    "demo.py": "demo_torch.py",
    "make_weights.py": "make_weights_torch.py",
    "scaling_report.py": "scaling_report_torch.py",
    "tune_equalizer.py": "tune_equalizer_torch.py",
}
# Public functions of the root scripts whose twin is not the script's own
# name: the flagship entry point is chip_smoke.py's flagship phase (in its
# main), the multi-card dry run multichip_torch.py.
SCRIPT_MAP = {
    "__graft_entry__.py:entry": "chip_smoke.py:main",
    "__graft_entry__.py:dryrun_multichip": "multichip_torch.py:main",
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(path: pathlib.Path) -> list[str]:
    """Public top-level functions and classes of a module."""
    return [n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defines(path: pathlib.Path, dotted: str) -> bool:
    """Whether the module defines ``dotted`` (a top-level function, class or
    assignment, then the methods of a class) without importing it."""
    body = _tree(path).body
    for part in dotted.split("."):
        found = None
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if n.name == part:
                    found = n
            elif isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == part for t in n.targets):
                found = n
        if found is None:
            return False
        body = getattr(found, "body", [])
    return True


def _exists(counterpart: str) -> bool:
    where, name = counterpart.split(":")
    if where == "torch":
        obj = torch
        for part in name.split("."):
            if not hasattr(obj, part):
                return False
            obj = getattr(obj, part)
        return True
    path = PORT_PKG / where if (PORT_PKG / where).exists() else ROOT / where
    return path.exists() and _defines(path, name)


def _jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_is_ported_or_mapped(module):
    port = PORT_PKG / PALLAS.get(module, module)
    assert port.exists(), f"{module} has no module in the port"
    missing = [name for name in _public(JAX_PKG / module)
               if not _defines(port, name) and f"{module}:{name}" not in NAME_MAP]
    assert not missing, f"{module}: not in the port's {port.name} and not mapped: {missing}"


def test_every_mapped_name_is_public_in_jax_and_missing_in_the_port():
    """A stale entry (a name the JAX package no longer has, or one the port
    now defines at the same path) fails, so the map stays the list of
    differences."""
    for key in NAME_MAP:
        module, name = key.split(":")
        assert name in _public(JAX_PKG / module), key
        port = PORT_PKG / PALLAS.get(module, module)
        assert not (module not in PALLAS and _defines(port, name)), \
            f"{key} is defined by the port at the same path: drop it from NAME_MAP"


@pytest.mark.parametrize("key", sorted(NAME_MAP))
def test_every_counterpart_exists(key):
    counterpart, why = NAME_MAP[key]
    assert why and _exists(counterpart), f"{key} -> {counterpart} does not exist"


def test_the_pallas_files_map_to_the_kernel_modules():
    pallas = {str(p.relative_to(JAX_PKG)) for p in (JAX_PKG / "ops").glob("pallas_*.py")}
    assert pallas == set(PALLAS)
    for module, port in PALLAS.items():
        assert (PORT_PKG / port).exists()
        assert "pallas_call" in (JAX_PKG / module).read_text()
        for name in _public(JAX_PKG / module):
            assert f"{module}:{name}" in NAME_MAP, f"{module}:{name} has no counterpart"
    cu = {p.name for p in (PORT_PKG / "csrc").glob("*.cu")}
    # the three sources of the Pallas kernels' ports, and K5 (track_eq.cu),
    # which replaces none: the JAX package runs its trackers as a lax.scan
    assert cu == {"sync_stats.cu", "viterbi_acs.cu", "fir.cu", "track_eq.cu"}


def test_every_root_script_has_its_twin():
    jax_side = {p.name for p in ROOT.glob("*.py")
                if not p.name.endswith("_torch.py") and p.name != "chip_smoke.py"}
    assert jax_side == set(SCRIPTS), jax_side
    for script, twin in SCRIPTS.items():
        assert (ROOT / twin).exists(), twin
    for key, target in SCRIPT_MAP.items():
        script, name = key.split(":")
        assert name in _public(ROOT / script), key
        assert _exists(target), f"{key} -> {target} does not exist"


def _halfway(points: np.ndarray) -> np.ndarray:
    """Symbols exactly halfway between two neighbouring points: on a line
    of points that share their imaginary (or real) part, so that both
    distances are exact and equal, and on the axes between +-a."""
    out = []
    re, im = np.unique(points.real), np.unique(points.imag)
    for a, b in zip(re[:-1], re[1:]):
        out += [complex((a + b) / 2, y) for y in im]
    for a, b in zip(im[:-1], im[1:]):
        out += [complex(x, (a + b) / 2) for x in re]
    return np.asarray(out, np.complex64)


@pytest.mark.parametrize("mcs", range(8))
def test_demap_hard_matches_jax(mcs):
    from gnuradio_wifi_imagetransfer_tpu.phy import mapping as jmapping
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import mapping, params

    n_bpsc = int(params.MCS_N_BPSC[mcs])
    points = params.constellation(n_bpsc).astype(np.complex64)
    rng = np.random.default_rng(mcs)
    bits = rng.integers(0, 2, (3, 48 * n_bpsc), dtype=np.uint8)
    clean = mapping.map_bits(torch.from_numpy(bits), mcs).numpy()
    noisy = (clean + 0.15 * (rng.standard_normal(clean.shape)
                             + 1j * rng.standard_normal(clean.shape))).astype(np.complex64)
    half = _halfway(points)
    for sym in (clean, noisy, half[None], np.concatenate([half, half[::-1]])[None, None]):
        want = np.asarray(jmapping.demap_hard(jnp.asarray(sym), mcs))
        got = mapping.demap_hard(torch.from_numpy(sym), mcs)
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
    # clean symbols give their bits back; ties take the first point
    assert np.array_equal(mapping.demap_hard(torch.from_numpy(clean), mcs).numpy(), bits)
    first = np.argmin(np.abs(half[:, None] - points) ** 2, axis=-1)
    want = mapping._point_bits(n_bpsc)[first].reshape(-1)
    assert np.array_equal(mapping.demap_hard(torch.from_numpy(half), mcs).numpy(), want)
