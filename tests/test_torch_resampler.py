"""The port's FIR filter and rational resampler (ops/fir.py, ops/resampler.py)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the port's plain
versions (the CPU path of the K3 and K4 wrappers) and through both JAX
paths: the XLA oracle (ops/resampler.py) and the Pallas kernel in
interpret mode (ops/pallas_fir.py). Tolerance: atol 2e-4, the one
tests/test_pallas_fir.py holds the Pallas kernels to (float32 sums in
another order). Tap designs must be equal exactly.

The JAX XLA resampler forms j * decim in int32 and wraps past 2**31, so
the parity cases stay below that; a port-only case shows the port right
past it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.ops import pallas_fir
from gnuradio_wifi_imagetransfer_tpu.ops import resampler as jrs
from gnuradio_wifi_imagetransfer_tpu_torch import ops
from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir

torch.set_num_threads(2)

ATOL = 2e-4


def _rand(shape, seed, cplx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def _jax_fir(ref, x, taps):
    if ref == "pallas":
        return np.asarray(pallas_fir.fir_filter(jnp.asarray(x), taps, interpret=True))
    return np.asarray(jrs.fir_filter(jnp.asarray(x), taps))


def _jax_resample(ref, x, interp, decim, taps):
    if ref == "pallas":
        return np.asarray(pallas_fir.polyphase_resample(
            jnp.asarray(x), interp, decim, taps, interpret=True))
    return np.asarray(jrs.polyphase_resample(jnp.asarray(x), interp, decim, taps))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n_taps", [5, 48, 129])
@pytest.mark.parametrize("cplx", [False, True])
def test_fir_filter_matches_jax(ref, n_taps, cplx):
    taps = np.random.default_rng(n_taps).standard_normal(n_taps).astype(np.float32)
    x = _rand((2, 300), 7, cplx)
    got = ops.fir_filter(torch.from_numpy(x), taps).numpy()
    want = _jax_fir(ref, x, taps)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_filter_200_taps_matches_xla(cplx):
    """Past the Pallas kernel's 129-tap limit the port still filters."""
    taps = (np.random.default_rng(200).standard_normal(200) / 10).astype(np.float32)
    x = _rand((3, 700), 8, cplx)
    got = ops.fir_filter(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, _jax_fir("xla", x, taps), atol=ATOL, rtol=0)


def test_fir_filter_batch_isolation():
    """No sample leaks from one row into the next (zeros before each row)."""
    taps = np.ones(64, np.float32)
    x = np.zeros((2, 256), np.float32)
    x[0, 250] = 1.0
    got = ops.fir_filter(torch.from_numpy(x), taps).numpy()
    assert got[1].max() == 0.0
    assert got[0, 250:].min() == 1.0
    want = _jax_fir("pallas", x, taps)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("interp,decim", [(1, 2), (2, 1), (3, 4), (4, 3), (5, 2)])
@pytest.mark.parametrize("cplx", [False, True])
def test_polyphase_resample_matches_jax(ref, interp, decim, cplx):
    taps = ops.design_lowpass(interp, decim)
    x = _rand((600,), interp * 10 + decim, cplx)
    got = ops.polyphase_resample(torch.from_numpy(x), interp, decim, taps).numpy()
    want = _jax_resample(ref, x, interp, decim, taps)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_polyphase_resample_batched(ref):
    taps = ops.design_lowpass(2, 3)
    x = _rand((2, 4, 90), 9, True)
    got = ops.polyphase_resample(torch.from_numpy(x), 2, 3, taps).numpy()
    want = _jax_resample(ref, x, 2, 3, taps)
    assert got.shape == want.shape == (2, 4, 60)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("interp,decim,tpp", [(1, 2, 12), (3, 4, 12), (5, 2, 16),
                                              (25001, 25000, 12)])
def test_design_lowpass_equals_jax(interp, decim, tpp):
    got, want = ops.design_lowpass(interp, decim, tpp), jrs.design_lowpass(interp, decim, tpp)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_rational_resampler_identity_and_gcd():
    x = torch.arange(32.0)
    assert ops.rational_resampler(x, 3, 3) is x
    z = _rand((500,), 3, True)
    got = ops.rational_resampler(torch.from_numpy(z), 2, 4).numpy()
    want = np.asarray(jrs.rational_resampler(jnp.asarray(z), 2, 4))
    assert got.shape == want.shape == (250,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_correct_sample_clock_matches_jax(ppm):
    """1 +- 1e-4 is 10001/10000 or 9999/10000; 60 000 samples keep
    n_out * M below 2**31, where the JAX path is still right."""
    x = _rand((60_000,), 5, True)
    got = ops.correct_sample_clock(torch.from_numpy(x), ppm).numpy()
    want = np.asarray(jrs.correct_sample_clock(jnp.asarray(x), ppm))
    assert got.shape == want.shape
    assert got.shape[0] * 10_000 < 2**31
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_resampler_is_right_past_the_int32_index_range():
    """25001/25000 (the front-end's 40 ppm ratio) on a 120 000-sample
    tone: output j sits at input time j * 25000/25001, so
    y[j] = exp(2 pi i f j M/L). j * M passes 2**31 at j = 85 900; the
    port's int64 indices keep the error at the filter's ripple all the
    way (atol 1e-3)."""
    f, n = 0.01, 120_000
    x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
    y = ops.rational_resampler(torch.from_numpy(x), 25001, 25000).numpy()
    assert y.shape == (fir.out_len(n, 25001, 25000),)
    j = np.arange(200, y.size - 200)
    assert j[-1] * 25000 >= 2**31
    want = np.exp(2j * np.pi * f * j * (25000 / 25001))
    err = np.abs(y[j] - want)
    assert err.max() < 1e-3, (err.argmax(), err.max())


@pytest.mark.parametrize("kernel", ["fir_filter", "polyphase_resample"])
def test_wrappers_use_the_plain_version_only_for_cpu_tensors(kernel):
    """A CPU tensor goes through the plain version (no launch counted); a
    tensor on another non-CUDA device is refused, never computed plainly."""
    x = torch.from_numpy(_rand((2, 300), 1, True))
    if kernel == "fir_filter":
        fn, plain, args = fir.fir_filter, fir.fir_filter_plain, (np.ones(7, np.float32),)
    else:
        fn, plain, args = (fir.polyphase_resample, fir.polyphase_resample_plain,
                           (3, 4, ops.design_lowpass(3, 4)))
    before = fn.launches
    assert torch.equal(fn(x, *args), plain(x, *args))
    assert fn.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x.to("meta"), *args)


# K4's index scheme (csrc/fir.cu): the phase-major tap table and the tile
# walk, modelled on the CPU.

_RATIOS = [(1, 2), (2, 1), (3, 4), (4, 3), (5, 2), (2, 3), (25001, 25000)]
THREADS = 256       # csrc/fir.cu kRsThreads


def _tile_walk(n_out: int, interp: int, decim: int, n_taps: int, tile: int,
              threads: int = THREADS) -> tuple[torch.Tensor, torch.Tensor]:
    """(t0, base) of every output of a row as K4 (csrc/fir.cu) forms them,
    int64: a
    tile's origin by one division, q0 = (j0*M + c) // L and r0; a thread's
    first output (d = thread < tile) by one more on r0 + d*M; each of its
    later outputs, ``threads`` on, by the step (threads*M // L, threads*M %
    L) with a carry, as an offset from q0 that stays within 32 bits. Equal
    to the direct form's (t0, base) for every output."""
    c = (n_taps - 1) // 2
    j0 = torch.arange(0, n_out, tile, dtype=torch.int64)
    q0 = (j0 * decim + c) // interp
    r0 = (j0 * decim + c) - q0 * interp
    step_q, step_r = threads * decim // interp, threads * decim % interp
    d = torch.arange(min(threads, tile), dtype=torch.int64)
    u = r0[:, None] + d[None, :] * decim
    q, r = u // interp, u % interp
    t0 = torch.full((n_out,), -1, dtype=torch.int64)
    base = torch.full((n_out,), -1, dtype=torch.int64)
    for i in range(-(-tile // threads)):
        dd = d + i * threads
        j = j0[:, None] + dd[None, :]
        live = (dd[None, :] < tile) & (j < n_out)
        t0[j[live]] = r[live]
        base[j[live]] = (q0[:, None] + q)[live]
        q, r = q + step_q, r + step_r
        carry = (r >= interp).long()
        q, r = q + carry, r - carry * interp
    return t0, base


def _table_resample(x, interp, decim, taps):
    """K4's sum: y[j] = sum_{k < kp} hp[t0, k] * x[base - k], x zero outside
    the row, in k order, with (t0, base) from the direct form."""
    h = torch.from_numpy(taps)
    hp = fir.phase_table(h, interp)
    n, kp = x.shape[-1], hp.shape[1]
    n_out = fir.out_len(n, interp, decim)
    up = torch.arange(n_out, dtype=torch.int64) * decim + (h.numel() - 1) // 2
    t0 = up % interp
    base = (up - t0) // interp
    xz = torch.cat([x.new_zeros(x.shape[:-1] + (kp,)), x, x.new_zeros(x.shape[:-1] + (1,))], -1)
    y = x.new_zeros(x.shape[:-1] + (n_out,))
    for k in range(kp):
        src = (base - k).clamp(-1, n) + kp       # -1 and n read the zero pads
        y += hp[t0, k] * xz.index_select(-1, src)
    return y


@pytest.mark.parametrize("interp,decim", _RATIOS)
def test_phase_table_reproduces_the_plain_resampler(interp, decim):
    """The zero-padded (L, kp) table summed in k order gives
    polyphase_resample_plain's output bit for bit."""
    taps = ops.design_lowpass(interp, decim)
    x = torch.from_numpy(_rand((2, 3000), interp % 97 + decim % 89, True))
    hp = fir.phase_table(torch.from_numpy(taps), interp)
    assert hp.shape == (interp, -(-taps.size // interp))
    assert torch.equal(_table_resample(x, interp, decim, taps),
                       fir.polyphase_resample_plain(x, interp, decim, taps))


def _direct_indices(n_out, interp, decim, n_taps):
    up = torch.arange(n_out, dtype=torch.int64) * decim + (n_taps - 1) // 2
    t0 = up % interp
    return t0, (up - t0) // interp


@pytest.mark.parametrize("interp,decim", _RATIOS)
@pytest.mark.parametrize("tile", [2048, 1000, 256, 100, 1])
def test_tile_walk_matches_the_direct_form(interp, decim, tile):
    """Every output of whole and ragged tiles gets the direct form's
    (t0, base) from one division a tile, one a thread and 32-bit steps."""
    n_taps = 12 * interp
    n_out = 3 * tile + 77
    t0, base = _tile_walk(n_out, interp, decim, n_taps, tile)
    want = _direct_indices(n_out, interp, decim, n_taps)
    assert torch.equal(t0, want[0]) and torch.equal(base, want[1])


def test_tile_walk_past_the_int32_index_range():
    """25001/25000 past output 85 900, where j*M passes 2**31: the tile
    origin is 64-bit, the offsets within a tile 32-bit."""
    interp, decim, n_taps = 25001, 25000, 12 * 25001
    n_out = 95_000
    _, _, tile, _, _ = fir.resample_geometry(n_taps, interp, decim, 8)
    t0, base = _tile_walk(n_out, interp, decim, n_taps, tile)
    want = _direct_indices(n_out, interp, decim, n_taps)
    assert (n_out - 1) * decim >= 2**31
    assert torch.equal(t0, want[0]) and torch.equal(base, want[1])
    # what the kernel keeps in 32 bits: the offset within a tile, the step
    j0 = torch.arange(n_out) // tile * tile
    q0 = (j0 * decim + (n_taps - 1) // 2) // interp
    assert int((base - q0).max()) < 2**31 and THREADS * decim < 2**31


@pytest.mark.parametrize("interp,decim", _RATIOS + [(1, 96), (1, 5000), (7, 1)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_resample_geometry_fits_the_span(interp, decim, itemsize):
    """The staged span of any tile (at most its last base less its first,
    plus a pass's taps and the alignment slack) fits the bytes kept."""
    n_taps = 12 * interp
    kp, kc, tile, span_bytes, in_smem = fir.resample_geometry(n_taps, interp, decim, itemsize)
    assert kp == 12 and kc == 12 and 1 <= tile <= fir.RS_MAX_TILE
    assert span_bytes % 16 == 0 and span_bytes <= fir.RS_SPAN_BYTES
    assert in_smem == (interp * kp * 4 <= fir.RS_TABLE_BYTES)
    n_out = 4 * tile
    _, base = _direct_indices(n_out, interp, decim, n_taps)
    widest = int((base[tile - 1::tile] - base[::tile]).max())
    v = 16 // itemsize
    assert ((widest + kc + v - 1) // v * v + v) * itemsize <= span_bytes


@pytest.mark.parametrize("interp", [1, 3, 25001])
def test_phase_table_of_tensor_taps_is_cached_until_they_change(interp):
    """Tensor taps: the second call reuses the first call's table (no copy,
    no launch); an in-place change to the taps builds it anew."""
    h = torch.from_numpy(ops.design_lowpass(interp, 4))
    cpu = torch.device("cpu")
    first = fir._phase_table_of(h, interp, cpu)
    assert torch.equal(first, fir.phase_table(h, interp))
    assert fir._phase_table_of(h, interp, cpu) is first
    h.mul_(2)
    again = fir._phase_table_of(h, interp, cpu)
    assert again is not first and torch.equal(again, fir.phase_table(h, interp))
