"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch import ops
from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(rows, n, seed, amp=0.5, silent=(0, 0)):
    rng = np.random.default_rng(seed)
    x = amp * (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
    x[:, silent[0]:silent[1]] = 0
    return torch.from_numpy(x.astype(np.complex64))


@pytest.mark.parametrize("rows,n,amp", [(1, 263_840, 0.5), (64, 4096, 0.5),
                                        (3, 5000, 1.0), (2, 1000, 0.5)])
def test_sync_stats_kernel_matches_plain(dev, rows, n, amp):
    x = _stream(rows, n, seed=rows, amp=amp, silent=(n // 3, n // 3 + 600))
    want = [v.to(dev) for v in k1.sync_stats_plain(x.to(dev))]
    before = k1.sync_stats.launches
    got = k1.sync_stats(x.to(dev))
    torch.cuda.synchronize()
    assert k1.sync_stats.launches == before + 1
    a, p, c = got
    torch.testing.assert_close(a, want[0], atol=2e-4, rtol=0)
    torch.testing.assert_close(p, want[1], atol=2e-4, rtol=0)
    mask = want[1] > 1e-3
    torch.testing.assert_close(c[mask], want[2][mask], atol=1e-3, rtol=0)
    # a silent stretch gives exact zeros once both windows lie inside it
    quiet = slice(n // 3 + 64, n // 3 + 600)
    assert torch.count_nonzero(a[:, quiet]) == 0
    assert torch.count_nonzero(p[:, quiet]) == 0


def _llrs(b, n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "tied":       # small integers: equal path metrics are common
        llr = rng.integers(-2, 3, (b, n, 2)).astype(np.float32)
    else:
        llr = rng.standard_normal((b, n, 2)).astype(np.float32) * 4
    if kind == "punctured":  # 3/4 pattern erasures
        flat = llr.reshape(b, -1)
        mask = np.tile(np.array([1, 1, 1, 0, 0, 1], bool), flat.shape[1] // 6 + 1)
        flat[:, ~mask[: flat.shape[1]]] = 0
    return torch.from_numpy(llr)


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["random", "punctured", "tied"])
@pytest.mark.parametrize("b,n", [(256, 422), (256, 24), (3, 1000)])
def test_viterbi_kernel_matches_plain(dev, b, n, kind, terminated):
    llr = _llrs(b, n, seed=b + n, kind=kind).to(dev)
    want = k2.viterbi_decode_plain(llr, terminated)
    before = k2.viterbi_decode.launches
    got = k2.viterbi_decode(llr, terminated)
    torch.cuda.synchronize()
    assert k2.viterbi_decode.launches == before + 1
    assert torch.equal(got, want)


def _rand(shape, seed, cplx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        return torch.from_numpy((x + 1j * rng.standard_normal(shape)).astype(np.complex64))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n_taps,shape", [(5, (2, 300)), (48, (2, 300)), (129, (2, 300)),
                                          (200, (3, 5000)), (1000, (2, 3000)),
                                          (65, (4, 1 << 20))])
def test_fir_kernel_matches_plain(dev, n_taps, shape, cplx):
    """atol 2e-4, the Pallas FIR tests' tolerance (taps scaled to unit
    energy past 129 taps, so the sums stay at the scale of those cases)."""
    taps = np.random.default_rng(n_taps).standard_normal(n_taps).astype(np.float32)
    if n_taps > 129:
        taps /= np.sqrt(n_taps)
    x = _rand(shape, 7, cplx).to(dev)
    want = k34.fir_filter_plain(x, taps)
    before = k34.fir_filter.launches
    got = k34.fir_filter(x, taps)
    torch.cuda.synchronize()
    assert k34.fir_filter.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_fir_kernel_keeps_rows_apart(dev):
    x = torch.zeros(2, 256, device=dev)
    x[0, 250] = 1.0
    got = k34.fir_filter(x, np.ones(64, np.float32))
    assert got[1].abs().max().item() == 0.0
    assert got[0, 250:].min().item() == 1.0


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("interp,decim", [(1, 2), (2, 1), (3, 4), (4, 3), (5, 2), (2, 3)])
@pytest.mark.parametrize("shape", [(600,), (2, 4, 90), (3, 70_001)])
def test_resample_kernel_matches_plain(dev, interp, decim, shape, cplx):
    taps = ops.design_lowpass(interp, decim)
    x = _rand(shape, interp * 10 + decim, cplx).to(dev)
    want = k34.polyphase_resample_plain(x, interp, decim, taps)
    before = k34.polyphase_resample.launches
    got = k34.polyphase_resample(x, interp, decim, taps)
    torch.cuda.synchronize()
    assert k34.polyphase_resample.launches == before + 1
    assert got.dtype == x.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)


def test_resample_kernel_past_the_int32_index_range(dev):
    """25001/25000 on a 200 000-sample tone: j * M passes 2**31 at output
    85 900; kernel = plain (atol 2e-4) and = the analytic tone (1e-3)."""
    f, n = 0.01, 200_000
    x = torch.from_numpy(np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)).to(dev)
    got = ops.rational_resampler(x, 25001, 25000)
    taps = ops.design_lowpass(25001, 25000)
    torch.testing.assert_close(got, k34.polyphase_resample_plain(x, 25001, 25000, taps),
                               atol=2e-4, rtol=0)
    j = np.arange(200, got.shape[-1] - 200)
    want = np.exp(2j * np.pi * f * j * (25000 / 25001))
    assert np.abs(got[200:-200].cpu().numpy() - want).max() < 1e-3


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        k1.sync_stats(torch.zeros(10, device=dev))
    with pytest.raises(ValueError):
        k2.viterbi_decode(torch.zeros(2, 5, 3, device=dev))
    with pytest.raises(TypeError):
        k34.fir_filter(torch.zeros(10, dtype=torch.float64, device=dev), np.ones(3))
    with pytest.raises(ValueError):
        k34.polyphase_resample(torch.zeros(4, 10, device=dev).t(), 3, 4,
                               ops.design_lowpass(3, 4))
