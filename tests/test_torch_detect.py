"""The port's STF detection (ops/sync_stats.py: sync_detect_plain, the
plain model of the detector kernel's two-pass tiling, and phy/sync.py
detect) against the JAX package's detect on the CPU.

Starts and valid flags must match exactly; cfo within 1e-4 rad/sample and
ratio within 1e-3 (the statistics tolerances of tests/test_pallas_sync.py:
two float32 paths sum the windows in another order)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from gnuradio_wifi_imagetransfer_tpu.config import PhyConfig as JPhyConfig
from gnuradio_wifi_imagetransfer_tpu.phy import sync as jsync
from gnuradio_wifi_imagetransfer_tpu_torch.config import PhyConfig
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync

torch.set_num_threads(2)

THRESHOLD = PhyConfig().sync_threshold


@pytest.fixture(scope="module")
def example_block():
    return graft._example_block(1 << 15, 4)[0]


def _jax_detect(x, k, min_plateau, lo, hi):
    cfg = dataclasses.replace(JPhyConfig(), min_plateau=min_plateau)

    def fields(x):
        cand = jsync.detect(x, k, cfg, search_lo=lo, search_hi=hi)
        return cand.starts, cand.valid, cand.cfo, cand.ratio

    return [np.asarray(v) for v in jax.jit(fields)(jnp.asarray(x))]


def _assert_matches(got, want):
    got = [v.numpy() for v in got]
    assert np.array_equal(got[0], want[0])                          # starts
    assert np.array_equal(got[1], want[1])                          # valid
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)  # cfo
    np.testing.assert_allclose(got[3], want[3], atol=1e-3, rtol=0)  # ratio


@pytest.mark.parametrize("min_plateau", [1, 2, 3])
@pytest.mark.parametrize("lo,hi", [(0, None), (300, 20000), (8392, 32000)])
def test_sync_detect_plain_matches_jax(example_block, lo, hi, min_plateau):
    want = _jax_detect(example_block, 8, min_plateau, lo, hi)
    got = k1.sync_detect_plain(torch.from_numpy(example_block), 8, THRESHOLD, min_plateau,
                               lo, hi)
    _assert_matches(got, want)
    assert want[1].sum() >= 1


def test_invalid_slots_carry_the_jax_ratio(example_block):
    """4 frames in 8 slots: the 4 invalid slots hold start 0, cfo 0 and the
    ratio at max(n - min_plateau, 0), as JAX's unmasked c[trigger]."""
    want = _jax_detect(example_block, 8, 2, 0, None)
    got = k1.sync_detect_plain(torch.from_numpy(example_block), 8, THRESHOLD, 2)
    valid = want[1]
    assert valid.sum() == 4 and not valid[4:].any()
    _assert_matches(got, want)
    _, _, c = k1.sync_stats_plain(torch.from_numpy(example_block))
    assert np.array_equal(got[0].numpy()[~valid], np.zeros(4, np.int32))
    assert np.array_equal(got[2].numpy()[~valid], np.zeros(4, np.float32))
    assert np.all(got[3].numpy()[~valid] == c[-2].item())


def test_phy_detect_is_sync_detect_plain_on_the_cpu(example_block):
    x = torch.from_numpy(np.stack([example_block, example_block[::-1].copy()]))
    cand = sync.detect(x, 4, PhyConfig(), 256, 30000)
    want = k1.sync_detect_plain(x, 4, THRESHOLD, PhyConfig().min_plateau, 256, 30000)
    for g, w in zip((cand.starts, cand.valid, cand.cfo, cand.ratio), want):
        assert torch.equal(g, w)


def _edge_mask(rows, n, seed, tile):
    """Random edges, plus edges on and beside every tile boundary and a
    run of more edges than K inside one tile."""
    rng = np.random.default_rng(seed)
    e = rng.random((rows, n)) < 0.002
    for b in range(tile, n, tile):
        e[rng.integers(rows), b - 1: b + 2] = True
    e[0, tile + 5: 2 * tile - 5: 7] = True
    return torch.from_numpy(e)


@pytest.mark.parametrize("k", [1, 4, 8, 40])
@pytest.mark.parametrize("tile", [k1.DETECT_TILE, 32, 100])
def test_tiling_model_matches_topk(tile, k):
    e = _edge_mask(6, 5 * tile + 17, seed=k + tile, tile=tile)
    got = k1.first_edges_tiled(e, k, tile)
    want = k1.first_edges(e, k)
    assert torch.equal(got, want)


def test_tiling_model_on_empty_and_full_rows():
    e = torch.zeros(3, 2000, dtype=torch.bool)
    e[1] = True
    e[2, 1999] = True
    got = k1.first_edges_tiled(e, 5)
    assert torch.equal(got, k1.first_edges(e, 5))
    assert got[0].tolist() == [2000] * 5 and got[1].tolist() == [0, 1, 2, 3, 4]
