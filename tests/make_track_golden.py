"""Generate tests/golden/track_eq_jax.npz: the JAX package's LMS and STA
trackers on fixed inputs, frozen for the card.

The tracking kernel K5 runs only on a CUDA device, and the JAX package is
the reference on the CPU: it does not run on the card. So the JAX
package's ``equalize`` ran once on the CPU over the inputs below, and the
npz holds both: each input set's
spectra and LS estimate, and each case's ``eq`` and ``csi``.
``tests/test_torch_track.py`` holds K5 to the frozen outputs on the card,
and, wherever JAX imports, holds the frozen outputs to the JAX package's
live ones and the port's CPU loop to them.

Input sets (complex64; noise 0.02 an axis on unit-energy points, 31 dB,
so that no decision lies near a tie and the float32 roundings of the two
trackers stay within the tests' tolerance): a bucket of 3 frames padded
to 4 rows with a copy of row 0 (the executor pads with a copy) over 12
symbols, its points BPSK, QPSK, 16-QAM or 64-QAM; and stage A's 9 rows of
one symbol. Cases: each tracker, from SIGNAL at every rate's constellation
and the unit-modulus proxy, from a later symbol at QPSK, and stage A with
the proxy and with QPSK.

Not run by the tests. It needs JAX on the CPU:

    python tests/make_track_golden.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
OUT = os.path.join(HERE, "golden", "track_eq_jax.npz")

# name: (rows, symbols, constellation's MCS, seed)
INPUTS = {"b0": (3, 12, 0, 30), "b2": (3, 12, 2, 32), "b4": (3, 12, 4, 34),
          "b7": (3, 12, 7, 37), "a": (9, 1, 2, 40)}
# (input set, decision MCS or None for the proxy, first symbol's index)
CASES = (("b2", None, 0), ("b0", 0, 0), ("b2", 2, 0), ("b4", 4, 0), ("b7", 7, 0),
         ("b2", 2, 1), ("a", None, 0), ("a", 2, 0))
ALGOS = ("LMS", "STA")
PAD_ROWS = 1


def case_key(algo: str, name: str, mcs, idx0: int) -> str:
    return f"{algo}_{name}_{'p' if mcs is None else mcs}_{idx0}"


def make_inputs(rows: int, symbols: int, mcs: int, seed: int):
    """(y (rows, symbols, 64), h0 (rows, 52)) complex64: points of
    ``mcs``'s constellation on every bin, turned by 0.3 rad, with noise,
    and an estimate 10 % off; bucket sets padded with copies of row 0."""
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import params

    rng = np.random.default_rng(seed)
    n_bpsc = int(params.MCS_N_BPSC[mcs])
    pts = params.constellation(n_bpsc)
    shape = (rows, symbols, 64)
    y = pts[rng.integers(0, pts.size, shape)] * np.exp(0.3j)
    y = y + 0.02 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    h0 = np.exp(0.3j) * (1 + 0.1 * rng.standard_normal((rows, 52)))
    if symbols > 1:
        y = np.concatenate([y, np.repeat(y[:1], PAD_ROWS, 0)])
        h0 = np.concatenate([h0, np.repeat(h0[:1], PAD_ROWS, 0)])
    return y.astype(np.complex64), h0.astype(np.complex64)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gnuradio_wifi_imagetransfer_tpu.config import ChannelEstimator
    from gnuradio_wifi_imagetransfer_tpu.phy import equalizer

    out = {}
    for name, spec in INPUTS.items():
        out[f"y_{name}"], out[f"h0_{name}"] = make_inputs(*spec)
    for algo in ALGOS:
        for name, mcs, idx0 in CASES:
            eq, csi = equalizer.equalize(jnp.asarray(out[f"y_{name}"]),
                                         jnp.asarray(out[f"h0_{name}"]), idx0,
                                         ChannelEstimator[algo], mcs)
            key = case_key(algo, name, mcs, idx0)
            out[f"eq_{key}"] = np.asarray(eq, np.complex64)
            out[f"csi_{key}"] = np.asarray(csi, np.float32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays, {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
