"""The state this slice carries across from the JAX package.

No learned weights lie on the RX path: its state is the set of standard
tables (phy/params.py) and the configuration. ``load_reference_state``
takes the JAX package's tables and configs as plain numpy arrays and
dicts, checks them against the port's own copies (exact equality, dtype
included) and returns the port's configs.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np

from gnuradio_wifi_imagetransfer_tpu_torch import config
from gnuradio_wifi_imagetransfer_tpu_torch.phy import params


def reference_arrays(mod: types.ModuleType = params) -> dict[str, np.ndarray]:
    """Every table of a params module, by name: its module-level arrays
    plus the cached tables (conv_tables/<name>, interleaver_perm/<mcs>,
    deinterleaver_perm/<mcs>, constellation/<n_bpsc>,
    PUNCTURE_PATTERNS/<rate>, crc32_table). Works on any module that has
    the port's params layout, so the caller can pass the JAX package's."""
    out = {name: getattr(mod, name) for name in dir(params)
           if isinstance(getattr(params, name), np.ndarray)}
    for name, arr in mod.conv_tables().items():
        out[f"conv_tables/{name}"] = arr
    for mcs in range(8):
        out[f"interleaver_perm/{mcs}"] = mod.interleaver_perm(mcs)
        out[f"deinterleaver_perm/{mcs}"] = mod.deinterleaver_perm(mcs)
    for n_bpsc in (1, 2, 4, 6):
        out[f"constellation/{n_bpsc}"] = mod.constellation(n_bpsc)
    for rate, pattern in mod.PUNCTURE_PATTERNS.items():
        out[f"PUNCTURE_PATTERNS/{rate}"] = pattern
    out["crc32_table"] = mod.crc32_table()
    return {k: np.asarray(v) for k, v in out.items()}


def _dataclass_from(cls, values: dict):
    """Build ``cls`` from a dataclasses.asdict() dict; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(values) - names
    if extra:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(extra)}")
    return cls(**values)


def load_reference_state(arrays: dict[str, np.ndarray], cfg: dict):
    """Check the JAX package's tables against the port's and convert its
    configs.

    arrays: name -> array, as ``reference_arrays`` names them; every table
      must be present and equal the port's exactly (shape, dtype, values).
    cfg: {"phy": asdict(PhyConfig), "executor": asdict(ExecutorConfig)};
      a nested front-end dict becomes a FrontendConfig.
    Returns (PhyConfig, ExecutorConfig) of the port.
    """
    ours = reference_arrays()
    missing, extra = set(ours) - set(arrays), set(arrays) - set(ours)
    if missing or extra:
        raise ValueError(f"reference tables differ in names: missing "
                         f"{sorted(missing)}, unknown {sorted(extra)}")
    for name, want in ours.items():
        got = np.asarray(arrays[name])
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            raise ValueError(f"reference table {name!r} differs from the port's copy")
    phy = dict(cfg["phy"])
    phy["encoding"] = config.Encoding(int(phy["encoding"]))
    phy["chan_est"] = config.ChannelEstimator(int(phy["chan_est"]))
    ex = dict(cfg["executor"])
    if ex.get("frontend") is not None:
        fe = dict(ex["frontend"])
        fe["resample"] = tuple(fe["resample"])
        ex["frontend"] = _dataclass_from(config.FrontendConfig, fe)
    return (_dataclass_from(config.PhyConfig, phy),
            _dataclass_from(config.ExecutorConfig, ex))
