"""The codec's weights: the flat npz store and the carriers between a Flax
variables tree and the port's modules, both ways.

The trained SOMA-DSCN weights ship as one compressed npz of float16
leaves keyed 'collection/path/to/leaf' (the JAX package's
models/weights.py writes it; ``make_weights.py`` trains it). The port reads
the repo's file where it lies, beside this package
(``gnuradio_wifi_imagetransfer_tpu/assets/``), and keeps no copy.

``state_dict_from_flax`` carries a Flax tree of arrays (params and
batch_stats) to a module's state_dict. The submodules carry the Flax
names, so a leaf path is a state_dict key up to the leaf's own name;
layouts change as follows:

  Flax Conv kernel           (kh, kw, I/groups, O) -> Conv2d weight (O, I/groups, kh, kw)
  ConvTransposeTorch kernel  (kh, kw, O, I)        -> ConvTranspose2d weight (I, O, kh, kw)
  Dense kernel               (I, O)                -> Linear weight (O, I)
  BatchNorm scale/bias, batch_stats mean/var       -> weight/bias, running_mean/running_var
  PReLU alpha                                      -> weight
  GDN beta/gamma                                   -> the same (reparameterised sqrt form)
  SOMANet shared_phi                               -> the same

``flax_from_module`` is the reverse carrier: a module's state -> the
Flax-shaped variables tree the JAX package's SOMANet holds, so
``save_soma_npz`` writes the npz that the JAX package's ``load_soma_npz``
reads leaf for leaf.

Both 4-d kernels take the transpose (3, 2, 0, 1): the JAX package keeps
its transposed-conv kernel as (kh, kw, O, I) for
``lax.conv_transpose(transpose_kernel=True)``.
"""

from __future__ import annotations

import collections.abc
import json
import os
import pathlib
from typing import Optional

import numpy as np
import torch
from torch import nn

SEP = "/"
ASSETS = pathlib.Path(__file__).resolve().parents[2] / "gnuradio_wifi_imagetransfer_tpu" / "assets"
# the reference geometry first (240 x 240, c = 128: the (30, 30, 128)
# latent of upload_featuremap_udp.py:78-82), then the small 80 x 80, c = 64
CHECKPOINTS = ("jsce_soma_dscn_240.npz", "jsce_soma_dscn.npz")

_LEAF = {("params", "bias"): "bias", ("params", "scale"): "weight",
         ("params", "alpha"): "weight", ("params", "beta"): "beta",
         ("params", "gamma"): "gamma", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var", ("params", "shared_phi"): "shared_phi"}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        # Mapping, not dict: a flax FrozenDict is a Mapping and no dict
        if isinstance(v, collections.abc.Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_soma_npz(path) -> tuple[dict, dict]:
    """npz -> (SOMANet variables tree of float32 numpy arrays, meta dict)."""
    with np.load(path) as npz:
        data = dict(npz)
    meta = json.loads(bytes(data.pop("__meta__").tobytes()).decode()) \
        if "__meta__" in data else {}
    flat = {k: v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in data.items()}
    return _unflatten(flat), meta


def save_soma_npz(variables: dict, path, meta: Optional[dict] = None,
                  dtype=np.float16) -> None:
    """SOMANet variables -> one compressed npz of ``dtype`` leaves (float16
    by default) keyed 'collection/path/to/leaf', with the JSON ``meta``
    under '__meta__': the JAX package's format."""
    flat = {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in _flatten(variables).items()}
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **flat)


def split_soma(variables: dict) -> tuple[dict, dict]:
    """SOMANet variables -> (encoder, decoder) variables, the state-dict
    split of jsce_codec.py:89-96."""
    enc = {"params": variables["params"]["shared_encoder"]}
    dec = {"params": variables["params"]["shared_decoder"]}
    stats = variables.get("batch_stats", {})
    if "shared_encoder" in stats:
        enc["batch_stats"] = stats["shared_encoder"]
    if "shared_decoder" in stats:
        dec["batch_stats"] = stats["shared_decoder"]
    return enc, dec


def default_checkpoint() -> Optional[str]:
    """The packaged trained checkpoint, or None if absent. The
    ``GWT_JSCE_WEIGHTS`` environment variable names another; it raises if
    that file is missing, rather than fall back to the packaged one."""
    override = os.environ.get("GWT_JSCE_WEIGHTS")
    if override:
        if not os.path.exists(override):
            raise FileNotFoundError(f"GWT_JSCE_WEIGHTS points at a missing file: {override}")
        return override
    for name in CHECKPOINTS:
        if (ASSETS / name).is_file():
            return str(ASSETS / name)
    return None


def _to_torch(collection: str, leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    if collection == "params" and leaf == "kernel":
        if v.ndim == 4:
            return "weight", v.transpose(3, 2, 0, 1)
        if v.ndim == 2:
            return "weight", v.T
        raise ValueError(f"a {v.ndim}-d kernel has no torch layout here")
    try:
        return _LEAF[collection, leaf], v
    except KeyError:
        raise ValueError(f"no torch counterpart for {collection}/.../{leaf}") from None


def state_dict_from_flax(variables: collections.abc.Mapping,
                         module: nn.Module) -> dict[str, torch.Tensor]:
    """Flax variables ({"params": ..., "batch_stats": ...}, leaves of
    anything numpy reads) -> a full state_dict for ``module`` in its dtype.
    Raises if a leaf finds no tensor, a tensor no leaf, or a shape differs."""
    target = module.state_dict()
    out = {}
    for path, v in _flatten(variables).items():
        collection, *mods, leaf = path.split(SEP)
        name, v = _to_torch(collection, leaf, v)
        key = ".".join(mods + [name])
        if key not in target:
            raise KeyError(f"leaf {path} has no tensor {key} in {type(module).__name__}")
        if tuple(v.shape) != tuple(target[key].shape):
            raise ValueError(f"leaf {path}: {v.shape} against {key} {tuple(target[key].shape)}")
        out[key] = torch.tensor(v, dtype=target[key].dtype)
    # BatchNorm's step counter is a training count, which Flax does not keep
    for key, t in target.items():
        if key.endswith("num_batches_tracked"):
            out.setdefault(key, t)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"{type(module).__name__} tensors with no leaf: {missing[:8]}")
    return out



def _to_flax(module: nn.Module, name: str, t: torch.Tensor) -> tuple[str, str, np.ndarray]:
    """(collection, leaf, value) of one tensor of ``module``."""
    v = t.detach().cpu().numpy()
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and name == "weight":
        return "params", "kernel", v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
    if isinstance(module, nn.BatchNorm2d):
        return {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}[name] + (v,)
    if isinstance(module, nn.PReLU):
        return "params", "alpha", v
    return "params", name, v


def flax_from_module(module: nn.Module) -> dict:
    """A module's parameters and BatchNorm statistics -> the Flax variables
    tree {"params": ..., "batch_stats": ...} of float32 numpy arrays (the
    reverse of ``state_dict_from_flax``; BatchNorm's step counter, which
    Flax does not keep, is dropped)."""
    flat = {}
    for prefix, m in module.named_modules():
        tensors = list(m.named_parameters(recurse=False)) + [
            (n, b) for n, b in m.named_buffers(recurse=False)
            if n in ("running_mean", "running_var")]
        for name, t in tensors:
            collection, leaf, v = _to_flax(m, name, t)
            path = [collection] + (prefix.split(".") if prefix else []) + [leaf]
            flat[SEP.join(path)] = np.array(v, dtype=np.float32)     # a copy
    return _unflatten(flat)
