"""The reference's .pth checkpoint -> the codec's variables (PyTorch port of
the JAX package's models/convert.py).

The reference ships torch .pth checkpoints whose state dict splits into
shared_encoder.* / shared_decoder.* (jsce_codec.py:89-96), under its own
module names (an RTCB's ``proc`` and ``shortcut`` Sequentials, its output
PReLU ``fn``; an RCB's ``skip`` and ``se`` Sequentials; ``IRS_compress``).
This module renames those entries onto the Flax-shaped variables tree that
``weights.state_dict_from_flax`` carries into the port's modules, with the
layouts of the JAX package:

  torch Conv2d        (O, I, kh, kw)  -> kernel (kh, kw, I, O)
  torch depthwise     (C, 1, kh, kw)  -> kernel (kh, kw, 1, C)
  torch ConvTranspose (I, O, kh, kw)  -> kernel (kh, kw, O, I)
  torch Linear        (O, I)          -> kernel (I, O)
  torch BatchNorm     weight/bias/running_mean/running_var
                                      -> scale/bias (params), mean/var (batch_stats)
  torch PReLU weight  (C,)            -> alpha
  GDN beta/gamma                      -> the same (reparameterised sqrt form)

Every 4-d weight takes the transpose (2, 3, 1, 0).
"""

from __future__ import annotations

import numpy as np
import torch

# torch Sequential index -> module name
_RTCB_PROC = {"0": "convt1", "1": "gdn1", "2": "prelu1", "3": "convt2", "4": "gdn2"}
_RTCB_SHORT = {"0": "skip_convt", "1": "skip_gdn"}
_RCB_SKIP = ["skip_conv0", "skip_bn0", "skip_conv1", "skip_bn1"]
_RCB_SE = {1: "conv1", 2: "bn1", 4: "conv2"}          # SeModule Sequential


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    d = tree
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = np.asarray(value)


def _convert_entry(params: dict, stats: dict, path: list[str], leaf: str, w: np.ndarray):
    """Place one state-dict entry into the trees."""
    if leaf == "num_batches_tracked":
        return
    if leaf == "weight" and w.ndim == 4:
        _set(params, path + ["kernel"], w.transpose(2, 3, 1, 0))
    elif leaf == "weight" and w.ndim == 2:
        _set(params, path + ["kernel"], w.T)
    elif leaf == "weight" and w.ndim == 1:
        mod = path[-1] if path else ""
        _set(params, path + ["alpha" if mod.startswith("prelu") else "scale"], w)
    elif leaf in ("bias", "beta", "gamma", "alpha"):
        _set(params, path + [leaf], w)
    elif leaf == "running_mean":
        _set(stats, path + ["mean"], w)
    elif leaf == "running_var":
        _set(stats, path + ["var"], w)
    else:
        raise ValueError(f"unhandled torch entry {'.'.join(path)}.{leaf} shape {w.shape}")


def _map_path(parts: list[str], is_decoder: bool) -> list[str]:
    """Rename the reference's module path to the port's module names."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if is_decoder and p == "proc":
            out.append(_RTCB_PROC[parts[i + 1]])
            i += 2
        elif is_decoder and p == "shortcut":
            out.append(_RTCB_SHORT[parts[i + 1]])
            i += 2
        elif is_decoder and p == "fn":
            out.append("prelu_out")
            i += 1
        elif not is_decoder and p == "skip":
            out.append(_RCB_SKIP[int(parts[i + 1])])
            i += 2
        elif not is_decoder and p == "se" and parts[i + 1].isdigit():
            out.extend(["semodule", _RCB_SE[int(parts[i + 1])]])
            i += 2
        else:
            out.append("irs_compress" if p == "IRS_compress" else p)
            i += 1
    return out


def convert_module(state_dict: dict, is_decoder: bool) -> dict:
    """One module's reference state dict -> {'params': ..., 'batch_stats':
    ...} of numpy arrays."""
    params: dict = {}
    stats: dict = {}
    for key, val in state_dict.items():
        w = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        *parts, leaf = key.split(".")
        _convert_entry(params, stats, _map_path(parts, is_decoder), leaf, w)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def load_torch_checkpoint(weight_path: str) -> tuple[dict, dict]:
    """A reference-format .pth -> (encoder, decoder) variables, split as
    jsce_codec.py:89-96 does. Reads tensors only (``weights_only``)."""
    ckpt = torch.load(weight_path, map_location="cpu", weights_only=True)
    enc_sd = {k[len("shared_encoder."):]: v for k, v in ckpt.items()
              if k.startswith("shared_encoder.")}
    dec_sd = {k[len("shared_decoder."):]: v for k, v in ckpt.items()
              if k.startswith("shared_decoder.")}
    return convert_module(enc_sd, is_decoder=False), convert_module(dec_sd, is_decoder=True)
