"""Soft-decision Viterbi decoder for the 802.11a K=7 convolutional code.

PyTorch port of the JAX package's phy/viterbi.py. The 64-state
add-compare-select recursion and the traceback run in one call of
``ops.viterbi_acs.viterbi_decode`` (``decode``) or, for several trellises
at once, ``viterbi_decode_many`` (``decode_many``): the CUDA kernel for
CUDA tensors, its plain PyTorch version (the JAX XLA path, op for op) for
CPU tensors. Both are bit-exact against the JAX package.

Metric convention: LLR pairs (llr_a, llr_b) per trellis step with llr > 0
favouring coded bit 1; the decoder maximizes sum_i llr_i * coded_bit_i, so
depunctured (erased) positions with llr = 0 do not steer the path.
"""

from __future__ import annotations

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs


def decode(llrs: torch.Tensor, n_bits: int, terminated: bool = True) -> torch.Tensor:
    """Viterbi-decode soft mother-code LLRs.

    llrs: (..., 2*n_bits) float LLRs in A1 B1 A2 B2 ... order (depunctured).
    terminated: the encoder was flushed with >= 6 zero tail bits, so the
      traceback starts from state 0; otherwise from the best end state.
    Returns (..., n_bits) uint8 decoded bits.
    """
    batch_shape = llrs.shape[:-1]
    x = llrs.reshape(-1, n_bits, 2).to(torch.float32).contiguous()
    bits = viterbi_acs.viterbi_decode(x, terminated)
    return bits.reshape(batch_shape + (n_bits,))


def decode_many(llrs, n_bits, terminated, lengths=None) -> list[torch.Tensor]:
    """``decode`` on several LLR tensors at once (one kernel launch on the
    card): llrs[i] (..., 2*n_bits[i]) with flag terminated[i] ->
    [(..., n_bits[i]) uint8]. ``lengths[i]``, None or a (...,) tensor of
    trellis lengths, gives each frame of a terminated segment a trellis of
    its own, ending in state 0 after its own length (its bits past it are
    0)."""
    segs = [v.reshape(-1, nb, 2).to(torch.float32).contiguous()
            for v, nb in zip(llrs, n_bits, strict=True)]
    if lengths is not None:
        lengths = [None if n is None else n.reshape(-1).to(torch.int32).contiguous()
                   for n in lengths]
    bits = viterbi_acs.viterbi_decode_many(segs, terminated, lengths)
    return [b.reshape(v.shape[:-1] + (nb,)) for b, v, nb in zip(bits, llrs, n_bits)]
