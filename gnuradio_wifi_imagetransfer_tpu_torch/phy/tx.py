"""802.11a TX chain: PSDU bytes -> baseband sample burst.

PyTorch port of the JAX package's phy/tx.py: scramble, BCC encode,
puncture, interleave, map, the SIGNAL header, carrier allocation, IFFT and
cyclic prefix, over a batch of frames with static shapes per (MCS, length);
and ``pad_burst``, the scaling and zero padding around a burst.
"""

from __future__ import annotations

import dataclasses

import torch

from gnuradio_wifi_imagetransfer_tpu_torch.phy import bits as bitops
from gnuradio_wifi_imagetransfer_tpu_torch.phy import mapping, ofdm, params, signal_field
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


@dataclasses.dataclass(frozen=True)
class TxPlan:
    """Static sizes for one (MCS, PSDU length) combination."""

    mcs: int
    psdu_len: int                 # bytes

    @property
    def rate(self) -> str:
        return params.MCS_RATE_STR[self.mcs]

    @property
    def n_dbps(self) -> int:
        return int(params.MCS_N_DBPS[self.mcs])

    @property
    def n_cbps(self) -> int:
        return int(params.MCS_N_CBPS[self.mcs])

    @property
    def n_sym(self) -> int:
        return params.n_symbols(self.mcs, self.psdu_len)

    @property
    def n_data_bits(self) -> int:
        """Total scrambled bits incl. service, tail and pad (17.3.5.3)."""
        return self.n_sym * self.n_dbps

    @property
    def n_pad_bits(self) -> int:
        return self.n_data_bits - (
            params.N_SERVICE_BITS + 8 * self.psdu_len + params.N_TAIL_BITS)

    @property
    def n_coded_bits(self) -> int:
        return self.n_sym * self.n_cbps

    @property
    def n_samples(self) -> int:
        """Burst length: (4 preamble + 1 SIGNAL + n_sym) x 80 + 1 tail sample."""
        return (4 + 1 + self.n_sym) * params.N_SYM + 1


def tx_plan(mcs: int, psdu_len: int) -> TxPlan:
    return TxPlan(int(mcs), int(psdu_len))


def _tx(psdu: torch.Tensor, seeds: torch.Tensor, plan: TxPlan) -> torch.Tensor:
    """(B, L) uint8 frames, (B,) scrambler seeds -> (B, n_samples) complex64."""
    b = psdu.shape[0]
    dev = psdu.device

    def zeros(n):
        return torch.zeros((b, n), dtype=torch.uint8, device=dev)

    raw = torch.cat([zeros(params.N_SERVICE_BITS), bitops.bytes_to_bits(psdu),
                     zeros(params.N_TAIL_BITS), zeros(plan.n_pad_bits)], dim=-1)
    scrambled = bitops.scramble(raw, seeds)
    # reset the 6 tail bits after scrambling so the trellis ends in state 0
    tail_at = params.N_SERVICE_BITS + 8 * plan.psdu_len
    scrambled[:, tail_at: tail_at + params.N_TAIL_BITS] = 0
    coded = bitops.conv_encode(scrambled)
    interleaved = bitops.interleave(bitops.puncture(coded, plan.rate), plan.mcs)
    syms = mapping.map_bits(interleaved, plan.mcs).reshape(
        b, plan.n_sym, params.N_DATA_CARRIERS)
    length = torch.full((b,), plan.psdu_len, dtype=torch.int32, device=dev)
    sig = signal_field.encode(plan.mcs, length)                    # (B, 48)
    sig_freq = ofdm.allocate_carriers(sig[:, None, :], symbol_index0=0)
    data_freq = ofdm.allocate_carriers(syms, symbol_index0=1)
    return ofdm.assemble_burst(sig_freq, data_freq)


def transmit(psdu, mcs: int, scrambler_seed=1, device="cuda") -> torch.Tensor:
    """PSDU byte frames -> baseband bursts on ``device``.

    psdu: (..., L) uint8 (numpy or tensor). scrambler_seed: a scalar or one
    seed per frame (the reference mapper counts them 1..127). Returns
    (..., n_samples) complex64.
    """
    dev = resolve(device)
    psdu = torch.as_tensor(psdu, device=dev).to(torch.uint8)
    plan = tx_plan(mcs, psdu.shape[-1])
    batch = psdu.shape[:-1]
    seeds = torch.as_tensor(scrambler_seed, dtype=torch.long, device=dev).expand(batch)
    out = _tx(psdu.reshape(-1, psdu.shape[-1]), seeds.reshape(-1), plan)
    return out.reshape(batch + out.shape[-1:])


def pad_burst(samples: torch.Tensor, pad_front: int = 100, pad_tail: int = 1000,
              scale: float = 0.5) -> torch.Tensor:
    """Amplitude scale + zero padding around a burst (..., n), as the
    reference TX's multiply_const_cc(0.5) and packet_pad2(pad_front=100,
    pad_tail=1000) do."""
    batch = samples.shape[:-1]

    def zeros(n):
        return torch.zeros(batch + (n,), dtype=samples.dtype, device=samples.device)

    return torch.cat([zeros(pad_front), samples * scale, zeros(pad_tail)], dim=-1)
