"""A plain 802.11a/p receiver with the LMS and STA tracking equalizers.

The reference that the port's trackers (``phy/equalizer.py``, the CUDA
kernel K5) and its SIGNAL-steered executor are held to. It is written
from the standard (IEEE Std 802.11-2016 Clause 17, which 802.11p runs at
half clock) and from the trackers' equations as ``phy/equalizer.py``'s
docstring states them, in plain ``torch`` at float64 with TF32 off. It
imports neither package and no kernel; its tables (carriers, pilots, the
LTF, pilot polarity, constellations, interleaver, puncturing, the K=7
trellis, the scrambler) are built here.

``receive`` decodes a batch of frames of one rate and length, each in a
window that starts SEARCH samples before its first preamble sample:

  1. ``sync``: the trigger, the coarse CFO, the LTF timing and the fine
     CFO as the reference's sync_short and sync_long define them; derotate
     by the CFO; 64-point spectra of the two LTF symbols and of SIGNAL and
     the data symbols, each after its 16-sample guard;
  2. the LS estimate on the 52 used carriers: the mean of the two LTF
     spectra over the LTF's +-1;
  3. a symbol at a time, the tracker:
       phase  c = sum over the pilots of y[p] conj(h[p]) pol[s] pattern[p],
              yc = y conj(c) / |c|
       eq     = yc / h on the data carriers; csi = |h|^2, before the update
       x      = the nearest point of the frame's constellation to yc / h
              (SIGNAL: BPSK), the known values on the pilots
       LMS    h += mu (yc - h x) conj(x) / |x|^2
       STA    hi = yc conj(x) / |x|^2; nb[k] = mean of hi over carriers
              k-2 .. k+2, wrapping over the 52 used carriers;
              h = (1 - alpha) h + alpha ((1 - beta) hi + beta nb)
  4. max-log LLRs weighted by csi, deinterleave, depuncture, a Viterbi
     decoder over SERVICE, PSDU and tail (terminated in state 0),
     descramble with the seed read from SERVICE, PSDU bytes; SIGNAL's
     rate, length, parity and tail from its own 24-step trellis, its LLRs
     unweighted (as the port decodes SIGNAL);
  5. the EVM SNR of the equalized data symbols: decision-directed (the
     error against the nearest point, as the receiver itself can judge
     it) and, given the transmitted points, data-aided.

Departures from the reference's receiver (IRS_AP.py:139-141,
gr-ieee802-11): each window holds one frame, so detection is the first
trigger in it; the LTF search spans 416 positions from 160 samples before
the trigger (the port's window) where sync_long scans a stream; the whole
receiver is float64 where gr-ieee802-11 is float32; the LMS and STA
updates are the port's (a normalized LMS over all 52 carriers; STA's
spectral average with weight beta, where gr-ieee802-11's STA averages
over a window of carriers with weights it fixes itself); the decisions
are hard nearest points with ties to the first point in the standard's
bit order; the gains are ``PhyConfig``'s defaults unless given; the
decoder is a plain Viterbi over max-log LLRs weighted by |h|^2, where
gr-ieee802-11 demaps with its own soft scaling.
"""

from __future__ import annotations

import numpy as np
import torch

# -- the standard's tables ----------------------------------------------------

USED = [k for k in range(-26, 27) if k != 0]                 # carriers, ascending
PILOTS = [-21, -7, 7, 21]
PILOT_BASE = [1.0, 1.0, 1.0, -1.0]
DATA = [k for k in USED if k not in PILOTS]
LTF = [1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1, 1, 1, 1,
       1, -1, -1, 1, 1, -1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, -1, -1, 1, -1, 1, -1, 1, 1, 1, 1]
PREAMBLE, SYMBOL, GUARD = 320, 80, 16
LTF1, LTF2 = 192, 256                                        # first samples of the LTF bodies
SEARCH = 192                # samples a window holds before the truth start
THRESHOLD, PLATEAU = 0.56, 2     # sync_short's (wifi_phy_hier.grc)
MARGIN, LTF_SPAN = 160, 480      # sync_long's window before the trigger, its search span
# mcs -> (coded bits a carrier, coding rate, data bits a symbol)
RATES = [(1, (1, 2), 24), (1, (3, 4), 36), (2, (1, 2), 48), (2, (3, 4), 72),
         (4, (1, 2), 96), (4, (3, 4), 144), (6, (2, 3), 192), (6, (3, 4), 216)]
PUNCTURE = {(1, 2): [1, 1], (2, 3): [1, 1, 1, 0], (3, 4): [1, 1, 1, 0, 0, 1]}
# per-axis Gray maps, bits read first to last -> amplitude
AXIS = {1: {(0,): -1, (1,): 1},
        2: {(0, 0): -3, (0, 1): -1, (1, 1): 1, (1, 0): 3},
        3: {(0, 0, 0): -7, (0, 0, 1): -5, (0, 1, 1): -3, (0, 1, 0): -1,
            (1, 1, 0): 1, (1, 1, 1): 3, (1, 0, 1): 5, (1, 0, 0): 7}}
KMOD = {1: 1.0, 2: 1.0 / np.sqrt(2.0), 4: 1.0 / np.sqrt(10.0), 6: 1.0 / np.sqrt(42.0)}
G0, G1 = 0o133, 0o171                                        # generators, newest bit is bit 6
MU, ALPHA, BETA = 0.5, 0.5, 0.125                            # PhyConfig's tracker gains


def scrambler(state: list[int], n: int) -> np.ndarray:
    """n bits of the x^7 + x^4 + 1 scrambler from its 7 register bits
    (x1..x7); each output is x7 xor x4, shifted in at x1."""
    reg = list(state)
    out = np.empty(n, np.int64)
    for i in range(n):
        b = reg[6] ^ reg[3]
        out[i] = b
        reg = [b] + reg[:6]
    return out


POLARITY = 1.0 - 2.0 * scrambler([1] * 7, 127)               # pilot polarity p_0..p_126


def points(n_bpsc: int) -> np.ndarray:
    """(2^n_bpsc,) points, index = the bits in transmission order (first
    bit the most significant)."""
    out = np.empty(1 << n_bpsc, np.complex128)
    for v in range(1 << n_bpsc):
        bits = [(v >> (n_bpsc - 1 - i)) & 1 for i in range(n_bpsc)]
        if n_bpsc == 1:
            out[v] = AXIS[1][tuple(bits)]
        else:
            h = n_bpsc // 2
            out[v] = AXIS[h][tuple(bits[:h])] + 1j * AXIS[h][tuple(bits[h:])]
    return out * KMOD[n_bpsc]


def interleaver(n_bpsc: int) -> np.ndarray:
    """j[k]: the position that coded bit k of a symbol takes."""
    n_cbps = 48 * n_bpsc
    s = max(n_bpsc // 2, 1)
    k = np.arange(n_cbps)
    i = (n_cbps // 16) * (k % 16) + k // 16
    return s * (i // s) + (i + n_cbps - (16 * i) // n_cbps) % s


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


def trellis():
    """For each next state and predecessor k (0, 1): the predecessor
    state, and the two code bits of that branch. A state holds the 6
    newest input bits, the newest at bit 5."""
    prev = np.zeros((64, 2), np.int64)
    code = np.zeros((64, 2, 2), np.int64)
    for ns in range(64):
        b = ns >> 5
        for k in range(2):
            s = ((ns & 31) << 1) | k
            reg = (b << 6) | s
            prev[ns, k] = s
            code[ns, k] = _parity(reg & G0), _parity(reg & G1)
    return prev, code


# -- the receiver ---------------------------------------------------------------


def n_sym(mcs: int, length: int) -> int:
    return -(-(16 + 8 * length + 6) // RATES[mcs][2])


def _spectra(t: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft(t, dim=-1), dim=-1)


def _nearest(y: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The nearest point to each of y, ties to the first."""
    return pts[torch.argmin((y[..., None] - pts).abs() ** 2, dim=-1)]


def track(spectra: torch.Tensor, h: torch.Tensor, mcs: int, algo: str = "STA",
          mu: float = MU, alpha: float = ALPHA, beta: float = BETA):
    """The tracker over (B, S, 64) spectra whose symbol 0 is SIGNAL, from
    the LS estimate h (B, 52). Returns (eq, csi): (B, S, 48) complex and
    (B, S, 48) real, csi before each symbol's update."""
    dev = spectra.device
    used = torch.tensor(USED, device=dev) + 32
    data = torch.tensor([USED.index(k) for k in DATA], device=dev)
    pil = torch.tensor([USED.index(k) for k in PILOTS], device=dev)
    base = torch.tensor(PILOT_BASE, dtype=torch.float64, device=dev)
    bpsk = torch.from_numpy(points(1)).to(dev)
    pts = torch.from_numpy(points(RATES[mcs][0])).to(dev)
    eqs, csis = [], []
    for s in range(spectra.shape[1]):
        y = spectra[:, s, used]
        known = POLARITY[s % 127] * base
        c = (y[:, pil] * h[:, pil].conj() * known).sum(-1)
        yc = y * (c.conj() / c.abs())[:, None]
        eq = yc / h
        eqs.append(eq[:, data])
        csis.append(h[:, data].abs() ** 2)
        x = _nearest(eq, bpsk if s == 0 else pts)
        x[:, pil] = known.to(x.dtype)
        q = x.abs() ** 2
        if algo == "LMS":
            h = h + mu * (yc - h * x) * x.conj() / q
        elif algo == "STA":
            hi = yc * x.conj() / q
            nb = sum(torch.roll(hi, d, -1) for d in (-2, -1, 0, 1, 2)) / 5.0
            h = (1 - alpha) * h + alpha * ((1 - beta) * hi + beta * nb)
        else:
            raise ValueError(f"unknown tracker {algo!r}")
    return torch.stack(eqs, 1), torch.stack(csis, 1)


def ltf_time() -> np.ndarray:
    """The 64 samples of an LTF body (unscaled inverse FFT)."""
    spec = np.zeros(64, np.complex128)
    spec[np.array(USED) + 32] = LTF
    return np.fft.ifft(np.fft.ifftshift(spec))


def sync(x: torch.Tensor, threshold: float = THRESHOLD, plateau: int = PLATEAU):
    """Timing and CFO of (B, W) windows that begin SEARCH samples before
    each frame's first preamble sample, as the reference's sync blocks
    define them (sync_short, sync_long):

      a[n] = sum_{k=n-47..n} x[k] conj(x[k-16]), p[n] = sum_{k=n-63..n}
      |x[k]|^2; the trigger is the first n from which |a| / p >= threshold
      for ``plateau`` samples; the coarse CFO arg(a[trigger]) / 16;
      from trigger - 160 on, derotated by it, the first body of the LTF
      starts where |correlation with the LTF| over the two bodies, 64
      apart, peaks first (within 416 positions); the fine CFO is the
      angle between the two bodies over 64.

    Returns (first preamble sample in the window (B,), -1 where nothing
    triggers; CFO (B,) rad/sample)."""
    dev, b = x.device, x.shape[0]
    x = x.to(torch.complex128)
    m = torch.zeros_like(x)
    m[:, 16:] = x[:, 16:] * x[:, :-16].conj()
    a = torch.cumsum(m, -1)
    a[:, 48:] = a[:, 48:] - a[:, :-48].clone()
    e = torch.cumsum(x.abs() ** 2, -1)
    e[:, 64:] = e[:, 64:] - e[:, :-64].clone()
    above = a.abs() / e.clamp(min=1e-12) >= threshold
    above[:, :80] = False                  # the sums need 64 + 16 samples of history
    run = above.clone()
    for k in range(1, plateau):
        run[:, k:] &= above[:, :-k]
        run[:, :k] = False
    hit = run.any(-1)
    trigger = torch.argmax(run.to(torch.int8), -1) - (plateau - 1)
    rows = torch.arange(b, device=dev)
    coarse = torch.angle(a[rows, trigger]) / 16.0
    w0 = (trigger - MARGIN).clamp(min=0)
    n = torch.arange(LTF_SPAN + 63, device=dev)
    w = x[rows[:, None], (w0[:, None] + n).clamp(max=x.shape[1] - 1)] \
        * torch.exp(-1j * coarse[:, None] * n)
    ref = torch.from_numpy(ltf_time()).to(dev).conj()
    corr = (w.unfold(-1, 64, 1) * ref).sum(-1).abs()                  # (B, LTF_SPAN)
    q = torch.argmax(corr[:, :-64] + corr[:, 64:], -1) + 64           # second LTF body
    body = w[rows[:, None], q[:, None] + torch.arange(-64, 64, device=dev)]
    fine = torch.angle((body[:, 64:] * body[:, :64].conj()).sum(-1)) / 64.0
    start = torch.where(hit, w0 + q - LTF2, -1)
    return start, coarse + fine


def front(x: torch.Tensor, cfo: torch.Tensor, mcs: int, length: int):
    """(B, W) samples from each frame's first preamble sample, CFO (B,)
    rad/sample -> (LS estimate (B, 52), spectra (B, 1 + n_sym, 64))."""
    dev = x.device
    ns = n_sym(mcs, length)
    w = PREAMBLE + SYMBOL * (1 + ns)
    seg = x[:, :w].to(torch.complex128)
    seg = seg * torch.exp(-1j * cfo.to(torch.float64)[:, None] * torch.arange(w, device=dev))
    used = torch.tensor(USED, device=dev) + 32
    ltf = torch.tensor(LTF, dtype=torch.float64, device=dev)
    h = 0.5 * (_spectra(seg[:, LTF1: LTF1 + 64]) + _spectra(seg[:, LTF2: LTF2 + 64]))[:, used] * ltf
    idx = (PREAMBLE + GUARD + SYMBOL * torch.arange(1 + ns, device=dev))[:, None] \
        + torch.arange(64, device=dev)
    return h, _spectra(seg[:, idx])


def llrs(eq: torch.Tensor, csi: torch.Tensor, n_bpsc: int) -> torch.Tensor:
    """Max-log LLRs (B, S * 48 * n_bpsc), positive for a 1, weighted by csi."""
    pts = torch.from_numpy(points(n_bpsc)).to(eq.device)
    d = (eq[..., None] - pts).abs() ** 2                              # (B, S, 48, M)
    v = torch.arange(1 << n_bpsc, device=eq.device)
    out = []
    for i in range(n_bpsc):
        one = ((v >> (n_bpsc - 1 - i)) & 1).bool()
        out.append(d[..., ~one].amin(-1) - d[..., one].amin(-1))
    llr = torch.stack(out, -1) * csi[..., None]
    return llr.reshape(eq.shape[0], -1)


def viterbi(mother: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) LLR pairs (A, B code bits) -> (B, n) input bits, from
    state 0 and back from state 0."""
    dev = mother.device
    prev, code = (torch.from_numpy(a).to(dev) for a in trellis())
    sign = 2.0 * code.to(torch.float64) - 1.0                          # (64, 2, 2)
    b, n, _ = mother.shape
    pm = torch.full((b, 64), -1e300, dtype=torch.float64, device=dev)
    pm[:, 0] = 0.0
    dec = torch.empty((n, b, 64), dtype=torch.bool, device=dev)
    for i in range(n):
        gain = (mother[:, i, 0, None, None] * sign[..., 0]
                + mother[:, i, 1, None, None] * sign[..., 1])
        cand = pm[:, prev] + gain                                      # (B, 64, 2)
        d = cand[..., 1] > cand[..., 0]
        pm = torch.where(d, cand[..., 1], cand[..., 0])
        pm = pm - pm.amax(-1, keepdim=True)
        dec[i] = d
    state = torch.zeros(b, dtype=torch.long, device=dev)
    bits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(n - 1, -1, -1):
        bits[:, i] = (state >> 5).to(torch.uint8)
        state = prev[state, dec[i, rows, state].long()]
    return bits


def decode_bits(eq: torch.Tensor, csi: torch.Tensor, mcs: int, length: int) -> np.ndarray:
    """Equalized data symbols (B, n_sym, 48) and their csi -> PSDUs (B,
    length) uint8."""
    n_bpsc, rate, n_dbps = RATES[mcs]
    b, ns = eq.shape[0], eq.shape[1]
    llr = llrs(eq, csi, n_bpsc).reshape(b, ns, 48 * n_bpsc)
    llr = llr[:, :, torch.from_numpy(interleaver(n_bpsc)).to(eq.device)].reshape(b, -1)
    keep = np.resize(np.array(PUNCTURE[rate], bool), 2 * ns * n_dbps)
    mother = torch.zeros((b, keep.size), dtype=torch.float64, device=eq.device)
    mother[:, torch.from_numpy(np.flatnonzero(keep)).to(eq.device)] = llr
    n_info = 16 + 8 * length + 6
    bits = viterbi(mother[:, : 2 * n_info].reshape(b, n_info, 2)).cpu().numpy().astype(np.int64)
    # SERVICE's first 7 bits are scrambled zeros: the scrambler's first 7
    # outputs, from which p[n] = p[n-7] xor p[n-4] runs on (period 127)
    p = np.zeros((b, 127), np.int64)
    p[:, :7] = bits[:, :7]
    for i in range(7, 127):
        p[:, i] = p[:, i - 7] ^ p[:, i - 4]
    plain = bits ^ np.tile(p, -(-n_info // 127))[:, :n_info]
    return np.packbits(plain[:, 16: 16 + 8 * length].astype(np.uint8), axis=1, bitorder="little")


# SIGNAL's rate bits R1..R4 of each mcs (Table 17-6)
RATE_BITS = [(1, 1, 0, 1), (1, 1, 1, 1), (0, 1, 0, 1), (0, 1, 1, 1),
             (1, 0, 0, 1), (1, 0, 1, 1), (0, 0, 0, 1), (0, 0, 1, 1)]


def signal_field(eq0: torch.Tensor) -> list:
    """The SIGNAL symbols' equalized data carriers (B, 48) -> [(mcs or -1,
    length, parity and tail good)] (BPSK, rate 1/2, not scrambled: rate
    bits, a reserved bit, 12 length bits LSB first, even parity over the 17
    bits before it, 6 tail zeros). Its LLRs are not weighted by csi, as the
    port's SIGNAL decode does not weigh them."""
    b = eq0.shape[0]
    ones = torch.ones(eq0.shape, dtype=torch.float64, device=eq0.device)
    llr = llrs(eq0[:, None], ones[:, None], 1)[:, torch.from_numpy(interleaver(1)).to(eq0.device)]
    bits = viterbi(llr.reshape(b, 24, 2)).cpu().numpy().astype(np.int64)
    out = []
    for r in bits:
        rate = tuple(int(v) for v in r[:4])
        mcs = RATE_BITS.index(rate) if rate in RATE_BITS else -1
        length = int(sum(int(v) << i for i, v in enumerate(r[5:17])))
        out.append((mcs, length, int(r[:18].sum()) % 2 == 0 and not r[18:].any()))
    return out


def evm_snr_db(eq: torch.Tensor, mcs: int, sent: torch.Tensor | None = None) -> np.ndarray:
    """(B,) SNR in dB of (B, S, 48) equalized symbols: the mean power of
    the points over that of the error, against the nearest point or,
    given ``sent``, the transmitted one."""
    ref = _nearest(eq, torch.from_numpy(points(RATES[mcs][0])).to(eq.device)) \
        if sent is None else sent.to(eq.dtype)
    err = ((eq - ref).abs() ** 2).mean((-2, -1))
    sig = (ref.abs() ** 2).mean((-2, -1))
    return (10.0 * torch.log10(sig / err)).cpu().numpy()


def equalized(x, mcs: int, length: int, algo: str = "STA", mu: float = MU,
              alpha: float = ALPHA, beta: float = BETA):
    """Steps 1-3 for frames of one rate and length: x (B, W) samples from
    SEARCH before each first preamble sample (W at least SEARCH + 64 + the
    burst) -> SIGNAL's and the data symbols' (eq, csi), each (B, 1 + n_sym,
    48), and whether ``sync`` triggered (B,)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.as_tensor(x)
    start, cfo = sync(x)
    n = n_sym(mcs, length)
    rows = torch.arange(x.shape[0], device=x.device)
    idx = start.clamp(min=0)[:, None] + torch.arange(PREAMBLE + SYMBOL * (1 + n), device=x.device)
    seg = x.to(torch.complex128)[rows[:, None], idx.clamp(max=x.shape[1] - 1)]
    h, spec = front(seg, cfo, mcs, length)
    eq, csi = track(spec, h, mcs, algo, mu, alpha, beta)
    return eq, csi, start >= 0


def receive(x, mcs: int, length: int, algo: str = "STA", mu: float = MU,
            alpha: float = ALPHA, beta: float = BETA) -> dict:
    """The whole receiver over ``equalized``'s frames. Returns {"psdu" (B,
    length) uint8, "signal" [(mcs, length, ok)] as ``signal_field``, "eq"
    (B, n_sym, 48), "csi", "snr_db" decision-directed (B,)}."""
    eq, csi, found = equalized(x, mcs, length, algo, mu, alpha, beta)
    sig = [f if hit else (-1, 0, False)
           for f, hit in zip(signal_field(eq[:, 0]), found.tolist())]
    eq, csi = eq[:, 1:], csi[:, 1:]
    return {"psdu": decode_bits(eq, csi, mcs, length), "signal": sig, "eq": eq, "csi": csi,
            "snr_db": evm_snr_db(eq, mcs)}


def delivered(res: dict, mcs: int, psdus) -> np.ndarray:
    """(B,) whether ``receive``'s frames carry SIGNAL's rate and length with
    good parity and tail, and the PSDUs ``psdus`` (B, length)."""
    return np.array([sig == (mcs, p.size, True) and np.array_equal(got, p)
                     for sig, got, p in zip(res["signal"], res["psdu"], psdus)])
