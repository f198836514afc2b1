"""Hot-path ops: the rational resampler and FIR (``resampler``) and the
hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

    sync_stats   STF detector: dense statistics and the fused detector
                 (replace ops/pallas_sync.py and the detection around it)
    viterbi_acs  K=7 Viterbi ACS + traceback, several trellises a launch
                 (replaces ops/pallas_viterbi.py)
    fir          causal FIR (K3) and polyphase resampler (K4) (replace
                 ops/pallas_fir.py)
    track_eq     the LMS/STA tracking equalizer (K5): a batch of frames'
                 whole recursion a launch (replaces no TPU kernel; the
                 JAX package's lax.scan, phy/equalizer.py's loop on the CPU)

The sources live in ``csrc/`` and are compiled with nvcc at first use
(``ops/build.py``); nothing is compiled when a module is imported.
"""

from gnuradio_wifi_imagetransfer_tpu_torch.ops.resampler import (  # noqa: F401
    correct_sample_clock,
    design_lowpass,
    fir_filter,
    polyphase_resample,
    rational_resampler,
)
