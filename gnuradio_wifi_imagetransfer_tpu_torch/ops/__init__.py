"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

    sync_stats   fused STF detector statistics (replaces ops/pallas_sync.py)
    viterbi_acs  K=7 Viterbi ACS + traceback (replaces ops/pallas_viterbi.py)

The sources live in ``csrc/`` and are compiled with nvcc at first use
(``ops/build.py``); nothing is compiled when a module is imported.
"""
