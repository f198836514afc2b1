"""PyTorch + CUDA port of the 802.11a software-radio framework.

This package mirrors ``gnuradio_wifi_imagetransfer_tpu`` (the JAX/TPU
reference) module for module: ``config``, ``phy/``, ``ops/``,
``parallel/``, ``utils/`` and the CUDA sources under ``csrc/``. It imports
``torch`` and never ``jax`` or the JAX package.

Entry points (``phy.sync.receive``, ``phy.tx.transmit``,
``parallel.executor.StreamExecutor``) run on ``"cuda"`` unless the caller
passes ``device="cpu"``; asking for CUDA on a machine without it raises.
``ExecutorConfig(frontend=FrontendConfig(...))`` puts the rate-conversion
front-end (``parallel/frontend.py``) ahead of the executor's RX chain, and
``ops`` holds the stand-alone resampler and FIR. The hand-written kernels
(``ops/sync_stats.py``, ``ops/viterbi_acs.py``, ``ops/fir.py``) launch for
CUDA tensors and use their plain PyTorch versions only for CPU tensors.
"""
