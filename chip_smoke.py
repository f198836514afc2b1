#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py [--parent <checkout root>]
    python3 chip_smoke.py --fir-times <checkout root>

Drives the port's main paths through the entry points a user calls and
holds each hand-written kernel against its plain PyTorch version:

  1. builds the kernels from ``gnuradio_wifi_imagetransfer_tpu_torch/csrc``
     with nvcc (sm_90a) and prints the build seconds;
  2. prints the card's name and power limit (nvidia-smi);
  3. checks the dense sync-statistics kernel (K1) against its plain
     version on the executor's real blocks: one 263 840-sample row and
     the 64-row batch (atol 2e-4 on a and p, 1e-3 on c where p > 1e-3);
     then the fused STF detector (K1's redesign, ``sync_detect``) on the
     64 blocks with the executor's search bounds, on the flagship block,
     and on synthetic rows with edges at tile boundaries (991-993,
     1023-1025, 1983-1985, 2976), more than K edges in one tile and edges
     just inside and outside the search bounds: starts and valid exact,
     cfo within 1e-4
     and ratio within 1e-3 of ``sync_detect_plain``, and every field
     bit-identical to dense K1 plus the plain torch glue;
  4. checks the Viterbi kernel (K2) bit-exact against its plain version on
     256 x 422 and 256 x 24 LLRs that are random, punctured and tied, one
     segment a launch and both segments in one launch
     (``viterbi_decode_many``);
  5. checks the FIR kernel (K3) against its plain version (atol 2e-4): (2,
     300) with 5, 48, 129 and 200 taps; rows of 2047, 2048, 2049 and 4097
     samples (around the 2048-output tile) with 1, 65, 256, 257 and 1000
     taps (around the 256-tap chunk); all real and complex; (70 000,
     40), past 65 535 rows; (4, 4 194 304) complex with 65 taps; rows
     kept apart (batch isolation);
  6. checks the polyphase-resampler kernel (K4) against its plain version
     (atol 2e-4): ratios 1/2, 2/1, 3/4, 4/3, 5/2, real and complex, at
     (600,) and (2, 4, 90); rows around the 2048-output tile at 3/4, 1/2
     and 2/1; 1/96 (a smaller tile), phase rows of 16, 9 and 7000 taps
     (the generic loop, restaged passes); (70 000, 50) at 3/4; the
     full-width 3/4 front-end input (4 rows of 5.6 M samples); 25001/25000
     on (1, 1 048 576), past the int32 index range and through the phase
     table in L2, with an analytic tone within 1e-3;
  7. runs the flagship block: 4 frames (MCS 2, 50-byte PSDUs) made by the
     port's TX in a 32 768-sample block with seeded noise, through
     ``sync.receive`` with 8 slots on CUDA; all 4 frames must come back
     bit-exact and agree with the port's CPU path;
  8. runs the local ``StreamExecutor`` at the bench's device_step shape
     (4 channels x 16 blocks x 262 144 samples, sc16 wire, 4 slots, 3
     frames per block per channel); all 192 frames must come back
     bit-exact; prints the step rate timed with CUDA events and a profile;
  9. calls the stand-alone entry points: ``ops.fir_filter`` on the
     4-channel stream with a 65-tap low-pass (K3), ``sync.sync_stats`` on
     the executor's blocks (dense K1) and ``viterbi.decode`` on the
     step's payload trellises (K2, one segment);
 10. runs the same executor on a 4/3-rate capture of the same frames (FFT
     oversampled) with ``FrontendConfig(resample=(3, 4))``: the general
     front-end (K4) then the RX path; 192 of 192 frames bit-exact;
 11. the same on a 2x-oversampled capture skewed by +40 ppm with
     ``FrontendConfig(resample=(1, 2), ppm=40.0)`` (decimation and clock
     trim in torch ops); 192 of 192 frames bit-exact;
 12. runs the ``AdaptiveStreamExecutor`` (SIGNAL-steered reception) at
     the bench's adaptive shape (1 channel x 4 blocks x 262 144 samples,
     sc8, 128 slots a block) on bench.py's frames/s traffic, made by the
     port's TX on the card: a dense stream of 50-byte PSDUs at each MCS
     (447 to 511 frames) and the mixed stream, which rotates through the
     8 rates and carries MPDUs of ``mac.frame_batch``; every frame back
     bit-exact at its own rate, the mixed stream's FCS checked on the
     card (``mac.check_fcs_batch``, false after one flipped byte); every
     kernel call of each run is kept and made again through the kernel
     and its plain version on the same inputs: the detector on (4, 262
     960) with 128 slots and the owned search bounds as in phase 3, stage
     A's 512 x 24 SIGNAL trellises and each stage-B bucket's SIGNAL and
     payload trellises bit-exact; prints frames/s of timed runs on fresh
     noise (host clock around ``torch.cuda.synchronize``), the 9 streams
     in turns for 3 rounds (median and spread), with the Tracer's stage
     seconds, and a profile of one mixed run;
 13. the mixed stream again, from a 4/3-rate capture through
     ``FrontendConfig(resample=(3, 4))`` (K4 once): every frame bit-exact,
     K4 on the 1-row capture within 2e-4 of its plain version;
 14. the adaptive executor on a small mixed stream (4 x 16 384 samples)
     and ``AdaptiveReceiver`` on its first 32 768 samples, the card's
     results against the port's CPU path (exact fields, cfo within 1e-5,
     snr within 1e-3);
 15. the trackers: ``equalize`` with LMS, COMB and STA on the card within
     1e-4 of the CPU on the echo frame of tests/test_equalizer.py (64-QAM
     3/4, 400 bytes, an 8-sample echo by ``channel.multipath`` that grows
     and rotates), which LMS decodes bit-exact and LS does not; the
     adaptive executor with ``PhyConfig(chan_est=LMS)`` against the CPU;
 16. times the resident front-end correction pass (CUDA events) for
     decim2, ppm40 and general 3/4 at 2**22 padded outputs, left pad 256
     (the JAX bench's shape), in input Msamples/s;
 17. times each kernel (CUDA events) beside its plain version and bound:
     dense K1, the fused detector and dense K1 plus the torch glue it
     replaces, the segmented K2 and the same trellises as two one-segment
     launches, K2's chain floor, the detector, stage A's one-segment K2
     (the ``viterbi_decode`` row) and a stage-B bucket's K2 at the
     adaptive path's shapes, K3 and K4 with their share of bound and
     their conv1d yardsticks, K3 with its taps given as numpy and as a
     CUDA tensor (with ``--parent``, also the other checkout's K3 and K4
     in turns with this tree's, each in a process of its own);
 18. the radios on the Mode-2 traffic: one 300 x 300 x 3 image
     (``AppConfig.image_size``) cut by ``utils.image.detach_image`` into
     2 700 pieces, one 266-268-byte datagram each. ``LoopbackRadio`` at
     its defaults (MCS 3, 22 dB, batch 8) with the pieces sent at 1 ms
     spacing; then the live retune of tests/test_runtime.py (MCS 2, 25 dB,
     probes on; after half the pieces MCS 5, 30 dB, epsilon 2e-6, STA);
 19. ``TxRadio`` (MCS 2, batch 4, scale 0.5) into ``RxRadio`` (chunk 2**17,
     the default ExecutorConfig, probes on), the pieces at 5 ms spacing
     (about 14.8 M sc16 samples). Each radio run must bring every piece
     back to the app's socket and draw the image bit for bit, print no
     "dropped" line (stdout is captured while a radio runs: the radio
     loops catch exceptions, which would hide a failed launch), use the
     native UDP source and sink, and fill the probes where they are on;
     the first RADIO_HELD calls of each kernel in a run are held against
     their plain versions as in phase 12; sync_detect and
     viterbi_decode_many (and in phase 19 viterbi_decode) must launch,
     dense K1, K3 and K4 not. Prints pieces/s, the batch or chunk pass
     times, RxRadio's Tracer, a profiled batch and chunk, and K1 and K2
     timed at the radios' first calls beside their bounds;
 20. both modes' web apps over ``LoopbackRadio`` at its defaults, each image
     posted to the sender page as a browser does (multipart PNG). Mode 2:
     ``SenderApp`` -> the radio -> ``ReceiverApp`` with the AppConfig image
     (300 x 300 x 3); the canvas bit for bit, one SSE event, the RF panel
     (/constellation, /spectrum) and a live retune through POST /radio
     (MCS 5, 30 dB, 2e-6, STA, probes on) with a second run;
 21. Mode 1 at full width: ``JSCE.packaged()`` on the card (240 x 240,
     c = 128), warmed, two 240 x 240 kodim23 crops for users "3-4" and
     "13-10" posted to ``FeatureMapSenderApp``; its (30, 30, 128) latent as
     1 152 float32 pieces through the radio to ``FeatureMapReceiverApp`` on
     the card, which must hold it bit for bit and whose last
     reconstruction must be msg2img of the sent latent. The senders send
     one lap of pieces at a time, 1 ms apart (the reference's 50 ms would
     take 58 s a lap of the latent), and post again while the receiver is
     not whole. Each run prints no "dropped" line, launches
     ``sync_detect`` and ``viterbi_decode_many`` (dense K1, K3 and K4
     not), holds its first RADIO_HELD kernel calls against their plain
     versions, and prints pieces/s, batch times, decodes/s; then the
     codec's img2msg and msg2img (CUDA events, median of 20) and profiles;
 22. the codec on the card against its CPU path on the crops (latent
     within 1e-4, reconstructions within 1 LSB), then make_weights.py's
     held-out protocol (16 kodim23 crops, seed 123) on the card: PSNR
     and SSIM per user beside the npz meta's, PSNR no lower than the
     meta's less 0.5 dB (the meta was measured on a TPU);
 23. SV fading through the kernels (tests/test_channel.py:63-81 on the
     card): 2 frames of 100 bytes at MCS 7, six realisations of
     ``channel.sv.sv_impulse_response`` (6 taps, ray decay 1.5) from a
     CUDA generator, 30 dB, frequency offset 2e-3, the port's
     ``sync.receive`` on the card; at least 8 of 12 frames bit-exact, one
     ``sync_detect`` and one ``viterbi_decode_many`` a receive, every call
     held against its plain version;
 24. the IRS physics at full width: ``SOMANet.forward_physics`` (240 x 240,
     c = 128, 16 IRS elements, 2 users of 2 kodim23 crops) from the
     packaged npz on the card, channels from ``ClusteredIRSChannel`` (the
     trainer's ``Environment``) on a CUDA generator, AWGN passed in; the
     card's output within 2e-3 of the port's CPU path on the same inputs;
 25. training at the reference geometry: ``make_weights_torch.py
     --geometry ref --init-from-asset --steps 16`` in this process with
     ``--out`` a temporary directory (2 calls of ``train_steps``, K = 8,
     m2m, 2 users of 8 images of 240 x 240, c = 128, at the schedule's
     floor): every loss finite, ms a step (CUDA events, median of the
     second call's steps), peak memory, a profiled step's idle share; the
     written npz's held-out PSNR and SSIM by eval_holdout's protocol, no
     lower than the packaged npz meta's less 0.5 dB, and the npz through
     ``JSCE(weight_path=...)`` on the card; then one m2m step at the small
     geometry (80 x 80, c = 64, 2 images a user) on the card against the
     same step on the CPU: loss, every gradient and parameter, the batch
     statistics (tolerances at SMALL_*);
 26. the DQN IRS controller: tests/test_control.py's bandit (600 steps,
     ``DqnAgent(device="cuda")`` over ``IrsPowerEnv`` on the card), each
     greedy action after the warm-up pushed through ``IrsControlClient`` to
     a local ``IrsControlServer``: the greedy power within 1 dB of the
     best, every push arrived in order; the first 150 steps on the card and
     on the CPU from one set of initial parameters: equal actions, losses
     within 1e-5 relative; steps/s and the update's ms (CUDA events) at the
     bandit's and at the default configuration;
 27. the model zoo: ``mae_vit_base_patch16`` at full width (8 kodim23
     crops of 224 x 224, mask 0.75, noise from a CUDA generator, seeded
     weights): loss, forward ms (CUDA events, median of 20), peak memory, a
     profiled forward; at batch 2 the card's mask and ids equal to the CPU
     path's, loss and pred within tolerance; then ViT(), a Swin-T stage-1
     block and PatchMerging, ConditionalVAE(), ViTEncoder / ViTDecoder,
     GNN, PropagNet and CSAAFB each on the card against its CPU path
     (ZOO_RTOL);
 28. the (channel, time) mesh in a one-rank NCCL group
     (``init_process_group("nccl", "tcp://127.0.0.1:<free port>")``,
     destroyed after phase 30): ``make_mesh(4, 16)`` at the bench shape
     (blocks of 262 144, sc16, 4 slots) on 2 super-blocks, frames across
     every block seam and one flush against the stream's end; 3
     overlapping strides; every frame bit-exact and the good records equal
     to the local executor's on the same stream; one ``sync_detect`` and
     one ``viterbi_decode_many`` a step, no dense K1, K3 or K4, every
     call held against its plain version; ``mesh_step`` ms (CUDA events),
     the host layout ms and copy ms, a profiled step;
 29. the adaptive mesh (1 x 4 cells, 128 slots, sc8) on the mixed stream
     of two super-blocks against the local adaptive executor, and the
     front-end mesh (4 x 16, ``resample=(1, 2), ppm=40``) on phase 11's
     capture against phase 11's records, K1 and K2 held;
 30. the data-parallel trainer (a ``make_data_mesh`` over the group) for 2
     m2m steps at the reference geometry from the packaged npz against
     the local Trainer on the card, at the SMALL_* tolerances (parameters
     2 lr a step);
 31. the three root scripts at small settings, at once, each in its own
     process: ``demo_torch.py`` (48 x 48, the canvas bit for bit),
     ``tune_equalizer_torch.py`` (4 frames) and ``scaling_report_torch.py
     --procs 1`` (one NCCL rank);
 32. ``multichip_torch.py --procs N``, N = min(cards, 4), one NCCL rank a
     card (a group of one on a one-card machine): the fixed mesh at the
     bench shape and on JAX's dry-run layout, the adaptive and front-end
     meshes and the data-parallel trainer at full width, every frame
     bit-exact and equal to the local executors', the trainer within the
     SMALL_* tolerances of the one-rank Trainer with equal replicas, rank
     0's first K1 and K2 calls held; a rank that fails fails the phase;
 33. ``bench_torch.py`` in a process of its own with a 180 s budget over
     its phases device_small, device, pipeline, adaptive:2, adaptive:mix
     and frontend: exit code 0 (each phase checks its frames bit-exact and,
     on the card, that K1 and K2 launched), a value above 0 and every one
     of those phases in its result line, which is printed;
 34. the PER waterfall of tests/test_waterfall.py: ``rx.decode_aligned``
     on the card over AWGN (MCS 0-7, 16 frames of 100 bytes, the test's
     SNRs and one point in each MCS's falling edge) and over its 3-tap
     wandering fading (16 frames of 400 bytes at MCS 5, LS/LMS/COMB/STA at
     15, 25 and 35 dB), noise drawn in numpy; each decode launches K2 once
     and every call is held bit-exact; every point within one frame of the
     CPU path on the same arrays, and the test's assertions on the card's
     table;
 35. the Mode-2 soak of tests/test_soak.py at full scale: the port's
     SenderApp (kodim07 at 300 x 300, 2 700 pieces a lap, 2 ms spacing)
     -> a relay dropping 8 % of the datagrams -> LoopbackRadio (MCS 3,
     22 dB, batch 16) on the card -> ReceiverApp, until the canvas is
     bit-exact (600 s at most), no "dropped" line, K1 and K2 launched and
     their first calls held; the record of docs/soak_mode2.md is printed;
 36. the local executors' CUDA graphs (parallel/graphs.py) against the
     same executors run eagerly (``EagerGraphs``): the device_step shape's
     stream, and phase 12's dense MCS-0 and mixed streams, each run twice
     through the graphs (the first run captures, the second replays),
     every record bit for bit the eager run's, each step launching the
     detector and K2 once and each bucket K2 once, every kernel call of
     the replayed run held against its plain version; the step's ms by
     CUDA events and by the host clock, its device busy and activities (3
     profiled steps) and capture ms, eager and graph in turns; frames/s
     and stage-B host ms a bucket in turns; the graphs, their keys and
     ``memory_reserved``; LMS stage B of an 800-byte MCS-0 frame (268
     symbols unrolled into one graph): capture ms and the device
     activities of one bare replay; with ``--parent``, ``tools/step_ab.py``
     over both checkouts in turns;
 37. the serving programs' CUDA graphs (a LoopbackRadio group, a TxRadio
     group, the codec's encode and decode) against the same objects run
     eagerly (``EagerGraphs`` on their ``graphs``), in turns (eager,
     graph, graph, eager): LoopbackRadio at its defaults on phase 18's
     Mode-2 pieces at 1 ms (every piece, the canvas bit for bit, pieces/s,
     batch times; each group launching the detector and K2 once); the
     first recorded batches of that run again through both, at the
     defaults, with probes at MCS 2 and after a retune (MCS 5, 30 dB,
     2e-6, STA), every group's outputs and payloads bit for bit and every
     kernel call of the replays held against its plain version; TxRadio
     on the same batches, its samples bit for bit; ``JSCE.packaged()`` on
     phase 21's crops, the latent and both users' reconstructions bit for
     bit, then Mode 1 over LoopbackRadio at 1 ms into
     FeatureMapReceiverApp (the latent bit for bit, pieces/s, decodes/s,
     msg2img ms); for each a batch's or call's host ms, the group's or
     codec call's ms by CUDA events, device busy and activities of a
     profiled one, capture ms per key, the graphs' pools and
     ``memory_reserved``;
then one JSON line of kernel timings, bounds and launch counts (each
kernel's ``radio_launches`` are those of phases 18 and 19, its
``app_launches`` those of 20 and 21, ``sv_launches`` phase 23's,
``train_launches`` phase 25's, ``dqn_launches`` phase 26's,
``zoo_launches`` phase 27's, ``mesh_launches`` those of phases 28-30,
``multichip_launches`` rank 0's of each leg of phase 32,
``waterfall_launches`` phase 34's, ``soak_launches`` phase 35's,
``graph_launches`` the replayed runs' of phase 36 and
``serving_graph_launches`` the graph runs' of phase 37).

``--fir-times <checkout root>`` only times that checkout's K3 and K4 at
phase 17's shapes (three rounds of 20 calls, CUDA events) and prints one
JSON line; two checkouts are compared by running it in turns (A, B, B,
A). It builds the kernels into that checkout's own build directory.

Launch counts are set to 0 just before each main-path run (7 to 13, each
radio run of 18-19, the first run of each app phase, 20-21, the SV fading
receives of 23, the training script of 25, the controller's run of 26,
the zoo's runs of 27, each mesh run of 28-29, the data-parallel
trainer of 30, on every rank of phase 32, each leg's checked run, the
card's decodes of 34, the soak of 35, each run of 36 and each graph
run of 37) and read just after; launches made to compare or
time a kernel do not count. The training path, the controller and the zoo
run none of the four kernels (their convolutions are cuDNN's, their
products cuBLAS's), so their counts must stay 0.
A fixed-plan executor step launches the fused detector once and the
segmented Viterbi kernel once, and dense K1 not at all; an adaptive step
launches the fused detector once and the one-segment Viterbi kernel once
(stage A's SIGNAL trellises), and stage B the segmented one once a
(rate, length) bucket (1 on a dense stream, 8 on the mixed one); a
loopback group launches the detector once and the segmented Viterbi
kernel once. On the card the local executors, the radios and the codec
replay CUDA graphs, and a replay counts each kernel call its capture
logged, once.
This script keeps the phases; what other readers share is the package's:
the shapes, streams, waterfall and soak (``utils/scenarios.py``), the
card timers and call recording (``utils/tracing.py``), the holds against
the plain versions (``ops/holds.py``) and each kernel's bound (beside the
kernel, over the peaks of ``ops/roofline.py``).
The last line of stdout is {"ok": true, "device": {...}}. Any failure
exits non-zero. Without CUDA, or without the port package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "gnuradio_wifi_imagetransfer_tpu_torch"

# the shapes, streams, bounds, timers and holds are the port package's
# (the scenarios in utils/scenarios.py, the bounds beside their kernels)
try:
    from gnuradio_wifi_imagetransfer_tpu_torch.ops.fir import (
        fir_bound,
        resample_bound,
        resample_terms,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops.holds import (
        hold_detect,
        hold_recorded,
        max_err,
        merge_held,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops.roofline import bound_str
    from gnuradio_wifi_imagetransfer_tpu_torch.ops.sync_stats import (
        sync_detect_bound,
        sync_stats_bound,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops.viterbi_acs import (
        K2_ACS_CYCLES,
        K2_TRACEBACK_CYCLES,
        chain_floor_ms,
        viterbi_bound,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.scenarios import (
        ADAPTIVE_SHARDS,
        ADAPTIVE_SLOTS,
        BLOCK,
        CHANNELS,
        FADING,
        FRAMES_PER_BLOCK,
        MAX_FRAMES,
        MCS,
        MESH_SUPERBLOCKS,
        PSDU_LEN,
        SMALL_GRAD_ATOL,
        SMALL_GRAD_RTOL,
        SMALL_LOSS_RTOL,
        SMALL_LR,
        SMALL_STATS_ATOL,
        SOAK_TIMEOUT_S,
        TIME_BLOCKS,
        WATERFALL_FRAMES,
        WATERFALL_PSDU,
        adaptive_stream,
        fft_oversample,
        frame_errors,
        make_stream,
        run_soak,
        sample_clock_offset,
        seam_positions,
        waterfall_failures,
        waterfall_inputs,
        waterfall_tables,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.tracing import (
        cuda_event_ms,
        cuda_ms,
        device_profile,
        print_profile,
        recording,
    )
except ImportError as e:
    sys.exit(f"chip_smoke: FAILED: the port package {PKG} is not beside this script ({e})")

# the bench's front-end pass shape (bench.py: n_out_pad, left pad 256)
FE_OUT_PAD = 1 << 22
FIR_TAPS = 65
ADAPTIVE_ROUNDS = 3                  # timed runs of each stream, in turns (phase 12)

# the radios' traffic (phases 18-19): the Mode-2 deployment's image
# (AppConfig.image_size, 3 channels) in 10 x 10 pieces, 2 700 datagrams,
# sent at 1 ms (loopback) and 5 ms (TxRadio into RxRadio) spacing
RADIO_IMAGE = (300, 300, 3)
RADIO_SPACING = {"radio-loopback": 0.001, "radio-split": 0.005}
RADIO_HELD = 8                       # kernel calls a radio run holds against the plain versions
RADIO_PROFILE_PASS = 4               # the batch or chunk profiled again after a run

# the apps' traffic (phases 20-21): each sender re-sends its pieces in laps
# 1 ms apart (the reference's 50 ms would take 58 s a lap of the Mode-1
# latent's 1 152 pieces and 135 s of the Mode-2 image's 2 700)
APP_SPACING = 0.001
APP_TIMEOUT = 60.0                   # seconds a sender may take for one lap
APP_MAX_LAPS = 8                     # laps a run may take to bring the whole image or latent
# the Mode-1 users' images: the kodim23 crops (y, x) of tests/test_mode1_e2e.py
MODE1_IMAGE = "assets/kodim23.png"
MODE1_CROPS = {"3-4": (10, 20), "13-10": (250, 240)}
CODEC_TIMED = 20                     # img2msg and msg2img calls timed (CUDA events), median
CODEC_LATENT_ATOL = 1e-4             # the card's latent against the CPU path's
# make_weights.py's held-out protocol (eval_holdout): 16 crops of kodim23,
# seed 123. The npz meta's PSNR was measured at save time on a TPU, whose
# convolutions round otherwise than float32 on the card: the card may fall
# short of it by PSNR_MARGIN_DB
HOLDOUT_CROPS, HOLDOUT_SEED = 16, 123
PSNR_MARGIN_DB = 0.5

# the serving graphs (phase 37): the recorded batches of a LoopbackRadio
# run replayed against the eager radio, and the repetitions of a timed
# batch (host clock) or group or codec call (CUDA events)
SERVING_BATCHES = 24
SERVING_TIMED = 20

# the SV fading run (phase 23), tests/test_channel.py:63-81 on the card: 2
# frames of 100 bytes at MCS 7, six SV realisations (6 taps, ray decay
# 1.5), 30 dB, frequency offset 2e-3; at least 8 of the 12 frames
SV_MCS, SV_LEN, SV_FRAMES, SV_TRIALS, SV_MIN_DECODED = 7, 100, 2, 6, 8
SV_SNR_DB, SV_FO, SV_SEED = 30.0, 2e-3, 23
# the IRS physics run (phase 24): SOMANet.forward_physics at the reference
# geometry, 2 users of IRS_BATCH kodim23 crops, 16 IRS elements, 20 dB,
# the card's output against the CPU path's (ImageNet-normalised units, in
# which the reconstructions span about 4.6)
IRS_BATCH, IRS_N, IRS_SNR_DB, IRS_SEED = 2, 16, 20.0, 24
IRS_GEOMETRY = (240, 128, "jsce_soma_dscn_240.npz")      # image side, c, checkpoint
PHYSICS_ATOL = 2e-3
# the training run (phase 25): make_weights_torch.py in this process, then
# one m2m step at the small geometry (80 x 80, c = 64, 2 images a user) on
# the card against the same step on the CPU (at the SMALL_* tolerances)
TRAIN_ARGS = ["--geometry", "ref", "--init-from-asset", "--steps", "16"]
TRAIN_K = 8                          # make_weights_torch.py's steps a train_steps call at ref
SMALL_BATCH, SMALL_SEED = 2, 25

# the DQN controller (phase 26): tests/test_control.py:34-52's bandit on the
# card (IrsPowerEnv(n_grid=3, obs_dim=4), 9 actions, DQN_STEPS steps), each
# greedy action after the warm-up pushed to a local IrsControlServer; then
# the first DQN_PARITY_STEPS steps again on the card and on the CPU from one
# carried set of initial parameters and one environment: equal actions,
# losses within DQN_LOSS_RTOL; the update timed (CUDA events) at the bandit's
# batch and at the default DqnConfig on IrsPowerEnv() (16 actions, batch 64)
DQN_CFG = dict(obs_dim=4, batch_size=32, buffer_size=2000, eps_decay_steps=300, gamma=0.0,
               learning_rate=3e-3, target_update=25)
DQN_STEPS, DQN_PARITY_STEPS, DQN_SEED, DQN_TIMED = 600, 150, 1, 50
DQN_LOSS_RTOL = 1e-5
# the model zoo (phase 27): mae_vit_base_patch16 at full width (224 x 224,
# MAE_BATCH kodim23 crops, mask 0.75, noise from a CUDA generator) from
# seeded weights, timed (CUDA events, median of MAE_TIMED) and profiled;
# then at MAE_CHECK_BATCH, and each other zoo model, the card against the
# port's CPU path on the same weights and inputs: masks and ids exactly,
# outputs within ZOO_RTOL of their peak (ZOO_RTOL_DEEP for the ViT codec's
# 24 talking-heads layers, whose float32 runs lie 1-2e-4 of the peak from a
# float64 run on the CPU), the MAE loss within MAE_LOSS_RTOL
MAE_BATCH, MAE_CHECK_BATCH, MAE_TIMED, ZOO_SEED = 8, 2, 20, 27
ZOO_RTOL, ZOO_RTOL_DEEP, MAE_LOSS_RTOL = 1e-4, 5e-4, 1e-5

# the scripts (phase 31) run at small settings, each within SCRIPT_TIMEOUT
# seconds
SCRIPT_TUNE_FRAMES, SCRIPT_TIMEOUT = 4, 300
# phase 32: multichip_torch.py's limit a world, in seconds
MULTICHIP_TIMEOUT = 600
# phase 33: bench_torch.py's phases and its budget in seconds
BENCH_PHASES = ("device_small", "device", "pipeline", "adaptive:2", "adaptive:mix", "frontend")
BENCH_BUDGET_S = 180


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def fir_times(root: str) -> None:
    """Times the K3 and K4 of the port under root: fir_filter on (4, 4 194
    304) complex64 with 65 taps (numpy, then a CUDA tensor), and
    polyphase_resample at 3/4 on (4, 5 595 478) complex64 (the general
    front-end's input of phase 10) with design_lowpass(3, 4); three rounds
    of 20 calls each. Prints one JSON line."""
    import scipy.signal
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    # this script loaded its own checkout's package (the timers it keeps);
    # the kernels timed are root's
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from gnuradio_wifi_imagetransfer_tpu_torch import ops
        from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir
    except ImportError as e:
        fail(f"the port package {PKG} is not under {root} ({e})")
    check(os.path.abspath(fir.__file__).startswith(os.path.join(root, PKG)),
          f"{PKG} was imported from {fir.__file__}, not from {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def cplx(shape):
        v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(v.astype(np.complex64)).to(dev)

    x3, h3 = cplx((CHANNELS, 1 << 22)), scipy.signal.firwin(FIR_TAPS, 0.5).astype(np.float32)
    h3_dev = torch.from_numpy(h3).to(dev)
    x4, h4 = cplx((CHANNELS, 5_595_478)), ops.design_lowpass(3, 4)
    out = {"root": root, "fir_ms": [], "fir_device_taps_ms": [], "resample_ms": []}
    for _ in range(3):
        out["fir_ms"].append(cuda_ms(lambda: fir.fir_filter(x3, h3), 20))
        out["fir_device_taps_ms"].append(cuda_ms(lambda: fir.fir_filter(x3, h3_dev), 20))
        out["resample_ms"].append(cuda_ms(lambda: fir.polyphase_resample(x4, 3, 4, h4), 20))
    print(json.dumps(out))


def fir_times_of(root: str) -> dict:
    """fir_times(root) in a process of its own (one port package a
    process); its failure is this run's."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--fir-times", root],
                       capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"--fir-times {root} exited {r.returncode}: {r.stderr.strip()[-2000:]}")
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"--fir-times {root} printed no JSON line: {r.stdout[-2000:]}")


def burst_rows(n: int, edges_per_row, min_plateau: int, seed: int):
    """Rows of faint noise with 48-sample bursts of a unit-magnitude
    16-periodic signal, each placed so that its rising detection edge
    falls at the given index (c first reaches 0.56 36 samples into a
    burst: 21/37 there, 20/36 a sample before)."""
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal((len(edges_per_row), n))
                + 1j * rng.standard_normal((len(edges_per_row), n)))
    for row, edges in enumerate(edges_per_row):
        for e in edges:
            p = e - 36 - (min_plateau - 1)
            theta = rng.uniform(0, 2 * np.pi, 16)
            x[row, p: p + 48] = np.exp(1j * theta[np.arange(48) % 16])
    return x.astype(np.complex64)


def fresh(x: np.ndarray, seed: int) -> np.ndarray:
    """A byte-distinct copy of a stream for a timed run (bench.py _fresh):
    fresh noise at 2e-3, 48 dB below the bursts."""
    rng = np.random.default_rng(7000 + seed)
    return (x + 2e-3 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
            ).astype(np.complex64)


def same_records(got, want, label: str) -> None:
    """The card's frame records against the CPU path's: exact fields, cfo
    within 1e-5, snr within 1e-3."""
    check(len(got) == len(want), f"{label}: {len(got)} records on the card, {len(want)} on "
                                 f"the CPU")
    for g, w in zip(got, want):
        check((g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok)
              == (w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
              and np.array_equal(g.psdu, w.psdu) and abs(g.cfo - w.cfo) <= 1e-5
              and abs(g.snr_db - w.snr_db) <= 1e-3,
              f"{label}: the card's record {g} differs from the CPU's {w}")


def identical_records(got, want, label: str) -> None:
    """Two runs' frame records bit for bit: every field equal, the float
    ones (cfo, snr, captured symbols) included."""
    check(len(got) == len(want), f"{label}: {len(got)} records against {len(want)}")
    for g, w in zip(got, want):
        check((g.channel, g.global_start, g.rate_idx, g.length, g.parity_ok)
              == (w.channel, w.global_start, w.rate_idx, w.length, w.parity_ok)
              and np.array_equal(g.psdu, w.psdu)
              and np.array_equal(np.float32([g.cfo, g.snr_db]), np.float32([w.cfo, w.snr_db]),
                                 equal_nan=True)
              and (g.eq_symbols is None) == (w.eq_symbols is None)
              and (g.eq_symbols is None or np.array_equal(g.eq_symbols, w.eq_symbols)),
              f"{label}: record {g} differs from {w}")


def adaptive_phases(dev, card: str, reset, counts) -> dict:
    """Phases 12-15: the SIGNAL-steered path at the bench's adaptive shape,
    through the 3/4 front-end, against the CPU path, and with the trackers.
    Returns the adaptive frames/s by stream (median of the rounds), the
    MCS-2 dense run's launches and kernel inputs, the kernels held
    against their plain versions ({kernel: (max error, input shapes)}) and
    the streams ({label: (stream, PSDUs, rates, ...)})."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.channel import model as channel
    from gnuradio_wifi_imagetransfer_tpu_torch.config import (
        ChannelEstimator,
        ExecutorConfig,
        FrontendConfig,
        PhyConfig,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
        AdaptiveReceiver,
        AdaptiveStreamExecutor,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import resampler
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import equalizer, mac, rx, tx
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

    span = ADAPTIVE_SHARDS * BLOCK
    acfg = ExecutorConfig(block_size=BLOCK, time_shards=ADAPTIVE_SHARDS,
                          max_frames_per_block=ADAPTIVE_SLOTS, wire_format="sc8")
    # the module attributes through which the path reaches its kernels
    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"),
               (resampler, "polyphase_resample"))
    held: dict = {}             # kernel -> (max error, input shapes) over the runs

    def run_checked(aex, x, psdus, mcs_seq, label, n_buckets, also=()):
        """One run of the main path, launches counted from 0: every frame
        back bit-exact at its own rate; a detector and a SIGNAL Viterbi
        launch a step, one payload launch a dispatched bucket, no dense K1.
        Then every kernel call of the run again, against its plain version
        on the same inputs (after the counts are read)."""
        reset()
        t0 = time.perf_counter()
        with recording(*targets) as calls:
            recs = aex.run(x)
        launches = counts()
        dt = time.perf_counter() - t0
        got = {(r.rate_idx, tuple(r.psdu)) for r in recs if r.parity_ok}
        missing = [i for i, (m, f) in enumerate(zip(mcs_seq, psdus))
                   if (int(m), tuple(f)) not in got]
        check(not missing, f"{label}: frames {missing[:10]} (of {len(psdus)}) not recovered "
                           f"at their rates")
        steps = len(range(0, aex.effective_len(x.shape[1]), span))
        # every candidate gets a record; a step dispatches one bucket a
        # (rate, length) among its candidates
        buckets = len({(r.global_start // span, r.rate_idx, r.length) for r in recs})
        check(launches["sync_detect"] == steps and launches["viterbi_decode"] == steps
              and launches["sync_stats"] == 0 and launches["viterbi_decode_many"] == buckets
              and buckets == n_buckets and all(launches[k] == v for k, v in also),
              f"{label}: launches {launches} for {steps} steps and {buckets} buckets "
              f"(expected {n_buckets})")
        merge_held(held, hold_recorded(calls, label))
        return recs, launches, dt, calls

    # -- 12. adaptive executor at the bench's shape ------------------------
    rng = np.random.default_rng(12)
    aex = AdaptiveStreamExecutor(exec_cfg=acfg, device=dev)
    streams = {}
    mixed = None
    for mcs in list(range(8)) + [None]:
        label = f"adaptive MCS {mcs}" if mcs is not None else "adaptive mixed"
        x, psdus, mcs_seq = adaptive_stream(tx, mac, mcs, span, rng, dev)
        recs, launches, warm, calls = run_checked(aex, x, psdus, mcs_seq, label,
                                                  1 if mcs is not None else 8)
        streams[label] = (x, psdus, mcs_seq, len(recs), warm, launches)
        if mcs == MCS:
            # a dense stream's kernel inputs and launches, for phase 17
            main = {"launches": launches, **{k: calls[k][0][0] for k in (
                "sync_detect", "viterbi_decode", "viterbi_decode_many")}}
        if mcs is None:
            mixed = (x, psdus, mcs_seq)
            # the FCS of every decoded MPDU, on the card; one flipped byte
            mpdus = torch.from_numpy(np.stack([r.psdu for r in recs if r.parity_ok])).to(dev)
            fcs_ok = mac.check_fcs_batch(mpdus)
            mpdus[:, 30] ^= 0x20
            fcs_bad = mac.check_fcs_batch(mpdus)
            check(bool(fcs_ok.all()) and not bool(fcs_bad.any()),
                  f"{label}: FCS on the card {int(fcs_ok.sum())}/{len(fcs_ok)} true, "
                  f"{int(fcs_bad.sum())} true after a flipped byte")
            print(f"{label}: FCS checked on the card: {len(fcs_ok)}/{len(fcs_ok)} MPDUs "
                  f"valid, none after one flipped byte")
    shapes = {k: sorted({str(s) for s in v[1]}) for k, v in held.items()}
    print(f"adaptive runs: every kernel call held against its plain version on the same "
          f"inputs: max error {json.dumps({k: v[0] for k, v in held.items()})} (detector cfo "
          f"1e-4 and ratio 1e-3, starts and valid exact; K2 bit-exact); inputs "
          f"{json.dumps(shapes)}")

    # timed runs on fresh noise, the 9 streams in turns, ADAPTIVE_ROUNDS
    # rounds: the spread of one stream within a call
    fps_runs = {label: [] for label in streams}
    for rnd in range(ADAPTIVE_ROUNDS):
        for i, (label, (x, psdus, mcs_seq, *_)) in enumerate(streams.items()):
            xt = fresh(x, 10 + i + 100 * rnd)
            aex.tracer = tracing.Tracer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs_t = aex.run(xt)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {(r.rate_idx, tuple(r.psdu)) for r in recs_t if r.parity_ok}
            check(all((int(m), tuple(f)) in got for m, f in zip(mcs_seq, psdus)),
                  f"{label}: the timed run lost frames")
            fps_runs[label].append(len(psdus) / dt)
            stages = {k: round(v.seconds * 1e3, 3) for k, v in aex.tracer.report().items()}
            print(f"{label}, round {rnd}: {dt * 1e3:.1f} ms, {len(psdus) / dt:.0f} frames/s; "
                  f"stage ms {json.dumps(stages)}")
    fps = {}
    for label, (x, psdus, _, n_recs, warm, launches) in streams.items():
        runs = fps_runs[label]
        fps[label] = float(np.median(runs))
        print(f"{label}: {len(psdus)} frames in {tuple(x.shape)} sc8, {n_recs} records, "
              f"bit-exact at their rates; warm run {warm * 1e3:.1f} ms; timed runs on fresh "
              f"noise in turns {[round(v) for v in runs]} frames/s, median {fps[label]:.0f}, "
              f"spread {100 * (max(runs) - min(runs)) / fps[label]:.0f} %; launches "
              f"{json.dumps(launches)} ({card})")
    x, psdus, mcs_seq = mixed
    print_profile("adaptive mixed run", device_profile(lambda: aex.run(x)))

    # -- 13. the mixed stream through the general front-end (3/4) ----------
    up4 = fft_oversample(torch.from_numpy(x).to(dev), 4)
    cap = up4[:, ::3].cpu().numpy()
    del up4
    fex = AdaptiveStreamExecutor(exec_cfg=dataclasses.replace(
        acfg, frontend=FrontendConfig(resample=(3, 4))), device=dev)
    n_held = len(held.get("polyphase_resample", (0, []))[1])
    recs, launches, dt, _ = run_checked(fex, cap, psdus, mcs_seq,
                                        "adaptive mixed, resample=(3, 4)", 8,
                                        also=(("polyphase_resample", 1),))
    k4_err, k4_shapes = held.get("polyphase_resample", (0.0, []))
    check(len(k4_shapes) == n_held + 1, "adaptive mixed, resample=(3, 4): K4 not held")
    print(f"adaptive mixed, resample=(3, 4), input {cap.shape}: {len(psdus)}/{len(psdus)} "
          f"frames bit-exact ({dt:.2f} s wall); K4 on {k4_shapes[-1]} within {k4_err:.3g} of "
          f"its plain version (2e-4); launches {json.dumps(launches)}")

    # -- 14. the card against the CPU path ---------------------------------
    small, s_psdus, s_seq = adaptive_stream(tx, mac, None, 4 * 16384, rng, dev)
    scfg = ExecutorConfig(block_size=16384, time_shards=4, max_frames_per_block=8,
                          wire_format="sc8")
    got = AdaptiveStreamExecutor(exec_cfg=scfg, device=dev).run(small)
    same_records(got, AdaptiveStreamExecutor(exec_cfg=scfg, device="cpu").run(small),
                 "adaptive small mixed")
    check({(int(m), tuple(f)) for m, f in zip(s_seq, s_psdus)}
          <= {(r.rate_idx, tuple(r.psdu)) for r in got if r.parity_ok},
          "adaptive small mixed: frames lost")
    arx = dict(max_psdu=256, max_frames=8)
    g_frames = AdaptiveReceiver(device=dev, **arx).receive(small[0, :32768])
    c_frames = AdaptiveReceiver(device="cpu", **arx).receive(small[0, :32768])
    check(len(g_frames) == len(c_frames) >= 6 and all(
        (g.start, g.rate_idx, g.length) == (c.start, c.rate_idx, c.length)
        and np.array_equal(g.psdu, c.psdu) and abs(g.cfo - c.cfo) <= 1e-5
        for g, c in zip(g_frames, c_frames)),
        f"AdaptiveReceiver: the card's {len(g_frames)} frames differ from the CPU's "
        f"{len(c_frames)}")
    print(f"adaptive executor on {small.shape} (8 rates, sc8): {len(got)} records equal the "
          f"CPU path's; AdaptiveReceiver on 32768 samples: {len(g_frames)} frames equal the "
          f"CPU path's")

    # -- 15. the trackers on the card ---------------------------------------
    # tests/test_equalizer.py's integration frame: 64-QAM 3/4, 400 bytes,
    # an 8-sample echo (channel.multipath) that grows to 0.4 and rotates
    erng = np.random.default_rng(9)
    frame = erng.integers(0, 256, (1, 400), dtype=np.uint8)
    burst = tx.transmit(frame, 7, device=dev)
    nb = burst.shape[-1]
    gain = torch.from_numpy((np.linspace(0.0, 0.4, nb) * np.exp(
        2j * np.pi * np.arange(nb) / 6000.0)).astype(np.complex64)).to(dev)
    y = burst + gain * channel.multipath(burst, [0.0] * 8 + [1.0])
    y = y + torch.from_numpy((1e-3 * (erng.standard_normal(nb) + 1j * erng.standard_normal(
        nb))).astype(np.complex64)).to(dev)
    plan = tx.tx_plan(7, 400)
    ltf1, ltf2, spectra = rx.frame_spectra(y, plan.n_sym, 0)
    h0 = equalizer.ls_estimate(ltf1, ltf2)
    eq_err = 0.0
    for algo in (ChannelEstimator.LMS, ChannelEstimator.COMB, ChannelEstimator.STA):
        for g, c in zip(equalizer.equalize(spectra, h0, 0, algo, 7),
                        equalizer.equalize(spectra.cpu(), h0.cpu(), 0, algo, 7)):
            e = max_err(g.cpu(), c)
            check(e <= 1e-4, f"equalize {algo.name} on the card: {e:.3g} from the CPU (1e-4)")
            eq_err = max(eq_err, e)
    errs = {a.name: int((rx.decode_aligned(y, plan, algo=a).psdu.cpu().numpy() != frame).sum())
            for a in (ChannelEstimator.LS, ChannelEstimator.LMS)}
    check(errs["LMS"] == 0 and errs["LS"] > 50,
          f"echo frame on the card: byte errors {errs} (LMS must be 0, LS > 50)")
    lcfg = dict(exec_cfg=scfg, phy_cfg=PhyConfig(chan_est=ChannelEstimator.LMS))
    same_records(AdaptiveStreamExecutor(device=dev, **lcfg).run(small),
                 AdaptiveStreamExecutor(device="cpu", **lcfg).run(small),
                 "adaptive small mixed, LMS")
    print(f"trackers on the card: equalize LMS/COMB/STA within {eq_err:.3g} of the CPU "
          f"(1e-4); echo frame byte errors {json.dumps(errs)}; adaptive LMS records equal "
          f"the CPU path's")
    return fps, main, held, streams


class _AppSide:
    """The receiving app of the Mode-2 traffic: a thread that reads the
    radio's datagrams (bare pickled pieces) from a UDP socket and draws
    them into a canvas."""

    def __init__(self, img: np.ndarray):
        import socket
        import threading

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.img = img
        self.canvas = np.zeros_like(img)
        self.seen: set = set()
        self.datagrams = 0
        self.t_last = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import pickle
        import socket

        from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            piece = pickle.loads(data)
            image.redraw_image(piece, self.canvas)
            self.seen.add(piece[0])
            self.datagrams += 1
            self.t_last = time.perf_counter()

    def wait(self, n: int, timeout: float) -> None:
        """Until n distinct pieces arrived, or timeout seconds of none."""
        t_check, have = time.perf_counter(), -1
        while len(self.seen) < n and time.perf_counter() - t_check < timeout:
            if len(self.seen) != have:
                t_check, have = time.perf_counter(), len(self.seen)
            time.sleep(0.05)

    def reset(self) -> None:
        self.canvas[:] = 0
        self.seen.clear()
        self.datagrams = 0

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.sock.close()


def send_paced(pieces, port: int, spacing: float) -> float:
    """Each piece as one datagram to port, the i-th at i * spacing seconds;
    returns the seconds the sends took."""
    import socket

    from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.perf_counter()
    for i, p in enumerate(pieces):
        delay = t0 + i * spacing - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sock.sendto(image.encode_piece(p), ("127.0.0.1", port))
    sock.close()
    return time.perf_counter() - t0


class _Passes:
    """Times each call of ``obj.<attr>`` (a radio's ``_process``: a batch or
    a chunk; a codec's ``msg2img``) and keeps a copy of the arguments of
    call number ``capture`` (from 0; of the last call when there are
    fewer)."""

    def __init__(self, obj, capture: int, attr: str = "_process"):
        self.fn, self.capture = getattr(obj, attr), capture
        self.seconds: list[float] = []
        self.args = None
        setattr(obj, attr, self)

    def __call__(self, *args, **kwargs):
        if len(self.seconds) <= self.capture:
            self.args = tuple(a.copy() if hasattr(a, "copy") else a for a in args)
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds.append(time.perf_counter() - t0)

    def summary(self) -> str:
        v = np.array(self.seconds) * 1e3
        return (f"{v.size} passes, median {np.median(v):.2f} ms, spread {v.min():.2f}-"
                f"{v.max():.2f} ms (p10 {np.percentile(v, 10):.2f}, p90 "
                f"{np.percentile(v, 90):.2f})")


class _InFlight:
    """The peak of the samples a TxRadio has sent and its RxRadio has not
    yet read (what waits in the sample socket's queue), polled from the
    radios' counters every 10 ms in a thread."""

    def __init__(self, txr, rxr):
        import threading

        self.txr, self.rxr, self.peak = txr, rxr, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak,
                            self.txr.stats["samples_tx"] - self.rxr.stats["samples_in"])
            time.sleep(0.01)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)


def input_numel(call) -> int:
    """Elements of a recorded kernel call's first argument (a tensor, or
    a list of segment tensors)."""
    first = call[0][0]
    return sum(t.numel() for t in first) if isinstance(first, list) else first.numel()


class _ListSink:
    """A radio sink that keeps the payloads (profiled re-runs emit nothing)."""

    def __init__(self):
        self.payloads = []

    def send_mac_payload(self, payload):
        self.payloads.append(payload)

    def close(self):
        pass


def radio_phases(dev, card: str, reset, counts, held: dict, shape=RADIO_IMAGE,
                 spacing=RADIO_SPACING) -> dict:
    """Phases 18-19: the radios at their constructor defaults on the
    Mode-2 traffic (one image of ``shape`` in 10 x 10 pieces, one
    datagram each). 18: LoopbackRadio, then the live retune of
    tests/test_runtime.py; 19: TxRadio into RxRadio. Each run must deliver
    every piece, draw the image bit for bit and print no "dropped" line
    (stdout is captured while a radio runs); the first RADIO_HELD calls of
    each kernel in a run are held against their plain versions (into
    ``held``). Returns each phase's launches and, for each phase, the
    largest call of each kernel in a batch or chunk run again after it
    ({phase: {kernel: (args, kwargs)}})."""
    import io
    import socket

    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import bridge, native
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    rng = np.random.default_rng(18)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    pieces = image.detach_image(img, rng=rng)
    n = len(pieces)
    sizes = sorted({len(image.encode_piece(p)) for p in pieces})
    app = _AppSide(img)
    try:
        rmem = open("/proc/sys/net/core/rmem_max").read().strip()
    except OSError:
        rmem = "unknown"
    print(f"radio traffic: {n} pieces of an image {shape} (AppConfig), datagrams of {sizes} "
          f"bytes; net.core.rmem_max {rmem}")

    def run(label, radios, in_port, part, spacing_s, then=None):
        """One radio run: radios started, part sent paced (then ``then()``,
        which sends the rest), every piece of the image back within 60 s
        of the last one, the canvas bit for bit, no "dropped" line.
        Returns (wall s, send s, launches, held calls)."""
        app.reset()
        out = io.StringIO()
        reset()
        with recording(*targets, keep=RADIO_HELD) as calls, contextlib.redirect_stdout(out):
            for r in radios:
                r.start()
            t0 = time.perf_counter()
            t_send = send_paced(part, in_port, spacing_s)
            if then is not None:
                t_send += then()
            app.wait(n, 60.0)
            wall = (app.t_last or time.perf_counter()) - t0
            for r in radios:
                r.stop()
        launches = counts()
        log = out.getvalue()
        if log:
            print(log, end="")
        stats = {type(r).__name__: r.stats for r in radios}
        check("dropped" not in log, f"{label}: a radio dropped a batch or chunk:\n{log[-2000:]}")
        check(len(app.seen) == n, f"{label}: {len(app.seen)}/{n} pieces delivered; {stats}")
        check(np.array_equal(app.canvas, img), f"{label}: the canvas differs from the image")
        return wall, t_send, launches, hold_recorded(calls, label)

    def again(label, what, radio, fn):
        """One pass of a run again, after it (the sink a list): profiled,
        and its kernel calls kept, the largest of each kernel in
        ``inputs[label]`` (the shapes the steady radio gives them)."""
        radio.sink = _ListSink()
        with recording(*targets) as calls:
            prof = device_profile(fn)
        print_profile(f"{label}, {what} ({card})", prof)
        inputs[label] = {k: max(v, key=input_numel) for k, v in calls.items() if v}

    def check_launches(label, launches, need):
        check(all(launches[k] > 0 for k in need)
              and all(launches[k] == 0 for k in ("sync_stats", "fir_filter",
                                                 "polyphase_resample")),
              f"{label}: launches {launches} (need {need} > 0, and no dense K1, K3 or K4)")

    phases, inputs = {}, {}
    # -- 18. LoopbackRadio at its defaults, then the live retune -----------
    radio = bridge.LoopbackRadio(in_port=0, out_port=app.port, device=dev)
    check(isinstance(radio.source, native.NativeUdpSource)
          and isinstance(radio.sink, bridge.NativeExtractSink),
          f"radio-loopback: not the native source and sink ({type(radio.source).__name__}, "
          f"{type(radio.sink).__name__})")
    passes = _Passes(radio, capture=RADIO_PROFILE_PASS)
    wall, t_send, launches, out = run("radio-loopback", [radio], radio.in_port, pieces,
                                      spacing["radio-loopback"])
    merge_held(held, out)
    check_launches("radio-loopback", launches, ("sync_detect", "viterbi_decode_many"))
    batches = len(passes.seconds)
    print(f"radio-loopback: LoopbackRadio(mcs {radio.mcs}, snr {radio.snr_db} dB, batch "
          f"{radio.batch}), source {type(radio.source).__name__}, sink "
          f"{type(radio.sink).__name__}: {n}/{n} pieces, canvas bit for bit, no dropped line; "
          f"sent at {1e3 * spacing['radio-loopback']:g} ms spacing in {t_send:.2f} s; wall "
          f"{wall:.2f} s, {n / wall:.0f} pieces/s; stats {json.dumps(radio.stats)}; batch "
          f"times {passes.summary()}; launches {json.dumps(launches)} "
          f"({launches['sync_detect'] / batches:.2f} sync_detect and "
          f"{launches['viterbi_decode_many'] / batches:.2f} viterbi_decode_many a batch over "
          f"{batches} batches); held "
          f"{json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})}; "
          f"{graph_stats(radio.graphs)} ({card})")
    again("radio-loopback", f"one batch of {len(passes.args[0])} datagrams", radio,
          lambda: radio._process(*passes.args))
    phase_launches = dict(launches)

    retune = bridge.LoopbackRadio(in_port=0, out_port=app.port, mcs=2, snr_db=25.0,
                                  probes=True, device=dev)
    half = n // 2

    def second_part():
        """Retune live (MCS 5, SNR 30 dB, epsilon 2e-6, STA) once the first
        part is back, then send the rest."""
        app.wait(half, 60.0)
        check(len(app.seen) == half, f"radio-loopback retune: {len(app.seen)}/{half} pieces "
                                     f"before the retune")
        retune.set_encoding(5)
        retune.set_snr(30.0)
        retune.set_epsilon(2e-6)
        retune.set_chan_est(3)
        return send_paced(pieces[half:], retune.in_port, spacing["radio-loopback"])

    wall, t_send, launches, out = run("radio-loopback retune", [retune], retune.in_port,
                                      pieces[:half], spacing["radio-loopback"],
                                      then=second_part)
    merge_held(held, out)
    check_launches("radio-loopback retune", launches, ("sync_detect", "viterbi_decode_many"))
    check(retune.constellation.points().shape[0] > 0 and retune.spectrum.psd_db().max() > -200
          and np.isfinite(retune.snr_probe.snr_db()), "radio-loopback retune: probes not filled")
    print(f"radio-loopback retune: MCS 2 -> 5, SNR 25 -> 30 dB, epsilon 0 -> 2e-6, LS -> STA "
          f"after {half} pieces: {n}/{n} pieces, canvas bit for bit; wall {wall:.2f} s; "
          f"probes: {retune.constellation.points().shape[0]} points, PSD max "
          f"{retune.spectrum.psd_db().max():.1f} dB, SNR {retune.snr_probe.snr_db():.1f} dB; "
          f"launches {json.dumps(launches)}; {graph_stats(retune.graphs)}, capture ms by key "
          f"(MCS, MPDU bytes, group, equalizer, probes) "
          f"{ {k: round(v[1], 1) for k, v in retune.graphs.stats.items()} } ({card})")
    phases["radio-loopback"] = {k: v + launches[k] for k, v in phase_launches.items()}

    # -- 19. TxRadio into RxRadio ------------------------------------------
    rxr = bridge.RxRadio(samp_port=0, out_port=app.port, device=dev)
    txr = bridge.TxRadio(in_port=0, samp_port=rxr.samp_port, device=dev)
    check(isinstance(txr.source, native.NativeUdpSource)
          and isinstance(rxr.sink, bridge.NativeExtractSink),
          f"radio-split: not the native source and sink ({type(txr.source).__name__}, "
          f"{type(rxr.sink).__name__})")
    rcvbuf = rxr.samp_sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    passes = _Passes(rxr, capture=RADIO_PROFILE_PASS)
    in_flight = _InFlight(txr, rxr)
    wall, t_send, launches, out = run("radio-split", [rxr, txr], txr.in_port, pieces,
                                      spacing["radio-split"])
    in_flight.close()
    merge_held(held, out)
    check_launches("radio-split", launches,
                   ("sync_detect", "viterbi_decode", "viterbi_decode_many"))
    check(rxr.constellation.points().shape[0] > 0 and rxr.spectrum.psd_db().max() > -200
          and np.isfinite(rxr.snr_probe.snr_db()), "radio-split: probes not filled")
    chunks = len(passes.seconds)
    stages = {k: [v.calls, round(v.seconds * 1e3, 1)] for k, v in rxr.ex.tracer.report().items()}
    print(f"radio-split: TxRadio(mcs {txr.mcs}, batch {txr.batch}, scale {txr.scale}) -> "
          f"{txr.stats['samples_tx']} sc16 samples -> RxRadio(chunk {rxr.chunk}, block "
          f"{rxr.ex.block} x {rxr.ex.cfg.time_shards}, {rxr.ex.max_frames} slots), source "
          f"{type(txr.source).__name__}, sink {type(rxr.sink).__name__}, sample socket "
          f"SO_RCVBUF {rcvbuf}, at most {in_flight.peak} samples ({in_flight.peak / 4096:.0f} "
          f"datagrams) sent and not yet read: {n}/{n} pieces, canvas bit for bit, no dropped "
          f"line; sent at "
          f"{1e3 * spacing['radio-split']:g} ms spacing in {t_send:.2f} s; wall {wall:.2f} s, "
          f"{n / wall:.0f} pieces/s; tx {json.dumps(txr.stats)}, rx {json.dumps(rxr.stats)}; "
          f"chunk times {passes.summary()}; launches {json.dumps(launches)} "
          f"({launches['sync_detect'] / chunks:.2f} sync_detect, "
          f"{launches['viterbi_decode_many'] / chunks:.2f} viterbi_decode_many a chunk over "
          f"{chunks} chunks); held {json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})}"
          f"; executor Tracer [calls, ms] {json.dumps(stages)}; TxRadio "
          f"{graph_stats(txr.graphs)} ({card})")
    again("radio-split", f"one chunk of {passes.args[0].size} samples", rxr,
          lambda: rxr._process(passes.args[0], 0, set()))
    phases["radio-split"] = launches
    app.close()
    return phases, inputs


def http(url: str, data: bytes | None = None, ctype: str | None = None,
         method: str | None = None) -> bytes:
    """One HTTP request to an app; the response body."""
    import urllib.request

    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def multipart(images) -> tuple[bytes, str]:
    """The sender page's form as a browser posts it: image0, image1, ... as
    PNG files; (body, Content-Type)."""
    import io

    from PIL import Image

    boundary = "chip-smoke-boundary"
    body = io.BytesIO()
    for i, img in enumerate(images):
        png = io.BytesIO()
        Image.fromarray(img).save(png, format="PNG")
        body.write(f'--{boundary}\r\nContent-Disposition: form-data; name="image{i}"; '
                   f'filename="image{i}.png"\r\nContent-Type: image/png\r\n\r\n'.encode())
        body.write(png.getvalue() + b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


class _SseReader:
    """Reads the first event of an app's /events stream, in a thread."""

    def __init__(self, url: str):
        import threading

        self.event = None
        self._thread = threading.Thread(target=self._run, args=(url,), daemon=True)
        self._thread.start()

    def _run(self, url):
        import urllib.request

        with urllib.request.urlopen(url, timeout=60) as r:
            while self.event is None:
                line = r.readline().decode()
                if line.startswith("data: "):
                    self.event = json.loads(line[6:])

    def wait(self, timeout: float):
        self._thread.join(timeout)
        return self.event


def free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, timeout: float, poll: float = 0.02) -> bool:
    t0 = time.perf_counter()
    while not cond() and time.perf_counter() - t0 < timeout:
        time.sleep(poll)
    return cond()


def wait_whole(receiver, done, quiet: float = 2.0) -> bool:
    """Until done() (True), or until the receiver app has had no piece for
    ``quiet`` seconds (False: the radio drained what the sender left)."""
    have, t_have = -1, time.perf_counter()
    while not done():
        if receiver.pieces_received != have:
            have, t_have = receiver.pieces_received, time.perf_counter()
        elif time.perf_counter() - t_have >= quiet:
            return done()
        time.sleep(0.02)
    return True


def mode1_images() -> dict:
    """The Mode-1 users' 240 x 240 crops of kodim23 (MODE1_CROPS)."""
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(HERE, MODE1_IMAGE)).convert("RGB"))
    return {u: np.ascontiguousarray(img[y : y + 240, x : x + 240])
            for u, (y, x) in MODE1_CROPS.items()}


def app_phases(dev, card: str, reset, counts, held: dict) -> tuple[dict, dict, object]:
    """Phases 20-21: both modes' web apps over LoopbackRadio at its
    defaults, each image posted to the sender page as a browser does.
    20: SenderApp -> LoopbackRadio -> ReceiverApp with the AppConfig image;
    21: FeatureMapSenderApp -> LoopbackRadio -> FeatureMapReceiverApp with
    the packaged codec at 240 x 240, c = 128 on the card. Each run must
    bring the whole image or latent bit for bit and print no "dropped"
    line (stdout is captured while the apps run: the radio and the
    receiver's loop catch exceptions); the first RADIO_HELD calls of each
    kernel of the first run are held against their plain versions (into
    ``held``); a batch of the first run is profiled again after the phase,
    at the radio's defaults. Returns ({phase: launches of its first run},
    {phase: {kernel: (args, kwargs)}} of the largest call of each kernel in
    that batch, the codec)."""
    import functools
    import io

    from gnuradio_wifi_imagetransfer_tpu_torch import config
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import apps, bridge, native

    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    phases, inputs = {}, {}

    def again(label, radio, passes):
        """The batch that ``passes`` kept, through the radio again at its
        defaults (the sink a list), profiled; its largest kernel calls go
        to ``inputs[label]``."""
        radio.set_encoding(3)
        radio.set_snr(22.0)
        radio.set_epsilon(0.0)
        radio.set_chan_est(0)
        radio.probes = False
        radio.sink = _ListSink()
        with recording(*targets) as calls:
            prof = device_profile(lambda: passes.fn(*passes.args))
        print_profile(f"{label}, one batch of {len(passes.args[0])} datagrams ({card})", prof)
        inputs[label] = {k: max(v, key=input_numel) for k, v in calls.items() if v}

    def stack(label, make_receiver, make_sender):
        """LoopbackRadio at its defaults between a receiver app and its
        sender, all started; the sender at APP_SPACING."""
        rx_port = free_udp_port()
        radio = bridge.LoopbackRadio(in_port=0, out_port=rx_port, device=dev)
        check(isinstance(radio.source, native.NativeUdpSource)
              and isinstance(radio.sink, bridge.NativeExtractSink),
              f"{label}: not the native source and sink")
        receiver = make_receiver(rx_port=rx_port, radio=radio)
        sender = make_sender(cfg=AppConfig(tx_port=radio.in_port, piece_interval_s=APP_SPACING))
        for part in (radio, receiver, sender):
            part.start()
        return radio, receiver, sender

    def lap(label, sender, receiver, body, done):
        """The form posted to the sender page, one lap of its pieces at a
        time: a sender that loops at 1 ms outruns the radio (about 300
        pieces/s), whose native source keeps the newest 4 096 datagrams and
        drops the oldest, so the sender is stopped after each lap and the
        form posted again while the receiver, once the radio has drained,
        is not whole (APP_MAX_LAPS at most). Returns (wall s until whole,
        laps, launches, held calls)."""
        reset()
        with recording(*targets, keep=RADIO_HELD) as calls:
            t0 = time.perf_counter()
            for laps in range(1, APP_MAX_LAPS + 1):
                reply = http(f"http://127.0.0.1:{sender.port}/send_image", *body)
                check(reply == b"sending", f"{label}: the sender page answered {reply[:200]!r}")
                check(wait_for(lambda: sender.sender.laps >= 1, APP_TIMEOUT),
                      f"{label}: the sender took over {APP_TIMEOUT:.0f} s for a lap")
                sender.stop_sending()
                if wait_whole(receiver, done):
                    break
            wall = time.perf_counter() - t0
            launches = counts()
        check(done(), f"{label}: not whole after {laps} laps")
        check(launches["sync_detect"] > 0 and launches["viterbi_decode_many"] > 0
              and all(launches[k] == 0 for k in ("sync_stats", "fir_filter",
                                                 "polyphase_resample")),
              f"{label}: launches {launches} (need sync_detect and viterbi_decode_many > 0, "
              f"and no dense K1, K3 or K4)")
        out = hold_recorded(calls, label)
        merge_held(held, out)
        return wall, laps, launches, out

    @contextlib.contextmanager
    def running(label, parts):
        """stdout captured while the radio and the apps run; they stop, and
        the capture is printed, however the block ends; then no "dropped"
        line may be in it."""
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                yield
        finally:
            for part in parts:
                part.stop()
            print(log.getvalue(), end="")
        check("dropped" not in log.getvalue(), f"{label}: the radio or the receiver dropped "
                                               f"a batch or piece:\n{log.getvalue()[-2000:]}")

    # -- 20. Mode-2 apps over LoopbackRadio ----------------------------------
    label = "mode2-apps"
    rng = np.random.default_rng(20)
    AppConfig = config.AppConfig
    h, w = AppConfig().image_size
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = h * w * 3 // 100
    parts = stack(label, apps.ReceiverApp, apps.SenderApp)
    radio, receiver, sender = parts
    with running(label, parts):
        passes = _Passes(radio, capture=RADIO_PROFILE_PASS)
        base = f"http://127.0.0.1:{receiver.port}"
        sse = _SseReader(base + "/events")
        wall, laps, launches, out = lap(label, sender, receiver, multipart([img]),
                                        lambda: np.array_equal(receiver.canvas, img))
        got = receiver.pieces_received
        wait_whole(receiver, lambda: False)
        event = sse.wait(10.0)
        # the RF panel: the probes, then a live retune through POST /radio
        # with the probes on, and a second run into a cleared canvas
        panel = (json.loads(http(base + "/constellation")), json.loads(http(base + "/spectrum")))
        radio.probes = True
        retune = json.loads(http(base + "/radio?mcs=5&snr=30&epsilon=2e-6&chan_est=3",
                                 method="POST"))
        receiver.canvas[:] = 0
        wall2, laps2, _, _ = lap(f"{label} retune", sender, receiver, multipart([img]),
                                 lambda: np.array_equal(receiver.canvas, img))
        wait_whole(receiver, lambda: False)
        panel2 = (json.loads(http(base + "/constellation")), json.loads(http(base + "/spectrum")))
    check(event is not None and event.get("image") and event.get("pieces", 0) > 0,
          f"{label}: no SSE image event ({event})")
    check(set(panel[0]) == {"points", "snr_db"} and panel[1]["nfft"] == len(panel[1]["psd_db"]),
          f"{label}: the RF panel's JSON {str(panel)[:300]}")
    check(retune == {"mcs": 5, "snr": 30.0, "epsilon": 2e-6, "chan_est": 3}
          and (radio.mcs, radio.snr_db, radio.epsilon, int(radio.chan_est)) == (5, 30.0, 2e-6, 3),
          f"{label}: POST /radio answered {retune}, radio at {radio.mcs}, {radio.snr_db}, "
          f"{radio.epsilon}, {radio.chan_est}")
    check(len(panel2[0]["points"]) > 0 and panel2[0]["snr_db"] is not None
          and max(panel2[1]["psd_db"]) > -200, f"{label}: the RF panel shows no live probes")
    print(f"{label}: SenderApp (POST /send_image, {h} x {w} x 3 PNG) -> LoopbackRadio(mcs 3, snr "
          f"22.0 dB, batch {radio.batch}) -> ReceiverApp: canvas bit for bit after {wall:.2f} s in "
          f"{laps} lap(s), {n / wall:.0f} pieces/s of the image ({n} pieces; {got} datagrams "
          f"drawn, {got / wall:.0f}/s), pieces {APP_SPACING * 1e3:g} ms apart; batch times "
          f"{passes.summary()} (both runs); launches of the first "
          f"run {json.dumps(launches)}; held {json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})}; "
          f"SSE event with {event['pieces']} pieces; RF panel {len(panel[0]['points'])} points "
          f"(probes off), retune {json.dumps(retune)} -> second run {wall2:.2f} s in {laps2} lap(s), "
          f"{len(panel2[0]['points'])} points, SNR {panel2[0]['snr_db']} dB, PSD max "
          f"{max(panel2[1]['psd_db']):.1f} dB ({card})")
    again(label, radio, passes)
    phases[label] = launches

    # -- 21. Mode 1 at full width over LoopbackRadio -------------------------
    # the latent's 1 152 pieces at APP_SPACING (1 ms; the reference's 50 ms
    # would take 58 s a lap)
    label = "mode1-loopback"
    t0 = time.perf_counter()
    codec = JSCE.packaged(device=dev)
    t_load = time.perf_counter() - t0
    check(codec.device.type == "cuda" and (codec.img_size, codec.c) == ((240, 240), 128),
          f"{label}: packaged codec {codec.img_size}, c = {codec.c} on {codec.device}")
    t0 = time.perf_counter()
    codec.warm()
    t_warm = time.perf_counter() - t0
    images = mode1_images()
    latent = codec.img2msg(images)
    check(latent.shape == (30, 30, 128) and latent.dtype == np.float32
          and np.isfinite(latent).all(), f"{label}: latent {latent.shape} {latent.dtype}")
    n = latent.size // 100
    parts = stack(label, functools.partial(apps.FeatureMapReceiverApp, codec,
                                           latent_shape=latent.shape),
                  functools.partial(apps.FeatureMapSenderApp, codec))
    radio, receiver, sender = parts
    with running(label, parts):
        passes = _Passes(radio, capture=RADIO_PROFILE_PASS)
        decodes = _Passes(codec, capture=0, attr="msg2img")
        sse = _SseReader(f"http://127.0.0.1:{receiver.port}/events")
        body = multipart([images[u] for u in apps.FeatureMapSenderApp.TARGET])
        wall, laps, launches, out = lap(label, sender, receiver, body,
                                        lambda: np.array_equal(receiver.feature_map, latent))
        n_dec = len(decodes.seconds)
        # one more lap keeps the receiver decoding: the third decode that
        # ends from here started, and published, after the latent was whole
        http(f"http://127.0.0.1:{sender.port}/send_image", *body)
        check(wait_for(lambda: len(decodes.seconds) >= n_dec + 3, APP_TIMEOUT),
              f"{label}: the receiver stopped decoding")
        last = receiver.last_image_b64
        sender.stop_sending()
        wait_whole(receiver, lambda: False)
        event = sse.wait(10.0)
    del codec.msg2img
    check(event is not None and event.get("image"), f"{label}: no SSE image event")
    want = apps._jpeg_b64(np.asarray(codec.msg2img(latent, receiver.user_id)))
    check(last == want, f"{label}: the receiver's reconstruction is not msg2img of the sent "
                        f"latent")
    dec_ms = np.array(decodes.seconds) * 1e3
    enc_ms = cuda_event_ms(lambda: codec.img2msg(images), CODEC_TIMED)
    d_ms = cuda_event_ms(lambda: codec.msg2img(latent, "3-4"), CODEC_TIMED)
    print(f"{label}: JSCE.packaged() on {codec.device} ({codec.img_size[0]} x "
          f"{codec.img_size[1]}, c = {codec.c}) loaded in {t_load:.2f} s, warmed in {t_warm:.2f} "
          f"s; FeatureMapSenderApp (POST /send_image, 2 PNG crops of kodim23) -> LoopbackRadio(mcs "
          f"3, snr 22.0 dB, batch {radio.batch}) -> FeatureMapReceiverApp: latent {latent.shape} "
          f"float32 bit for bit after {wall:.2f} s in {laps} lap(s), {n / wall:.0f} pieces/s ({n} pieces "
          f"{APP_SPACING * 1e3:g} ms apart); batch times {passes.summary()}; receiver decodes "
          f"{dec_ms.size} ({n_dec / wall:.1f}/s until whole), msg2img in the receive thread "
          f"median {np.median(dec_ms):.2f} ms (p90 {np.percentile(dec_ms, 90):.2f}); the last "
          f"reconstruction equals msg2img of the sent latent; launches until whole "
          f"{json.dumps(launches)}; held {json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})}; "
          f"codec {graph_stats(codec.graphs)} ({card})")
    print(f"codec on the card, 240 x 240, c = 128, float32 without TF32: img2msg (2 users) "
          f"{enc_ms:.3f} ms, msg2img {d_ms:.3f} ms (CUDA events, median of {CODEC_TIMED}; "
          f"{card})")
    print_profile(f"msg2img ({card})", device_profile(lambda: codec.msg2img(latent, "3-4")))
    print_profile(f"img2msg, 2 users ({card})", device_profile(lambda: codec.img2msg(images)))
    again(label, radio, passes)
    phases[label] = launches
    return phases, inputs, codec


def codec_phase(codec, card: str) -> None:
    """Phase 22: the packaged codec on the card against its CPU path (the
    latent within CODEC_LATENT_ATOL, uint8 reconstructions within 1 LSB),
    then make_weights.py's held-out protocol on the card against the npz
    meta's PSNR (less PSNR_MARGIN_DB)."""
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch.models import weights
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.metrics import psnr, ssim

    cpu = JSCE.packaged(device="cpu")
    images = mode1_images()
    lat, lat_cpu = codec.img2msg(images), cpu.img2msg(images)
    err = float(np.abs(lat - lat_cpu).max())
    check(err <= CODEC_LATENT_ATOL, f"codec: card latent {err:.3g} from the CPU's "
                                    f"({CODEC_LATENT_ATOL})")
    lsb = max(int(np.abs(np.asarray(codec.msg2img(lat_cpu, u), int)
                         - np.asarray(cpu.msg2img(lat_cpu, u), int)).max()) for u in images)
    check(lsb <= 1, f"codec: card reconstruction {lsb} LSB from the CPU's (1)")

    # make_weights.py eval_holdout and crops(augment=False), on kodim23
    _, meta = weights.load_soma_npz(weights.default_checkpoint())
    hold = np.asarray(Image.open(os.path.join(HERE, MODE1_IMAGE)).convert("RGB"))
    rng = np.random.default_rng(HOLDOUT_SEED)

    def crop():
        im = [hold][rng.integers(1)]
        y = rng.integers(im.shape[0] - 240 + 1)
        x = rng.integers(im.shape[1] - 240 + 1)
        c = im[y : y + 240, x : x + 240]
        if rng.integers(2):
            c = c[:, ::-1]
        if rng.integers(2):
            c = c[::-1]
        return c

    users = meta["users"]
    scores = {u: ([], []) for u in users}
    for _ in range(HOLDOUT_CROPS):
        imgs = {u: crop() for u in users}
        latent = codec.img2msg(imgs)
        for u in users:
            rec = np.asarray(codec.msg2img(latent, u))
            scores[u][0].append(psnr(rec, imgs[u]))
            scores[u][1].append(ssim(rec, imgs[u], channel_axis=2))
    got = {u: (float(np.mean(p)), float(np.mean(s))) for u, (p, s) in scores.items()}
    want = meta["holdout_metrics"]
    print(f"codec: card latent within {err:.3g} of the CPU path's ({CODEC_LATENT_ATOL}), "
          f"reconstructions within {lsb} LSB; held-out {meta['holdout']}, {HOLDOUT_CROPS} crops, "
          f"seed {HOLDOUT_SEED}: " + "; ".join(
              f"{u} PSNR {got[u][0]:.3f} dB (npz meta {want[u]['psnr']:.3f}, TPU), SSIM "
              f"{got[u][1]:.4f} (meta {want[u]['ssim']:.4f})" for u in users) + f" ({card})")
    for u in users:
        check(got[u][0] >= want[u]["psnr"] - PSNR_MARGIN_DB,
              f"codec: {u} held-out PSNR {got[u][0]:.3f} dB below the meta's "
              f"{want[u]['psnr']:.3f} - {PSNR_MARGIN_DB}")


def sv_phase(dev, card: str, reset, counts, held: dict) -> dict:
    """Phase 23: tests/test_channel.py:63-81 on the card. SV tapped-delay
    fading from a CUDA generator (``channel.sv.sv_impulse_response``) over
    the port's TX bursts, the channel model, then ``sync.receive`` on the
    card for each of SV_TRIALS realisations; at least SV_MIN_DECODED of the
    frames bit-exact; each receive launches the fused detector (K1) and the
    segmented Viterbi kernel (K2) once, and every call is held against its
    plain version (``recording`` / ``hold_recorded``). Returns the
    launches."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.channel import sv
    from gnuradio_wifi_imagetransfer_tpu_torch.channel.model import channel_model
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx

    frames = np.random.default_rng(7).integers(0, 256, (SV_FRAMES, SV_LEN), dtype=np.uint8)
    stream = tx.pad_burst(tx.transmit(frames, SV_MCS, device=dev), pad_front=150,
                          pad_tail=300).reshape(-1)
    plan = tx.tx_plan(SV_MCS, SV_LEN)
    gen = torch.Generator(device=dev).manual_seed(SV_SEED)
    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    decoded, taps = [], []
    reset()
    with recording(*targets) as calls:
        t0 = time.perf_counter()
        for _ in range(SV_TRIALS):
            h = sv.sv_impulse_response(gen, n_taps=6, ray_decay=1.5)
            y = channel_model(gen, stream, noise_voltage=0.5 * 10 ** (-SV_SNR_DB / 20),
                              frequency_offset=SV_FO, taps=h)
            res, cand = sync.receive(y, plan, max_frames=4, device=dev)
            ok = (cand.valid & res.sig["parity_ok"]).cpu().numpy()
            got = {tuple(r) for r in res.psdu.cpu().numpy()[ok]}
            decoded.append(sum(tuple(f) in got for f in frames))
            taps.append(h)
        wall = time.perf_counter() - t0
        launches = counts()
    check(sum(decoded) >= SV_MIN_DECODED,
          f"sv fading: {sum(decoded)}/{SV_FRAMES * SV_TRIALS} frames decoded "
          f"({SV_MIN_DECODED} needed), per realisation {decoded}")
    check(launches["sync_detect"] == SV_TRIALS and launches["viterbi_decode_many"] == SV_TRIALS
          and all(v == 0 for k, v in launches.items()
                  if k not in ("sync_detect", "viterbi_decode_many")),
          f"sv fading: launches {launches} for {SV_TRIALS} receives")
    out = hold_recorded(calls, "sv fading")
    merge_held(held, out)
    power = [np.round((h.abs() ** 2).cpu().numpy(), 3).tolist() for h in taps]
    print(f"sv fading (MCS {SV_MCS}, {SV_LEN} bytes, {SV_TRIALS} realisations of 6 taps, "
          f"{SV_SNR_DB:g} dB, offset {SV_FO:g}): {sum(decoded)}/{SV_FRAMES * SV_TRIALS} frames "
          f"bit-exact (per realisation {decoded}) in {wall:.2f} s; tap powers {power}; launches "
          f"{json.dumps(launches)}; held "
          f"{json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})} ({card})")
    return launches


def irs_phase(dev, card: str) -> None:
    """Phase 24: ``SOMANet.forward_physics`` at the reference geometry
    (IRS_GEOMETRY: 240 x 240, c = 128; IRS_N elements, 2 users of IRS_BATCH
    kodim23 crops) from the packaged 240 npz on the card, its channels drawn by the
    trainer's ``Environment`` (``ClusteredIRSChannel``) from a CUDA
    generator and its AWGN passed in as draws; the card's output against
    the port's CPU path on the same inputs within PHYSICS_ATOL."""
    import torch
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch.models import weights
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import TARGET, normalize_image
    from gnuradio_wifi_imagetransfer_tpu_torch.channel.sv import complex_normal
    from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, pe_labels
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.trainer import Environment

    gen = torch.Generator(device=dev).manual_seed(IRS_SEED)
    env = Environment(user_num=2, irs_scale=int(IRS_N ** 0.5), device=dev)
    (_, up, _), _ = env.reset(gen)
    (_, down, _), _ = env.reset(gen)                     # a second Rician refresh
    envs_tx, envs_rx = up.T[..., None].contiguous(), down.T[..., None].contiguous()
    side, c, npz = IRS_GEOMETRY
    variables, _ = weights.load_soma_npz(weights.ASSETS / npz)
    hold = np.asarray(Image.open(os.path.join(HERE, MODE1_IMAGE)).convert("RGB"))
    rng = np.random.default_rng(IRS_SEED)
    crops = np.stack([[hold[y: y + side, x: x + side] for y, x in zip(
        rng.integers(0, hold.shape[0] - side, IRS_BATCH),
        rng.integers(0, hold.shape[1] - side, IRS_BATCH))] for _ in TARGET])
    images = torch.from_numpy(np.ascontiguousarray(np.moveaxis(normalize_image(crops), -1, -3)))
    labels = torch.from_numpy(pe_labels(list(TARGET)))
    noise = complex_normal(gen, (len(TARGET), IRS_BATCH, (side // 8) ** 2 * c // 2), dev)
    outs = []
    with torch.no_grad():
        for d in (dev, torch.device("cpu")):
            model = SOMANet(c, side, IRS_N, device=d)
            model.load_state_dict(weights.state_dict_from_flax(variables, model))
            args = [t.to(d) for t in (images, labels, envs_tx, envs_rx, noise)]
            outs.append(model.forward_physics(*args, IRS_SNR_DB).cpu())
            if not outs[1:]:
                ms = cuda_event_ms(lambda: model.forward_physics(*args, IRS_SNR_DB), 3)
    got, ref = outs
    err = float((got - ref).abs().max())
    csi = [complex(model.get_chnl(envs_tx[u].cpu(), envs_rx[u].cpu())[0, 0].detach())
           for u in range(2)]
    check(got.shape == (2, IRS_BATCH, 3, side, side) and bool(torch.isfinite(got).all()),
          f"irs physics: output {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    check(err <= PHYSICS_ATOL, f"irs physics: card output {err:.3g} from the CPU path's "
                               f"({PHYSICS_ATOL})")
    print(f"irs physics (SOMANet.forward_physics, {side} x {side}, c = {c}, {IRS_N} IRS "
          f"elements, 2 users x {IRS_BATCH}, {IRS_SNR_DB:g} dB, channels from "
          f"ClusteredIRSChannel on a CUDA generator, CSI {[f'{c:.3f}' for c in csi]}): card within {err:.3g} of the CPU path "
          f"({PHYSICS_ATOL}; output peak {float(ref.abs().max()):.3f}); {ms:.2f} ms a forward "
          f"(CUDA events, median of 3; {card})")


def training_phase(dev, card: str, reset, counts) -> dict:
    """Phase 25: make_weights_torch.py in this process (TRAIN_ARGS, --out a
    temporary directory): 2 calls of train_steps, K = 8, m2m, 2 users of 8
    images at 240 x 240, c = 128, warm-started from the packaged npz, at
    the schedule's floor. Every loss finite; ms a step (CUDA events around
    each step, median of the second call's), peak memory, a profiled step;
    the held-out PSNR / SSIM of the written npz by eval_holdout's protocol,
    no lower than the packaged npz meta's less PSNR_MARGIN_DB; the npz
    through JSCE on the card. Then one m2m step at the small geometry on
    the card against the same step on the CPU (loss, gradients,
    parameters, batch statistics). Returns the kernels' launches of the
    training run (none of the four lies on it)."""
    import tempfile

    import torch

    import make_weights_torch as mwt
    from gnuradio_wifi_imagetransfer_tpu_torch.models import weights
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
    from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, pe_labels
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.trainer import Trainer

    events = []
    step_fn = Trainer._step

    def timed_step(self, *args):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step_fn(self, *args)
        stop.record()
        events.append((start, stop))
        return loss

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        Trainer._step = timed_step
        try:
            reset()
            t0 = time.perf_counter()
            res = mwt.main(TRAIN_ARGS + ["--out", out])
            wall = time.perf_counter() - t0
            launches = counts()
        finally:
            Trainer._step = step_fn
        peak = torch.cuda.max_memory_allocated()
        losses, trainer = res["losses"], res["trainer"]
        step_ms = [a.elapsed_time(b) for a, b in events]
        check(len(losses) == 2 * TRAIN_K and bool(np.isfinite(losses).all()),
              f"training: losses {losses}")
        check(all(v == 0 for v in launches.values()),
              f"training: the kernels of the RX path launched {launches}")
        rng = np.random.default_rng(SMALL_SEED)
        pool = mwt.load_kodak(mwt.TRAIN_IMAGES)
        one = np.stack([mwt.crops(rng, pool, mwt.B) for _ in range(mwt.U)])[None]
        labs = pe_labels(mwt.TARGET_USERS)[None]
        prof = device_profile(lambda: trainer.train_steps(one, labs, "m2m"))
        variables, meta = weights.load_soma_npz(res["npz"])
        table = mwt.eval_holdout(variables, device=dev)
        _, asset_meta = weights.load_soma_npz(mwt.ASSET)
        want = asset_meta["holdout_metrics"]
        codec = JSCE(weight_path=res["npz"], img_size=(mwt.IMG, mwt.IMG),
                     compressed_channel=mwt.C, device=dev)
        latent = codec.img2msg({u: mwt.crops(rng, pool, 1)[0] for u in mwt.TARGET_USERS})
        rec = np.asarray(codec.msg2img(latent, mwt.TARGET_USERS[0]))
    check(latent.shape == (mwt.IMG // 8, mwt.IMG // 8, mwt.C) and np.isfinite(latent).all()
          and rec.shape == (mwt.IMG, mwt.IMG, 3) and rec.dtype == np.uint8,
          f"training: the written npz through JSCE gave {latent.shape}, {rec.shape} {rec.dtype}")
    for u in want:
        check(table[u]["psnr"] >= want[u]["psnr"] - PSNR_MARGIN_DB,
              f"training: {u} held-out PSNR {table[u]['psnr']:.3f} dB below the packaged npz "
              f"meta's {want[u]['psnr']:.3f} - {PSNR_MARGIN_DB}")
    second = step_ms[TRAIN_K:2 * TRAIN_K]
    print(f"training (make_weights_torch.py {' '.join(TRAIN_ARGS)}): {len(losses)} steps from "
          f"step {meta['steps'] - len(losses)}, losses {np.round(losses, 5).tolist()}; "
          f"{np.median(second):.2f} ms a step (CUDA events, median of the second call's "
          f"{len(second)}; all {np.round(step_ms, 2).tolist()}), {wall:.1f} s wall for the "
          f"script (load, 2 calls, holdout, packaging); peak memory {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(launches)} ({card})")
    print_profile(f"one m2m training step, 2 x {mwt.B} x {mwt.IMG} x {mwt.IMG} ({card})", prof)
    print(f"training: the written npz's held-out {mwt.HOLDOUT} ({HOLDOUT_CROPS} crops, seed "
          f"{HOLDOUT_SEED}): " + "; ".join(
              f"{u} PSNR {table[u]['psnr']:.3f} dB (packaged npz meta {want[u]['psnr']:.3f}, "
              f"TPU), SSIM {table[u]['ssim']:.4f} (meta {want[u]['ssim']:.4f})" for u in want)
          + f"; through JSCE(weight_path=...) on the card: latent {latent.shape}, "
          f"reconstruction {rec.shape} ({card})")

    # one m2m step at the small geometry, the card against the CPU
    small, _ = weights.load_soma_npz(weights.ASSETS / "jsce_soma_dscn.npz")
    imgs = np.stack([mwt.crops(rng, pool, SMALL_BATCH, size=80) for _ in range(mwt.U)])
    steps = []
    for d in (dev, torch.device("cpu")):
        model = SOMANet(64, 80, device=d)
        model.load_state_dict(weights.state_dict_from_flax(small, model))
        tr = Trainer(model, learning_rate=SMALL_LR, device=d)
        loss = tr.train_step(imgs, pe_labels(mwt.TARGET_USERS), "m2m")
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        steps.append((loss, grads, weights._flatten(weights.flax_from_module(model))))
    (l_c, g_c, v_c), (l_h, g_h, v_h) = steps
    loss_rel = abs(l_c - l_h) / abs(l_h)
    grad_err = {n: float((g_c[n] - g_h[n]).abs().max()) for n in g_h}
    grad_bad = [n for n in g_h if grad_err[n] > max(
        SMALL_GRAD_RTOL * float(g_h[n].abs().max()), SMALL_GRAD_ATOL)]
    param_err = max(float(np.abs(v_c[k] - v_h[k]).max()) for k in v_h if k.startswith("params"))
    stats_err = max(float(np.abs(v_c[k] - v_h[k]).max()) for k in v_h
                    if k.startswith("batch_stats"))
    moved = sum(int((np.abs(v_c[k] - v_h[k]) > 1e-6).sum()) for k in v_h if k.startswith("params"))
    worst = max(grad_err, key=lambda n: grad_err[n] / max(float(g_h[n].abs().max()), 1e-30))
    print(f"training, one m2m step at 80 x 80, c = 64, 2 x {SMALL_BATCH} (jsce_soma_dscn.npz, lr "
          f"{SMALL_LR:g}): loss {l_c:.7f} on the card, {l_h:.7f} on the CPU ({loss_rel:.2e} "
          f"relative); gradients: {len(grad_bad)} of {len(g_h)} leaves out of tolerance, the "
          f"worst relative {worst} ({grad_err[worst]:.3g} of {float(g_h[worst].abs().max()):.3g});"
          f" parameters within {param_err:.3g} ({param_err / SMALL_LR:.3f} lr; {moved} elements "
          f"past 1e-6), batch statistics within {stats_err:.3g} ({card})")
    check(loss_rel <= SMALL_LOSS_RTOL, f"training: card loss {l_c} against the CPU's {l_h}")
    check(not grad_bad, f"training: gradients out of tolerance on {grad_bad[:5]}")
    check(param_err <= 2 * SMALL_LR + 1e-6 and stats_err <= SMALL_STATS_ATOL,
          f"training: parameters {param_err:.3g} or statistics {stats_err:.3g} off the CPU's")
    return launches


def _bandit(agent, env, steps: int, push=None):
    """tests/test_control.py's loop: act, step, observe. ``push`` takes each
    greedy action once the agent is warm. Returns (actions, losses)."""
    obs = env.reset()
    actions, losses = [], []
    for _ in range(steps):
        a = agent.act(obs)
        next_obs, r = env.step(a)
        loss = agent.observe(obs, a, r, next_obs, 0.0)
        actions.append(a)
        losses.append(loss)
        obs = next_obs
        if push is not None and loss is not None:
            push(agent.act(obs, greedy=True), r)
    return actions, losses


def _update_ms(agent, env, n: int, dev) -> float:
    """Median ms of ``agent._update`` on replay batches: CUDA events on the
    card, the host clock on the CPU (after filling the buffer by random
    actions)."""
    import torch

    obs = env.reset()
    rng = np.random.default_rng(DQN_SEED)
    for _ in range(2 * agent.cfg.batch_size):
        a = int(rng.integers(env.n_actions))
        next_obs, r = env.step(a)
        agent.buffer.push(obs, a, r, next_obs, 0.0)
        obs = next_obs
    batch = [torch.from_numpy(b).to(dev) for b in agent.buffer.sample(rng, agent.cfg.batch_size)]
    batch[1] = batch[1].long()
    if dev.type == "cuda":
        return cuda_event_ms(lambda: agent._update(*batch), n)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        agent._update(*batch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def dqn_phase(dev, card: str, reset, counts) -> dict:
    """Phase 26: the DQN IRS controller on the card. The bandit of
    tests/test_control.py:34-52 (DQN_CFG, DQN_STEPS steps,
    ``DqnAgent(device="cuda")`` over ``IrsPowerEnv`` on the card), each
    greedy action after the warm-up pushed through ``IrsControlClient`` to a
    local ``IrsControlServer``: the greedy action's power within 1 dB of the
    best action's, every push arrived in order. Then DQN_PARITY_STEPS steps
    on the card and on the CPU from the card agent's initial parameters, one
    environment driving both: equal actions, losses within DQN_LOSS_RTOL.
    Prints steps/s and the update's ms. Returns the kernels' launches of
    the controller's run (none of the four lies on it)."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.control import (
        DqnAgent, DqnConfig, IrsControlClient, IrsControlServer, IrsPowerEnv)

    cpu = torch.device("cpu")
    env = IrsPowerEnv(n_grid=3, obs_dim=4, device=dev)
    cfg = DqnConfig(n_actions=env.n_actions, **DQN_CFG)
    srv = IrsControlServer()
    pushed = []
    try:
        cli = IrsControlClient(port=srv.port)

        def push(action, power):
            cli.send_action(action, meta={"step": len(pushed), "power_db": power})
            pushed.append(action)

        reset()
        agent = DqnAgent(cfg, seed=DQN_SEED, device=dev)
        t0 = time.perf_counter()
        _bandit(agent, env, DQN_STEPS, push)
        wall = time.perf_counter() - t0
        launches = counts()
        cli.close()
        arrived = wait_for(lambda: len(srv.actions) >= len(pushed), 10.0)
        got = [m["action"] for m in srv.actions]
    finally:
        srv.stop()
    best = env.best_action()
    greedy = agent.act(env.history, greedy=True)
    p_greedy, p_best = env._power_db(env.codebook[greedy]), env._power_db(env.codebook[best])
    check(p_greedy >= p_best - 1.0,
          f"dqn: greedy action {greedy} at {p_greedy:.3f} dB, best {best} at {p_best:.3f} dB")
    check(arrived and got == pushed and [m["step"] for m in srv.actions] == list(range(len(pushed))),
          f"dqn: {len(got)} of {len(pushed)} pushed actions arrived, in order {got == pushed}")
    check(all(v == 0 for v in launches.values()),
          f"dqn: the kernels of the RX path launched {launches}")

    # the card against the CPU from one set of initial parameters
    init, runs = None, []
    for d in (dev, cpu):
        a = DqnAgent(cfg, seed=DQN_SEED, device=d)
        if init is None:
            init = {k: v.detach().cpu().clone() for k, v in a.net.state_dict().items()}
        a.net.load_state_dict(init)
        a.target.load_state_dict(init)
        runs.append(_bandit(a, env, DQN_PARITY_STEPS))
    (act_c, loss_c), (act_h, loss_h) = runs
    first = next((i for i, (c, h) in enumerate(zip(act_c, act_h)) if c != h), None)
    check(first is None, f"dqn: card and CPU actions differ from step {first}")
    rel = max(abs(c - h) / abs(h) for c, h in zip(loss_c, loss_h) if h is not None)
    check(rel <= DQN_LOSS_RTOL, f"dqn: card losses {rel:.3g} relative from the CPU's")

    # the update's time at the bandit's batch and at the default config
    times, shapes = {}, {}
    for label, mk_env, mk_cfg in (
            ("bandit", lambda d: IrsPowerEnv(n_grid=3, obs_dim=4, device=d),
             lambda e: DqnConfig(n_actions=e.n_actions, **DQN_CFG)),
            ("default", lambda d: IrsPowerEnv(device=d), lambda e: DqnConfig())):
        for where, d in (("card", dev), ("cpu", cpu)):
            e = mk_env(d)
            c = mk_cfg(e)
            times[label, where] = _update_ms(DqnAgent(c, seed=DQN_SEED, device=d), e,
                                             DQN_TIMED, d)
        shapes[label] = (e.n_actions, c.batch_size)
    print(f"dqn (IrsPowerEnv(n_grid=3, obs_dim=4), {env.n_actions} actions, {DQN_STEPS} steps, "
          f"batch {cfg.batch_size}): {DQN_STEPS / wall:.1f} steps/s on the card (act, env, "
          f"observe, greedy push; {wall:.2f} s); greedy {greedy} at {p_greedy:.3f} dB, best "
          f"{best} at {p_best:.3f} dB; {len(pushed)} greedy actions pushed over TCP, all arrived "
          f"in order; the first {DQN_PARITY_STEPS} steps card against CPU: equal actions, losses "
          f"within {rel:.2e} relative ({DQN_LOSS_RTOL}); launches {json.dumps(launches)} ({card})")
    print(f"dqn update (a double-DQN Adam step, median of {DQN_TIMED}; the card by CUDA events, "
          f"the CPU by the host clock): " + "; ".join(
              f"{k} ({shapes[k][0]} actions, batch {shapes[k][1]}): card {times[k, 'card']:.3f} ms, "
              f"CPU {times[k, 'cpu']:.3f} ms" for k in ("bandit", "default")) + f" ({card})")
    return launches


def _card_vs_cpu(label: str, make, inputs, dev, rtol: float, fn=None):
    """Builds ``make(device)`` on the card from ZOO_SEED and on the CPU with
    the card's state; runs ``fn(model, *inputs)`` (default: the forward)
    under no_grad on each; every output within rtol of its peak. Returns
    (max error relative to the peak, the card's ms a call by CUDA events)."""
    import torch

    fn = fn or (lambda m, *a: m(*a))
    torch.manual_seed(ZOO_SEED)
    model = make(dev).eval()
    host = make(torch.device("cpu")).eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = fn(model, *(t.to(dev) for t in inputs))
        want = fn(host, *inputs)
        ms = cuda_event_ms(lambda: fn(model, *(t.to(dev) for t in inputs)), 5)
    got, want = ([got] if torch.is_tensor(got) else list(got)), (
        [want] if torch.is_tensor(want) else list(want))
    err = 0.0
    for g, w in zip(got, want):
        g = g.cpu()
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"zoo {label}: card output {tuple(g.shape)} against {tuple(w.shape)}, finite "
              f"{bool(torch.isfinite(g).all())}")
        err = max(err, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    check(err <= rtol, f"zoo {label}: card {err:.3g} of the peak from the CPU path ({rtol})")
    return err, ms


def zoo_phase(dev, card: str, reset, counts) -> dict:
    """Phase 27: the model zoo on the card. ``mae_vit_base_patch16`` at full
    width (embed 768, depth 12, 12 heads; decoder 512, depth 8, 16 heads;
    224 x 224, MAE_BATCH kodim23 crops, mask 0.75, noise from a CUDA
    generator) from seeded weights: loss, forward ms (CUDA events, median
    of MAE_TIMED), peak memory, a profiled forward; at MAE_CHECK_BATCH the
    card's loss, pred, mask and ids against the port's CPU path on the same
    weights and noise. Then ViT(), a Swin-T stage-1 block and PatchMerging,
    ConditionalVAE(), ViTEncoder / ViTDecoder, GNN, PropagNet and CSAAFB
    each on the card against its CPU path (ZOO_RTOL). Returns the kernels'
    launches of the zoo's runs (none of the four lies on them)."""
    import torch
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch import models as zoo
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import normalize_image

    cpu = torch.device("cpu")
    rng = np.random.default_rng(ZOO_SEED)
    img = np.asarray(Image.open(os.path.join(HERE, MODE1_IMAGE)).convert("RGB"))
    crops = np.stack([img[y: y + 224, x: x + 224] for y, x in zip(
        rng.integers(0, img.shape[0] - 224, MAE_BATCH), rng.integers(0, img.shape[1] - 224,
                                                                      MAE_BATCH))])
    imgs = torch.from_numpy(np.ascontiguousarray(np.moveaxis(normalize_image(crops), -1, 1)))
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)

    reset()
    # the peak counts what this phase allocates (weights, inputs,
    # activations), not what earlier phases still hold
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(ZOO_SEED)
    t0 = time.perf_counter()
    mae = zoo.mae_vit_base_patch16(device=dev).eval()
    build_s = time.perf_counter() - t0
    x = imgs.to(dev)
    with torch.no_grad():
        loss, pred, mask = mae(x, 0.75, generator=gen)
        fwd_ms = cuda_event_ms(lambda: mae(x, 0.75, generator=gen), MAE_TIMED)
        peak = torch.cuda.max_memory_allocated() - base
        prof = device_profile(lambda: mae(x, 0.75, generator=gen))
    n_params = sum(p.numel() for p in mae.parameters())
    check(bool(torch.isfinite(loss)) and pred.shape == (MAE_BATCH, 196, 768)
          and bool(torch.isfinite(pred).all())
          and bool((mask.sum(dim=1) == 147).all()),
          f"zoo mae-base: loss {float(loss)}, pred {tuple(pred.shape)}, masked a row "
          f"{mask.sum(dim=1).tolist()}")

    # the card against the CPU at MAE_CHECK_BATCH, one noise
    host = zoo.mae_vit_base_patch16(device=cpu).eval()
    host.load_state_dict({k: v.cpu() for k, v in mae.state_dict().items()})
    noise = torch.rand((MAE_CHECK_BATCH, 196), generator=gen, device=dev)
    outs = []
    with torch.no_grad():
        for m, d in ((mae, dev), (host, cpu)):
            xi = imgs[:MAE_CHECK_BATCH].to(d)
            lat, msk, ids = m.forward_encoder(xi, 0.75, noise.to(d))
            p = m.forward_decoder(lat, ids)
            outs.append([t.cpu() for t in (m.forward_loss(xi, p, msk), p, msk, ids)])
    (l_c, p_c, m_c, i_c), (l_h, p_h, m_h, i_h) = outs
    loss_rel = abs(float(l_c) - float(l_h)) / abs(float(l_h))
    pred_err = float((p_c - p_h).abs().max()) / float(p_h.abs().max())
    check(torch.equal(m_c, m_h) and torch.equal(i_c, i_h),
          "zoo mae-base: the card's mask or ids differ from the CPU's")
    check(loss_rel <= MAE_LOSS_RTOL and pred_err <= ZOO_RTOL,
          f"zoo mae-base: card loss {loss_rel:.3g} relative, pred {pred_err:.3g} of the peak "
          f"from the CPU's ({MAE_LOSS_RTOL}, {ZOO_RTOL})")
    print(f"zoo mae_vit_base_patch16 ({n_params / 1e6:.1f} M parameters, seeded; {MAE_BATCH} "
          f"kodim23 crops of 224 x 224, mask 0.75): loss {float(loss):.5f}; {fwd_ms:.3f} ms a "
          f"forward (CUDA events, median of {MAE_TIMED}; built in {build_s:.1f} s); peak memory "
          f"{peak / 2**30:.2f} GiB (weights, inputs, activations); at batch {MAE_CHECK_BATCH} the card's mask and ids equal the "
          f"CPU path's, loss {loss_rel:.2e} relative, pred within {pred_err:.2e} of its peak "
          f"({card})")
    print_profile(f"one mae_vit_base_patch16 forward, batch {MAE_BATCH} ({card})", prof)

    # the other zoo models, each on the card against its CPU path
    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    m_, n_, p_ = 4, 16, 2
    env = tuple(torch.from_numpy((rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(
        np.complex64)) for s in ((m_, n_), (n_, p_), (m_, p_)))
    labels = torch.eye(10)[[1, 7]]
    cases = [
        ("ViT() 224, patch 16, dim 512, depth 6", lambda d: zoo.ViT(device=d),
         (rand(2, 3, 224, 224),), ZOO_RTOL, None),
        ("SwinTransformerBlock Swin-T stage 1 (96, 56 x 56, 3 heads, window 7, shift 3)",
         lambda d: zoo.SwinTransformerBlock(96, (56, 56), 3, 7, 3, device=d),
         (rand(2, 56 * 56, 96),), ZOO_RTOL, None),
        ("PatchMerging (56 x 56, 96)", lambda d: zoo.PatchMerging((56, 56), 96, device=d),
         (rand(2, 56 * 56, 96),), ZOO_RTOL, None),
        ("ConditionalVAE() 64 x 64, c = 128, eval", lambda d: zoo.ConditionalVAE(device=d),
         (rand(2, 3, 64, 64), labels, rand(2, 8192)), ZOO_RTOL,
         lambda m, x, y, eps: (lambda o: (o[0], o[2], o[3]))(m(x, y, eps=eps))),
        ("ViTEncoder(16, 32) / ViTDecoder(4, 128), layer_depth 2",
         lambda d: torch.nn.ModuleDict({"enc": zoo.ViTEncoder(16, 32, device=d),
                                        "dec": zoo.ViTDecoder(4, 128, device=d)}),
         (rand(1, 256, 32), rand(1, 4, 64)), ZOO_RTOL_DEEP,
         lambda m, x, c: (lambda z: (z, m["dec"](z, c)))(m["enc"](x, c))),
        ("GNN(16, 64), 8 x 6 users", lambda d: zoo.GNN(16, 64, device=d),
         (rand(8, 6, 3), torch.from_numpy(rng.integers(0, 5, (2, 15)))), ZOO_RTOL, None),
        (f"PropagNet, {n_} elements, {m_} antennas, {p_} users",
         lambda d: zoo.PropagNet(env, device=d),
         (torch.ones(m_, dtype=torch.complex64),), ZOO_RTOL, None),
        ("CSAAFB(20 dB) on (2, 128, 30, 30)", lambda d: zoo.CSAAFB(20.0, 128, device=d),
         (rand(2, 128, 30, 30),), ZOO_RTOL, None),
    ]
    report = []
    for label, make, inputs, rtol, fn in cases:
        err, ms = _card_vs_cpu(label, make, inputs, dev, rtol, fn)
        report.append(f"{label}: {err:.2e} of the peak, {ms:.3f} ms")
    launches = counts()
    check(all(v == 0 for v in launches.values()),
          f"zoo: the kernels of the RX path launched {launches}")
    print("zoo, the card against its CPU path (forward ms by CUDA events, median of 5): "
          + "; ".join(report) + f"; launches {json.dumps(launches)} ({card})")
    return launches


def free_tcp_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phases(dev, card: str, reset, counts, cap_ppm, ppm_records) -> tuple[dict, dict]:
    """Phases 28-30 on a one-rank NCCL group: the fixed mesh step at the
    bench shape against the local executor, the adaptive mesh on the mixed
    stream, the front-end mesh on the 2x +40 ppm capture against phase
    11's records, and the data-parallel trainer at the reference geometry
    against the local Trainer. Returns each run's launches {label:
    {kernel: n}} and the kernels held against their plain versions."""
    import torch
    import torch.distributed as dist

    from gnuradio_wifi_imagetransfer_tpu_torch.config import ExecutorConfig, FrontendConfig
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
        AdaptiveStreamExecutor,
        StreamExecutor,
        make_data_mesh,
        make_mesh,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import HALO_LEFT
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac, tx

    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    held: dict = {}
    launches: dict = {}

    def good(records):
        return {(r.channel, r.global_start, r.rate_idx, r.psdu.tobytes())
                for r in records if r.parity_ok}

    t_init = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_tcp_port()}",
                            rank=0, world_size=1)
    group = dist.group.WORLD
    print(f"NCCL group of one rank: {time.perf_counter() - t_init:.1f} s to start")
    try:
        # -- 28. the fixed mesh step at the bench shape ---------------------
        plan = tx.tx_plan(MCS, PSDU_LEN)
        mesh = make_mesh(CHANNELS, TIME_BLOCKS, group=group)
        cfg = ExecutorConfig(block_size=BLOCK, time_shards=TIME_BLOCKS, channels=CHANNELS,
                             max_frames_per_block=MAX_FRAMES, wire_format="sc16")
        mex = StreamExecutor(plan, mesh=mesh, exec_cfg=cfg, device=dev)
        span = TIME_BLOCKS * BLOCK
        stride = span - (mex.halo_right + HALO_LEFT)
        n = MESH_SUPERBLOCKS * span
        positions = seam_positions(n, BLOCK)
        rng = np.random.default_rng(28)
        rows, sent = [], []
        for ch in range(CHANNELS):
            x, frames = make_stream(tx, n, positions, len(positions), rng, dev)
            rows.append(x)
            sent += [(ch, f.tobytes()) for f in frames]
        stream = np.stack(rows)
        reset()
        t0 = time.perf_counter()
        with recording(*targets) as calls:
            records = mex.run(stream)
        wall = time.perf_counter() - t0
        launches["mesh-fixed"] = counts()
        steps = len(range(0, n, stride))
        got = good(records)
        missing = set(sent) - {(c, p) for c, _, _, p in got}
        check(not missing and len(got) == len(sent),
              f"mesh fixed: {len(got)} good records for {len(sent)} frames, {len(missing)} "
              f"missing")
        lx = launches["mesh-fixed"]
        check(lx["sync_detect"] == steps and lx["viterbi_decode_many"] == steps
              and all(lx[k] == 0 for k in ("sync_stats", "viterbi_decode", "fir_filter",
                                           "polyphase_resample")),
              f"mesh fixed: launches {lx} for {steps} steps")
        merge_held(held, hold_recorded(calls, "mesh fixed"))
        local = StreamExecutor(plan, exec_cfg=cfg, device=dev).run(stream)
        check(good(local) == got, f"mesh fixed: {len(got)} good records, the local executor's "
                                  f"{len(good(local))} differ")
        layout_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            wire, _ = mex.mesh_layout(stream, stride)
            layout_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        wire = torch.from_numpy(wire).to(dev)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        step_ms = cuda_ms(lambda: mex.mesh_step(wire), 5)
        samples = CHANNELS * span
        print(f"mesh fixed ({CHANNELS} x {TIME_BLOCKS} cells of {BLOCK} on one NCCL rank, sc16, "
              f"{n} samples a channel, {steps} overlapping strides): {len(got)}/{len(sent)} "
              f"frames bit-exact ({len(positions)} a channel, {n // BLOCK - 1} across block "
              f"seams, one flush against the end), good records equal the local "
              f"executor's; run {wall:.2f} s wall; mesh_step {step_ms:.3f} ms "
              f"({samples / step_ms / 1e3:.1f} Msamples/s, CUDA events, 5 steps), host layout "
              f"{min(layout_ms):.1f} ms (best of 3: {[round(v, 1) for v in layout_ms]}), "
              f"host-to-device copy {copy_ms:.1f} ms; launches {json.dumps(lx)} ({card})")
        print_profile("mesh step", device_profile(lambda: mex.mesh_step(wire)))
        del wire, local, calls

        # -- 29. the adaptive mesh on the mixed stream, the front-end mesh ---
        aspan = ADAPTIVE_SHARDS * BLOCK
        acfg = ExecutorConfig(block_size=BLOCK, time_shards=ADAPTIVE_SHARDS,
                              max_frames_per_block=ADAPTIVE_SLOTS, wire_format="sc8")
        x, psdus, mcs_seq = adaptive_stream(tx, mac, None, 2 * aspan, np.random.default_rng(29),
                                            dev)
        aex = AdaptiveStreamExecutor(mesh=make_mesh(1, ADAPTIVE_SHARDS, group=group),
                                     exec_cfg=acfg, device=dev)
        reset()
        t0 = time.perf_counter()
        with recording(*targets) as calls:
            recs = aex.run(x)
        wall = time.perf_counter() - t0
        la = launches["mesh-adaptive"] = counts()
        steps = len(range(0, x.shape[1], aspan - (aex.halo_right + HALO_LEFT)))
        back = {(r.rate_idx, r.psdu.tobytes()) for r in recs if r.parity_ok}
        lost = [i for i, (m, f) in enumerate(zip(mcs_seq, psdus))
                if (int(m), f.tobytes()) not in back]
        check(not lost, f"mesh adaptive: frames {lost[:10]} of {len(psdus)} lost")
        check(la["sync_detect"] == steps and la["viterbi_decode"] == steps
              and la["viterbi_decode_many"] == len(calls["viterbi_decode_many"]) >= 8
              and la["sync_stats"] == 0,
              f"mesh adaptive: launches {la} for {steps} steps")
        merge_held(held, hold_recorded(calls, "mesh adaptive"))
        alocal = AdaptiveStreamExecutor(exec_cfg=acfg, device=dev).run(x)
        check(good(alocal) == good(recs), "mesh adaptive: good records differ from the local "
                                          "executor's")
        print(f"mesh adaptive (1 x {ADAPTIVE_SHARDS} cells of {BLOCK}, {ADAPTIVE_SLOTS} slots, "
              f"sc8, the mixed stream of {x.shape[1]} samples, {steps} strides): "
              f"{len(psdus)}/{len(psdus)} frames bit-exact at their rates, good records equal "
              f"the local executor's; {wall * 1e3:.1f} ms wall ({len(psdus) / wall:.0f} "
              f"frames/s); launches {json.dumps(la)} ({card})")
        del calls

        fex = StreamExecutor(plan, mesh=mesh, device=dev, exec_cfg=dataclasses.replace(
            cfg, frontend=FrontendConfig(resample=(1, 2), ppm=40.0)))
        reset()
        t0 = time.perf_counter()
        with recording(*targets) as calls:
            frecs = fex.run(cap_ppm)
        wall = time.perf_counter() - t0
        lf = launches["mesh-frontend"] = counts()
        steps = len(range(0, fex.effective_len(cap_ppm.shape[1]), span))
        check(lf["sync_detect"] == steps and lf["viterbi_decode_many"] == steps
              and all(lf[k] == 0 for k in ("sync_stats", "viterbi_decode", "fir_filter",
                                           "polyphase_resample")),
              f"mesh front-end: launches {lf} for {steps} steps")
        check(good(frecs) == good(ppm_records) and len(good(frecs)) == CHANNELS
              * FRAMES_PER_BLOCK * TIME_BLOCKS,
              f"mesh front-end: {len(good(frecs))} good records, phase 11's local "
              f"{len(good(ppm_records))} differ")
        merge_held(held, hold_recorded(calls, "mesh front-end"))
        print(f"mesh front-end (resample=(1, 2), ppm=40, {CHANNELS} x {TIME_BLOCKS} cells, input "
              f"{cap_ppm.shape}): {len(good(frecs))} frames bit-exact, good records equal phase "
              f"11's local run; {wall:.2f} s wall; launches {json.dumps(lf)} ({card})")
        del calls
        shapes = {k: sorted({str(s) for s in v[1]}) for k, v in held.items()}
        print(f"mesh runs: every kernel call held against its plain version on the same inputs:"
              f" max error {json.dumps({k: v[0] for k, v in held.items()})}; inputs "
              f"{json.dumps(shapes)}")

        # -- 30. the data-parallel trainer at the reference geometry ---------
        launches["mesh-train"] = dp_training_phase(dev, card, reset, counts,
                                                   make_data_mesh(group=group))
    finally:
        dist.destroy_process_group()
    return launches, held


def dp_training_phase(dev, card: str, reset, counts, mesh) -> dict:
    """Phase 30: 2 m2m steps at the reference geometry (240 x 240, c = 128,
    2 users of 8 kodim crops) from the packaged npz, the Trainer on a data
    mesh over the group against the local Trainer on the card: losses,
    the first step's gradients, parameters (2 lr a step + 1e-6) and batch
    statistics within the SMALL_* tolerances. Returns the data-parallel
    run's launches (none of the four kernels lies on it)."""
    import torch

    import make_weights_torch as mwt
    from gnuradio_wifi_imagetransfer_tpu_torch.models import weights
    from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, pe_labels
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.trainer import Trainer

    img, c, asset, b = mwt.GEOMETRIES["ref"][:4]
    variables, _ = weights.load_soma_npz(weights.ASSETS / asset)
    rng = np.random.default_rng(30)
    pool = mwt.load_kodak(mwt.TRAIN_IMAGES)
    batches = [np.stack([mwt.crops(rng, pool, b, size=img) for _ in range(mwt.U)])
               for _ in range(2)]
    labels = pe_labels(mwt.TARGET_USERS)
    runs = []
    for m in (mesh, None):
        model = SOMANet(c, img, device=dev)
        model.load_state_dict(weights.state_dict_from_flax(variables, model))
        tr = Trainer(model, learning_rate=SMALL_LR, mesh=m, device=dev)
        reset()
        losses = [tr.train_step(batches[0], labels, "m2m")]
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        # the second step, warm, timed by CUDA events
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(tr.train_step(batches[1], labels, "m2m"))
        stop.record()
        torch.cuda.synchronize()
        if m is not None:
            dp_launches = counts()
        runs.append((losses, grads, weights._flatten(weights.flax_from_module(model)),
                     start.elapsed_time(stop)))
        del model, tr
        torch.cuda.empty_cache()
    (l_d, g_d, v_d, w_d), (l_l, g_l, v_l, w_l) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_l))
    grad_bad = [n for n in g_l if float((g_d[n] - g_l[n]).abs().max()) > max(
        SMALL_GRAD_RTOL * float(g_l[n].abs().max()), SMALL_GRAD_ATOL)]
    param_err = max(float(np.abs(v_d[k] - v_l[k]).max()) for k in v_l if k.startswith("params"))
    stats_err = max(float(np.abs(v_d[k] - v_l[k]).max()) for k in v_l
                    if k.startswith("batch_stats"))
    print(f"data-parallel trainer (a ('data',) mesh over the one-rank NCCL group), 2 m2m steps "
          f"at {img} x {img}, c = {c}, 2 x {b} crops, from {asset}, lr {SMALL_LR:g}: losses "
          f"{np.round(l_d, 7).tolist()} against the local Trainer's {np.round(l_l, 7).tolist()} "
          f"({loss_rel:.2e} relative); {len(grad_bad)} of {len(g_l)} gradient leaves out of "
          f"tolerance; parameters within {param_err:.3g} ({param_err / SMALL_LR:.3f} lr), batch "
          f"statistics within {stats_err:.3g}; the second step {w_d:.1f} ms against "
          f"{w_l:.1f} ms local (CUDA events); "
          f"launches {json.dumps(dp_launches)} ({card})")
    check(loss_rel <= SMALL_LOSS_RTOL and not grad_bad, f"data-parallel trainer: losses "
          f"{loss_rel:.3g} relative or gradients {grad_bad[:5]} off the local Trainer's")
    check(param_err <= 2 * 2 * SMALL_LR + 1e-6 and stats_err <= SMALL_STATS_ATOL,
          f"data-parallel trainer: parameters {param_err:.3g} or statistics {stats_err:.3g}")
    check(all(v == 0 for v in dp_launches.values()),
          f"data-parallel trainer: the kernels of the RX path launched {dp_launches}")
    return dp_launches


def script_phase(card: str) -> None:
    """Phase 31: the three root scripts on the card at small settings, each
    in a process of its own, all three at once: demo_torch.py (48 x 48,
    the canvas bit for bit), tune_equalizer_torch.py (SCRIPT_TUNE_FRAMES
    frames, every setting's PER in its JSON) and scaling_report_torch.py
    (one NCCL rank, blocks of 32 768 and 16 384: the fixed and adaptive
    legs and the 64-channel leg, every frame bit-exact)."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        cmds = {
            "demo_torch.py": ["demo_torch.py", "--size", "48", "--timeout", "120"],
            "tune_equalizer_torch.py": ["tune_equalizer_torch.py", "--frames",
                                        str(SCRIPT_TUNE_FRAMES), "--out",
                                        os.path.join(out, "eq.json")],
            "scaling_report_torch.py": ["scaling_report_torch.py", "--procs", "1", "--block",
                                        "32768", "--iters", "4", "--adaptive-block", "16384",
                                        "--pod-block", "8192",
                                        "--out", os.path.join(out, "scaling.json")]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen([sys.executable, os.path.join(HERE, v[0]), *v[1:]],
                                     cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True) for k, v in cmds.items()}
        outs = {}
        try:
            for k, p in procs.items():
                outs[k] = p.communicate(timeout=SCRIPT_TIMEOUT)[0]
        finally:
            for p in procs.values():
                p.kill()
        wall = time.perf_counter() - t0
        for k, p in procs.items():
            check(p.returncode == 0, f"{k} exited {p.returncode}: {outs[k][-2000:]}")
        check("converged bit-exact" in outs["demo_torch.py"],
              f"demo_torch.py: {outs['demo_torch.py'][-1000:]}")
        with open(os.path.join(out, "eq.json")) as f:
            eq = json.load(f)
        with open(os.path.join(out, "scaling.json")) as f:
            sc = json.load(f)
    check(len(eq["lms"]) == 7 and len(eq["sta"]) == 16 and eq["device"] != "cpu",
          f"tune_equalizer_torch.py: {eq}")
    demo_line = [ln for ln in outs["demo_torch.py"].splitlines() if "converged" in ln][0]
    print(f"scripts on the card, at once ({wall:.1f} s wall): demo_torch.py: {demo_line}; "
          f"tune_equalizer_torch.py ({SCRIPT_TUNE_FRAMES} frames): LMS {json.dumps(eq['lms'])}; "
          f"STA {json.dumps(eq['sta'])}; scaling_report_torch.py (one NCCL rank): "
          f"{json.dumps(sc)} ({card})")


def multichip_phase(card: str) -> dict:
    """Phase 32: multichip_torch.py --procs N, N = min(cards, 4), one NCCL
    rank a card, in a process of its own; every leg must pass on every rank
    (the script checks frames, records, launches and the trainer, and exits
    non-zero if a rank fails), and rank 0 must have held K1 and K2 on each
    executor leg. Returns rank 0's launches {leg: {kernel: n}}."""
    import tempfile

    import torch

    n = min(torch.cuda.device_count(), 4)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "multichip.json")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(HERE, "multichip_torch.py"), "--procs",
                            str(n), "--timeout", str(MULTICHIP_TIMEOUT), "--out", path],
                           cwd=out, capture_output=True, text=True,
                           timeout=MULTICHIP_TIMEOUT + 120)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"multichip_torch.py --procs {n} exited {p.returncode}: "
                                 f"{p.stdout[-2000:]}{p.stderr[-3000:]}")
        with open(path) as f:
            report = json.load(f)
    legs = report["worlds"][str(n)]
    check(set(legs) == {"fixed", "fixed-jax-layout", "adaptive", "frontend", "train"},
          f"multichip_torch.py: legs {sorted(legs)}")
    for label, leg in legs.items():
        if label == "train":
            check(leg["replicas_equal"] and leg["loss_rel"] <= SMALL_LOSS_RTOL
                  and not leg["grads_out_of_tolerance"], f"multichip train: {leg}")
            continue
        viterbi = "viterbi_decode" if label == "adaptive" else "viterbi_decode_many"
        check(leg["good"] >= leg["sent"] and leg["equal_local"]
              and {"sync_detect", viterbi} <= set(leg["held"]),
              f"multichip {label}: {leg['good']} good of {leg['sent']}, equal to the local "
              f"executor's {leg['equal_local']}, held {sorted(leg['held'])}")
    lines = [ln for ln in p.stdout.splitlines()
             if ln.split(" (", 1)[0] in legs or ln.startswith("world of")]
    print(f"multichip_torch.py --procs {n} ({n} NCCL rank(s), one a card; {wall:.1f} s wall):\n  "
          + "\n  ".join(lines))
    return {label: leg["launches"][0] for label, leg in legs.items()}


def bench_phase(card: str) -> None:
    """Phase 33: bench_torch.py over BENCH_PHASES in a process of its own,
    with GWT_BENCH_BUDGET_S=BENCH_BUDGET_S: exit code 0, a value above 0,
    every one of the phases there (each checks its frames bit-exact and
    its K1 and K2 launches); prints its result line."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py"),
                        "--phases=" + ",".join(BENCH_PHASES)],
                       cwd=HERE, env=dict(os.environ, GWT_BENCH_BUDGET_S=str(BENCH_BUDGET_S)),
                       capture_output=True, text=True, timeout=BENCH_BUDGET_S + 60)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"bench_torch.py exited {p.returncode}: {p.stdout[-2000:]}"
                             f"{p.stderr[-3000:]}")
    try:
        line = p.stdout.strip().splitlines()[-1]
        res = json.loads(line)
    except (IndexError, ValueError):
        fail(f"bench_torch.py printed no result line: {p.stdout[-2000:]}")
    missing = [k for k in BENCH_PHASES if k not in res["detail"]["phases"]]
    check(res["value"] > 0 and not missing,
          f"bench_torch.py: value {res['value']}, phases missing {missing}, skipped "
          f"{res['detail']['skipped']}")
    print(f"bench_torch.py --phases={','.join(BENCH_PHASES)} ({wall:.1f} s wall; {card}): "
          f"{res['value']:.1f} {res['unit']}; result line: {line}")


def waterfall_phase(dev, card: str, reset, counts, held: dict) -> dict:
    """Phase 34: the PER waterfall on the card. The port's TX makes the
    bursts on the CPU (``waterfall_inputs``); ``rx.decode_aligned`` decodes
    every point on the card, then on the CPU path from the same arrays.
    Each decode launches K2 once (``viterbi_decode_many``: the SIGNAL
    trellis and the payload's), and every such call is held bit-exact
    against its plain version (into ``held``). Fails where K2 did not
    launch, a held call differs, a point's frame errors differ from the CPU
    path's by more than one frame, or test_waterfall.py's assertions fail
    on the card's table. Prints both tables, every frame where the two
    differ, and the launches. Returns the launches."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.config import ChannelEstimator
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import rx, tx

    def transmit(psdu, mcs, seeds):
        return tx.transmit(psdu, mcs, scrambler_seed=torch.as_tensor(seeds),
                           device="cpu").numpy()

    def on(device):
        def decode(y, mcs, psdu_len, algo):
            r = rx.decode_aligned(torch.from_numpy(y).to(device), tx.tx_plan(mcs, psdu_len),
                                  start=0, algo=ChannelEstimator[algo])
            return {"psdu": r.psdu.cpu().numpy()}
        return decode

    inputs = waterfall_inputs(transmit)
    reset()
    with recording((k2, "viterbi_decode_many")) as calls:
        t0 = time.perf_counter()
        card_tables = waterfall_tables(inputs, on(dev))
        t_card = time.perf_counter() - t0
        launches = counts()
    t0 = time.perf_counter()
    cpu_tables = waterfall_tables(inputs, on("cpu"))
    t_cpu = time.perf_counter() - t0
    points = len(card_tables)
    check(launches["viterbi_decode_many"] == points
          and all(v == 0 for k, v in launches.items() if k != "viterbi_decode_many"),
          f"waterfall: launches {launches} for {points} decodes (K2's viterbi_decode_many "
          f"once a decode, no other kernel)")
    out = hold_recorded(calls, "waterfall")
    merge_held(held, out)
    timed = []                   # K2 at an AWGN decode's shapes and at a fading decode's
    for args, kw in (calls["viterbi_decode_many"][0],
                     max(calls["viterbi_decode_many"], key=input_numel)):
        ms = cuda_ms(lambda: k2.viterbi_decode_many(*args, **kw), 20)
        steps = sum(v.shape[0] * v.shape[1] for v in args[0])
        timed.append(f"{[tuple(v.shape) for v in args[0]]} {ms:.4f} ms (bound "
                     f"{bound_str(viterbi_bound(steps))})")
    card_err, cpu_err = frame_errors(card_tables, inputs), frame_errors(cpu_tables, inputs)
    rows, apart, far = [], [], []
    for key in card_tables:
        n_card, n_cpu = int(card_err[key].sum()), int(cpu_err[key].sum())
        rows.append(f"{key[0]} {key[1]} {key[2]:g} dB: {n_card}/{card_err[key].size} "
                    f"(CPU {n_cpu})")
        differ = np.flatnonzero((card_tables[key]["psdu"] != cpu_tables[key]["psdu"]).any(1))
        if differ.size:
            apart.append(f"{key}: frames {differ.tolist()} decode differently (card errors "
                         f"{card_err[key][differ].tolist()}, CPU {cpu_err[key][differ].tolist()})")
        if abs(n_card - n_cpu) > 1:
            far.append(key)
    per = {k: float(v.mean()) for k, v in card_err.items()}
    bad = waterfall_failures(per)
    print(f"waterfall: {points} points of {WATERFALL_FRAMES} x {WATERFALL_PSDU}-byte frames "
          f"(AWGN, LS) and {FADING['frames']} x {FADING['psdu']}-byte MCS {FADING['mcs']} "
          f"frames over 3-tap fading; frame errors on the card (CPU path):\n  "
          + "\n  ".join(rows))
    print("waterfall: frames where the card and the CPU path differ: "
          + ("; ".join(apart) if apart else "none"))
    check(not far, f"waterfall: points more than one frame from the CPU path: {far}")
    check(not bad, f"waterfall: test_waterfall.py's assertions fail on the card: {bad}")
    kept = json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})
    print(f"waterfall: test_waterfall.py's assertions hold on the card's table; card {t_card:.2f}"
          f" s, CPU path {t_cpu:.2f} s for the {points} decodes; launches "
          f"{json.dumps(launches)}; held {kept}; viterbi_decode_many on {'; on '.join(timed)} "
          f"(CUDA events; {card})")
    return launches


def soak_phase(dev, card: str, reset, counts, held: dict) -> dict:
    """Phase 35: ``run_soak`` at full scale on the card (SOAK_SIZE, 8 %
    loss, SOAK_TIMEOUT_S), stdout captured while it runs. Fails where the
    canvas is not bit-exact in time, a "dropped" line was printed, or K1
    (sync_detect) or K2 (viterbi_decode_many) did not launch; the first
    RADIO_HELD calls of each are held against their plain versions (into
    ``held``). Prints the record. Returns the launches."""
    import io

    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2

    log = io.StringIO()
    reset()
    with recording((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"),
                   keep=RADIO_HELD) as calls, contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        rec = run_soak(dev)
        wall = time.perf_counter() - t0
        launches = counts()
    print(log.getvalue(), end="")
    check("dropped" not in log.getvalue(), f"soak: the radio or the receiver dropped a batch "
                                           f"or piece:\n{log.getvalue()[-2000:]}")
    check(rec["bit_exact"], f"soak: the canvas is not bit-exact after {SOAK_TIMEOUT_S:.0f} s: "
                            f"{json.dumps(rec)}")
    check(launches["sync_detect"] > 0 and launches["viterbi_decode_many"] > 0
          and all(launches[k] == 0 for k in ("sync_stats", "fir_filter", "polyphase_resample")),
          f"soak: launches {launches} (need sync_detect and viterbi_decode_many > 0, and no "
          f"dense K1, K3 or K4)")
    out = hold_recorded(calls, "soak")
    merge_held(held, out)
    print(f"soak (tests/test_soak.py at full scale, port's SenderApp -> 8 % lossy relay -> "
          f"LoopbackRadio(mcs 3, 22 dB, batch 16) on the card -> ReceiverApp): "
          f"{json.dumps(rec)}; phase wall {wall:.1f} s; launches {json.dumps(launches)}; held "
          f"{json.dumps({k: [v[0], len(v[1])] for k, v in out.items()})} ({card})")
    return launches


class EagerGraphs:
    """A graph cache that runs each function eagerly, as the executors,
    the radios and the codec ran before their CUDA graphs: phases 36's and
    37's reference, set on their ``graphs`` by this script (the package
    has no switch). The caller has seeded the generators."""

    def __call__(self, key, fn, inputs, generators=()):
        return fn(*inputs)


class _GroupSpy:
    """A radio's or codec's graph cache seen from outside: each call's key
    (and, with ``keep``, a copy of its output) goes to a list, and the call
    to ``inner`` (a GraphCache or EagerGraphs)."""

    def __init__(self, inner, keep: bool = False):
        self.inner, self.keep = inner, keep
        self.keys, self.outs = [], []

    def __call__(self, key, fn, inputs, generators=()):
        out = self.inner(key, fn, inputs, generators)
        self.keys.append(key)
        if self.keep:
            self.outs.append(out.clone())
        return out


def graph_stats(cache) -> str:
    """A GraphCache's captures: warm-up and capture ms (host clock) a key,
    median and largest, and the graphs' pools."""
    if not cache.stats:
        return "no graphs"
    warm, cap = (np.array([v[i] for v in cache.stats.values()]) for i in (0, 1))
    return (f"{cache.captured} graphs captured, {len(cache)} held; warm-up ms a key median "
            f"{np.median(warm):.1f} (largest {warm.max():.1f}), capture ms median "
            f"{np.median(cap):.1f} (largest {cap.max():.1f}); pools {graph_pool_mib(cache)}")


def graph_pool_mib(cache) -> str:
    """The device memory that a GraphCache's graphs' private pools
    hold (the allocator's snapshot), or "not measured" where the snapshot
    names no pools."""
    import torch

    pools = {tuple(g.graph.pool()) for g in cache._graphs.values()}
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return "not measured"
    mib = sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) in pools) / 2**20
    return f"{mib:.1f} MiB"


def graph_phase(dev, card: str, reset, counts, stream, plan, cfg, check_records, astreams,
                parent: str | None) -> dict:
    """Phase 36: the local executors' CUDA graphs (parallel/graphs.py)
    against the same executors run eagerly (``EagerGraphs``) on the card.
    Returns the launches of the graphs' replays by run."""
    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.config import (
        ChannelEstimator,
        ExecutorConfig,
        PhyConfig,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import (
        AdaptiveStreamExecutor,
        StreamExecutor,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    held: dict = {}
    replay_launches = {}

    def eager(ex):
        ex.graphs = EagerGraphs()
        return ex

    def through_graphs(ex, x, label, want, steps, buckets=None):
        """Two runs through ex's graphs (the first captures, the second
        replays), each bit for bit the eager run's; each step launches
        the detector and K2 once (and each bucket K2 once); every kernel
        call of the replayed run held against its plain version."""
        for run in ("capture", "replay"):
            reset()
            with recording(*targets) as calls:
                got = ex.run(x)
            launches = counts()
            identical_records(got, want, f"{label}, {run} run through the graphs")
            expect = {"sync_detect": steps, "sync_stats": 0}
            if buckets is None:
                expect |= {"viterbi_decode_many": steps, "viterbi_decode": 0}
            else:
                expect |= {"viterbi_decode": steps, "viterbi_decode_many": buckets}
            check(all(launches[k] == v for k, v in expect.items())
                  and all(len(calls[k]) == launches[k] for k in calls),
                  f"{label}, {run} run: launches {launches}, recorded "
                  f"{ {k: len(v) for k, v in calls.items()} }, expected {expect}")
        merge_held(held, hold_recorded(calls, f"{label} (replayed)"))
        replay_launches[label] = launches
        return got

    def step_times(ex):
        ev = cuda_ms(lambda: ex.step(0), 20)
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ex.step(0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        prof = [device_profile(lambda: ex.step(0)) for _ in range(3)]
        return ev, float(np.median(walls)), [[round(p[1], 4), p[4]] for p in prof]

    # -- the fixed step at the device_step shape ---------------------------
    ex = StreamExecutor(plan, exec_cfg=cfg, device=dev)
    ex_e = eager(StreamExecutor(plan, exec_cfg=cfg, device=dev))
    want = ex_e.run(stream)
    check_records(want, "executor, eager")
    steps = len(range(0, ex.effective_len(stream.shape[1]), TIME_BLOCKS * BLOCK))
    got = through_graphs(ex, stream, "executor", want, steps)
    check_records(got, "executor through the graphs")
    mem_step = torch.cuda.memory_reserved()
    (key, (warm_ms, capture_ms, n_calls)), = ex.graphs.stats.items()
    print(f"graphs, device_step {CHANNELS}x{TIME_BLOCKS}x{BLOCK} sc16: a run captured "
          f"{ex.graphs.captured} graph (warm-up {warm_ms:.1f} ms, capture {capture_ms:.1f} ms, "
          f"{n_calls} kernel calls logged), a second run replayed it: {len(got)} records bit "
          f"for bit the eager run's; memory_reserved {mem_step / 2**20:.1f} MiB, the graph's "
          f"pool {graph_pool_mib(ex.graphs)} ({card})")
    ex.stage_resident(stream)
    ex_e.stage_resident(stream)
    times = {"eager": [], "graph": []}
    for label, e in (("eager", ex_e), ("graph", ex), ("graph", ex), ("eager", ex_e)):
        ev, wall, prof = step_times(e)
        times[label].append((ev, wall, prof))
        print(f"  device_step {label}: {ev:.4f} ms a step (CUDA events, 20 steps), "
              f"{wall:.4f} ms (host clock, median of 10 synchronised steps); 3 profiled "
              f"steps [device busy ms, device activities] {prof} ({card})")
    print_profile("device_step through its graph", device_profile(lambda: ex.step(0)))
    ex._dev_stream = ex_e._dev_stream = None
    del ex_e

    # -- the adaptive streams of phase 12 ----------------------------------
    span = ADAPTIVE_SHARDS * BLOCK
    acfg = ExecutorConfig(block_size=BLOCK, time_shards=ADAPTIVE_SHARDS,
                          max_frames_per_block=ADAPTIVE_SLOTS, wire_format="sc8")
    fps = {}
    for label in ("adaptive MCS 0", "adaptive mixed"):
        x, psdus, mcs_seq = astreams[label][:3]
        aex = AdaptiveStreamExecutor(exec_cfg=acfg, device=dev)
        aex_e = eager(AdaptiveStreamExecutor(exec_cfg=acfg, device=dev))
        want = aex_e.run(x)
        steps = len(range(0, aex.effective_len(x.shape[1]), span))
        buckets = len({(r.global_start // span, r.rate_idx, r.length) for r in want})
        got = through_graphs(aex, x, label, want, steps, buckets)
        check({(int(m), tuple(f)) for m, f in zip(mcs_seq, psdus)}
              <= {(r.rate_idx, tuple(r.psdu)) for r in got if r.parity_ok},
              f"{label} through the graphs: frames lost")
        rates = {"eager": [], "graph": []}
        for _ in range(ADAPTIVE_ROUNDS):
            for kind, e in (("eager", aex_e), ("graph", aex), ("graph", aex), ("eager", aex_e)):
                e.tracer = tracing.Tracer()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.run(x)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                stage_b = e.tracer.report()["stage_b"].seconds * 1e3
                rates[kind].append((len(psdus) / dt, stage_b / buckets))
        keys = [k for k in aex.graphs.stats if k[0] == "stage_b"]
        longest = max(keys, key=lambda k: k[6][1])
        fps[label] = {k: float(np.median([r[0] for r in v])) for k, v in rates.items()}
        print(f"graphs, {label} ({len(psdus)} frames in {tuple(x.shape)} sc8): "
              f"{aex.graphs.captured} graphs captured ({len(keys)} stage-B buckets, keys "
              f"(MCS, length, padded rows) {sorted((k[1], k[2], k[6][0]) for k in keys)}); "
              f"the longest key (MCS {longest[1]}, {longest[2]} bytes, {longest[6][0]} rows) "
              f"warm-up {aex.graphs.stats[longest][0]:.1f} ms, capture "
              f"{aex.graphs.stats[longest][1]:.1f} ms; records bit for bit the eager run's; "
              f"memory_reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB, the graphs' "
              f"pools {graph_pool_mib(aex.graphs)} ({card})")
        for kind, v in rates.items():
            print(f"  {label} {kind}: frames/s {[round(r[0]) for r in v]} (median "
                  f"{fps[label][kind]:.0f}), stage-B host ms a bucket "
                  f"{[round(r[1], 3) for r in v]} (host clock, {ADAPTIVE_ROUNDS} rounds in "
                  f"turns; {card})")
        del aex, aex_e

    # -- the longest unrolled key: LMS on an 800-byte MCS-0 frame ------------
    n_long = 4 * 16384
    long_frame = np.random.default_rng(36).integers(0, 256, (1, 800), dtype=np.uint8)
    burst = tx.transmit(long_frame, 0, device=dev).cpu().numpy()[0]
    xl = np.zeros((1, n_long), np.complex64)
    xl[0, 1000: 1000 + burst.size] = 0.5 * burst
    xl += (0.005 * (np.random.default_rng(37).standard_normal(xl.shape)
                    + 1j * np.random.default_rng(38).standard_normal(xl.shape))).astype(np.complex64)
    lcfg = dict(exec_cfg=ExecutorConfig(block_size=16384, time_shards=4, max_frames_per_block=8,
                                        wire_format="sc8"),
                phy_cfg=PhyConfig(chan_est=ChannelEstimator.LMS))
    lex = AdaptiveStreamExecutor(device=dev, **lcfg)
    want = eager(AdaptiveStreamExecutor(device=dev, **lcfg)).run(xl)
    check(any(np.array_equal(r.psdu, long_frame[0]) for r in want if r.parity_ok),
          "LMS MCS 0 800 bytes: the eager run lost the frame")
    through_graphs(lex, xl, "LMS MCS 0 800 bytes", want, 1, 1)
    (lkey,) = [k for k in lex.graphs.stats if k[0] == "stage_b"]
    bare = lex.graphs._graphs[lkey].graph
    _, busy, _, _, nodes = device_profile(bare.replay)
    print(f"graphs, LMS stage B of an 800-byte MCS-0 frame ({tx.tx_plan(0, 800).n_sym} symbols "
          f"unrolled): warm-up {lex.graphs.stats[lkey][0]:.1f} ms, capture "
          f"{lex.graphs.stats[lkey][1]:.1f} ms, {lex.graphs.stats[lkey][2]} kernel calls logged; "
          f"one bare replay {nodes} device activities (its kernel and copy nodes), "
          f"{busy:.3f} ms device busy; the graphs' pools {graph_pool_mib(lex.graphs)} "
          f"({card})")

    shapes = {k: sorted({str(s) for s in v[1]}) for k, v in held.items()}
    print(f"graphs: every kernel call of the replayed runs held against its plain version: "
          f"max error {json.dumps({k: v[0] for k, v in held.items()})}; inputs "
          f"{json.dumps(shapes)}")
    print(f"graphs ({card}): device_step ms [events, host clock] eager "
          f"{[[round(t[0], 4), round(t[1], 4)] for t in times['eager']]}, graph "
          f"{[[round(t[0], 4), round(t[1], 4)] for t in times['graph']]}; adaptive frames/s "
          f"{json.dumps({k: {kk: round(vv, 1) for kk, vv in v.items()} for k, v in fps.items()})}")

    if parent:
        # tools/step_ab.py over the parent checkout and this tree, in turns
        tool = os.path.join(HERE, "tools", "step_ab.py")
        for root in (parent, HERE, HERE, parent):
            r = subprocess.run([sys.executable, tool, root], capture_output=True, text=True,
                               timeout=300)
            check(r.returncode == 0, f"step_ab {root}: {r.stderr[-2000:]}")
            print(f"  step_ab {'parent' if root == parent else 'this tree'}: "
                  f"{r.stdout.strip().splitlines()[-1]}")
    return replay_launches


def serving_graph_phase(dev, card: str, reset, counts) -> dict:
    """Phase 37: the serving programs' CUDA graphs (a LoopbackRadio group,
    a TxRadio group, the codec's encode and decode) against the same
    objects run eagerly (``EagerGraphs``) on the card, in turns. Returns
    the launches of the graph runs by run."""
    import functools
    import io

    import torch

    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE, TARGET, denormalize
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import mac as macmod
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import tx
    from gnuradio_wifi_imagetransfer_tpu_torch.runtime import apps, bridge
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import image

    targets = ((k1, "sync_detect"), (k2, "viterbi_decode"), (k2, "viterbi_decode_many"))
    held, out_launches = {}, {}
    turns = ("eager", "graph", "graph", "eager")
    spacing = RADIO_SPACING["radio-loopback"]

    def check_groups(label, launches, groups):
        """Each group launched the detector and the segmented K2 once, and
        nothing else of ours."""
        check(launches["sync_detect"] == groups and launches["viterbi_decode_many"] == groups
              and all(launches[k] == 0 for k in ("sync_stats", "viterbi_decode", "fir_filter",
                                                 "polyphase_resample")),
              f"{label}: launches {launches} for {groups} groups")

    def quiet(label, fn):
        """fn() with stdout captured, printed after; no "dropped" line."""
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                return fn()
        finally:
            print(log.getvalue(), end="")
            check("dropped" not in log.getvalue(),
                  f"{label}: a batch or piece was dropped:\n{log.getvalue()[-2000:]}")

    def graphs_of(kind, radio, first):
        """The kind's graphs on a fresh radio: eager, or the GraphCache (and
        the generator registered with its graphs) of the first graph run."""
        if kind == "eager":
            radio.graphs = EagerGraphs()
        elif first is not None:
            radio.graphs, radio._gen = first
        return radio.graphs

    def host_ms(fn, n=SERVING_TIMED):
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    # -- LoopbackRadio live, in turns ------------------------------------------
    rng = np.random.default_rng(18)
    img = rng.integers(0, 256, RADIO_IMAGE, dtype=np.uint8)
    pieces = image.detach_image(img, rng=rng)
    n = len(pieces)
    app = _AppSide(img)
    batches, first, rates = [], None, {"eager": [], "graph": []}
    for run, kind in enumerate(turns):
        label = f"serving graphs, radio-loopback {kind} run {run + 1}"
        radio = bridge.LoopbackRadio(in_port=0, out_port=app.port, device=dev)
        cache = graphs_of(kind, radio, first)
        if kind == "graph" and first is None:
            first = (cache, radio._gen)
        spy = radio.graphs = _GroupSpy(cache)
        inner = radio._process

        def keep_batches(payloads, inner=inner):
            if len(batches) < SERVING_BATCHES:
                batches.append(list(payloads))
            return inner(payloads)

        radio._process = keep_batches
        passes = _Passes(radio, capture=0)
        app.reset()

        def live():
            radio.start()
            t0 = time.perf_counter()
            send_paced(pieces, radio.in_port, spacing)
            app.wait(n, 60.0)
            wall = (app.t_last or time.perf_counter()) - t0
            radio.stop()
            return wall

        reset()
        with recording(*targets, keep=RADIO_HELD) as calls:
            wall = quiet(label, live)
        launches = counts()
        check(len(app.seen) == n and np.array_equal(app.canvas, img),
              f"{label}: {len(app.seen)}/{n} pieces, or the canvas differs")
        check_groups(label, launches, len(spy.keys))
        if kind == "graph":
            merge_held(held, hold_recorded(calls, label))
            out_launches["radio-loopback"] = launches
        rates[kind].append(n / wall)
        print(f"{label}: {n}/{n} pieces, canvas bit for bit; wall {wall:.2f} s, "
              f"{n / wall:.0f} pieces/s (sent at {1e3 * spacing:g} ms: at most about 1 000/s); "
              f"{len(spy.keys)} groups in {len(passes.seconds)} batches, batch times "
              f"{passes.summary()}; launches {json.dumps(launches)}"
              + (f"; {graph_stats(cache)}" if kind == "graph" else "") + f" ({card})")
    print(f"serving graphs, radio-loopback pieces/s in turns: eager "
          f"{[round(r) for r in rates['eager']]}, graph {[round(r) for r in rates['graph']]} "
          f"(host clock; the 1 ms sender caps both near 1 000/s; {card})")
    app.close()

    # -- the recorded batches through both radios, bit for bit ------------------
    gcache, ggen = first
    rg = bridge.LoopbackRadio(in_port=0, device=dev)
    rg.graphs, rg._gen = gcache, ggen
    re_ = bridge.LoopbackRadio(in_port=0, device=dev)
    re_.graphs = EagerGraphs()
    for r in (rg, re_):
        r.sink.close()

    def defaults(r):
        r.set_encoding(3)
        r.set_snr(22.0)
        r.set_epsilon(0.0)
        r.set_chan_est(0)
        r.probes = False

    def probed(r):
        r.set_encoding(2)
        r.set_snr(25.0)
        r.probes = True

    def retuned(r):
        r.set_encoding(5)
        r.set_snr(30.0)
        r.set_epsilon(2e-6)
        r.set_chan_est(3)
        r.probes = True

    def through(radio, cache, setting, seed):
        """The recorded batches through radio._process (the sink a list,
        the rng reseeded) with ``cache`` as its graphs; returns (spy,
        payloads, launches, recorded calls)."""
        spy = radio.graphs = _GroupSpy(cache, keep=True)
        radio._rng = np.random.default_rng(seed)
        radio.mac = macmod.Mac()            # sequence numbers from 0 again
        radio.sink = _ListSink()
        setting(radio)
        reset()
        with recording(*targets) as calls:
            for b in batches:
                radio._process(b)
        return spy, radio.sink.payloads, counts(), calls

    for short, name, setting in (("defaults", "defaults (MCS 3, 22 dB, LS)", defaults),
                                 ("probes", "probes, MCS 2, 25 dB", probed),
                                 ("retune", "retune: MCS 5, 30 dB, 2e-6, STA, probes", retuned)):
        label = f"serving graphs, recorded batches, {name}"
        n_before = gcache.captured
        want, want_pay, _, _ = through(re_, EagerGraphs(), setting, 37)
        for pass_ in ("first", "replay"):
            spy, pay, launches, calls = through(rg, gcache, setting, 37)
            check(len(spy.outs) == len(want.outs)
                  and all(torch.equal(g, w) for g, w in zip(spy.outs, want.outs))
                  and pay == want_pay,
                  f"{label}, {pass_} pass: the group outputs or payloads differ from the eager "
                  f"radio's")
            check_groups(f"{label}, {pass_} pass", launches, len(spy.keys))
        merge_held(held, hold_recorded(calls, f"{label} (replayed)"))
        out_launches[f"radio-loopback {short}"] = launches
        new = list(gcache.stats)[n_before:]
        caps = [round(gcache.stats[k][1], 1) for k in new]
        print(f"{label}: {len(batches)} batches, {len(spy.keys)} groups, {len(want_pay)} "
              f"payloads; every group's outputs (psdu, ok"
              f"{', symbols, samples' if 'probes' in name else ''}) and every payload bit for bit "
              f"the eager radio's, the capture pass and the replay pass; {len(new)} keys "
              f"captured, capture ms a key {caps}; replay launches {json.dumps(launches)} "
              f"({card})")

    # a batch's host ms, a group's device ms, a profiled batch, in turns
    batch = max(batches, key=len)
    group = max(bridge._by_length(batch), key=len)
    mpdus = bridge._mpdus(macmod.Mac(), group)
    plan = tx.tx_plan(3, mpdus.shape[1])
    b = len(group)
    times = {"eager": [], "graph": []}
    for kind in turns:
        r = rg if kind == "graph" else re_
        defaults(r)
        r.sink = _ListSink()
        r.graphs = gcache if kind == "graph" else EagerGraphs()
        inputs = bridge._staged(dev, mpdus, np.arange(b) % 127 + 1, 22.0, 0.0)
        fn = functools.partial(bridge.loopback_group, plan=plan, cfg=r.cfg,
                               algo=r.chan_est, probes=False, generator=r._gen)
        key = (3, mpdus.shape[1], b, 0, False)
        ev = cuda_event_ms(lambda: r.graphs(key, fn, inputs, (r._gen,)), SERVING_TIMED)
        hm = host_ms(lambda: r._process(batch))
        _, busy, _, _, acts = device_profile(lambda: r._process(batch))
        times[kind].append((hm, ev, busy, acts))
        print(f"  radio-loopback {kind}: a batch of {len(batch)} datagrams {hm:.3f} ms "
              f"(host clock, median of {SERVING_TIMED}); a group of {b} {ev:.4f} ms (CUDA "
              f"events, median of {SERVING_TIMED}); a profiled batch {busy:.3f} ms device busy, "
              f"{acts} device activities ({card})")
    print_profile(f"radio-loopback, one batch through the graphs ({card})",
                  device_profile(lambda: rg._process(batch)))
    # the host work left around the replays of that batch, step by step
    mac = macmod.Mac()
    groups = bridge._by_length(batch)

    def frame():
        return [bridge._mpdus(mac, g) for g in groups]

    framed = frame()
    plans = [tx.tx_plan(3, m.shape[1]) for m in framed]

    def stage():
        return [bridge._staged(dev, m, np.arange(len(m)) % 127 + 1, 22.0, 0.0) for m in framed]

    staged = stage()
    fns = [functools.partial(bridge.loopback_group, plan=pl, cfg=rg.cfg, algo=rg.chan_est,
                             probes=False, generator=rg._gen) for pl in plans]
    keys = [(3, m.shape[1], len(m), 0, False) for m in framed]

    def replay_fetch():
        return [gcache(k, f, i, (rg._gen,)).cpu().numpy() for k, f, i in zip(keys, fns, staged)]

    fields = [bridge.group_fields(o, pl, len(m), False)
              for o, pl, m in zip(replay_fetch(), plans, framed)]
    rows = [p[i].tobytes() for p, ok, _, _ in fields for i in np.flatnonzero(ok)]
    payloads = [macmod.parse(r).payload for r in rows]
    sink = bridge.make_udp_sink("127.0.0.1", free_udp_port())
    steps = {name: round(host_ms(f), 4) for name, f in (
        ("framing", frame), ("staging", stage), ("replays and fetches", replay_fetch),
        ("parse and FCS", lambda: [macmod.parse(r) for r in rows]),
        ("sends", lambda: [sink.send_mac_payload(pl) for pl in payloads]))}
    sink.close()
    print(f"radio-loopback, the batch of {len(batch)} datagrams ({len(groups)} groups) step by "
          f"step through the graphs, host ms (median of {SERVING_TIMED}): {json.dumps(steps)} "
          f"({card})")
    print(f"serving graphs, radio-loopback: {graph_stats(gcache)}; memory_reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB ({card})")
    rg.stop()
    re_.stop()
    del rg, re_, first, gcache

    # -- TxRadio on the same batches -------------------------------------------
    tbatches = [bt[i: i + 4] for bt in batches for i in range(0, len(bt), 4)]

    def tx_run(radio):
        sent = []
        radio._emit = sent.append
        radio.mac = macmod.Mac()
        reset()
        for bt in tbatches:
            radio._process(bt)
        return sent, counts()

    tg = bridge.TxRadio(in_port=0, samp_port=free_udp_port(), device=dev)
    te = bridge.TxRadio(in_port=0, samp_port=free_udp_port(), device=dev)
    te.graphs = EagerGraphs()
    want, _ = tx_run(te)
    for pass_ in ("first", "replay"):
        got, launches = tx_run(tg)
        check(len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"serving graphs, TxRadio {pass_} pass: the samples differ from the eager radio's")
        check(all(v == 0 for v in launches.values()),
              f"serving graphs, TxRadio: launched a kernel of ours: {launches}")
    out_launches["radio-split TxRadio"] = launches
    tb = max(tbatches, key=len)
    tgroup = max(bridge._by_length(tb), key=len)
    tmp = bridge._mpdus(macmod.Mac(), tgroup)
    tplan = tx.tx_plan(tg.mcs, tmp.shape[1])
    for kind in turns:
        r = tg if kind == "graph" else te
        r._emit = lambda s: None
        inputs = bridge._staged(dev, tmp, np.arange(1, len(tgroup) + 1))
        fn = functools.partial(bridge.tx_bursts, plan=tplan, scale=r.scale)
        key = (tplan.mcs, tplan.psdu_len, len(tgroup), r.scale)
        ev = cuda_event_ms(lambda: r.graphs(key, fn, inputs), SERVING_TIMED)
        hm = host_ms(lambda: r._process(tb))
        _, busy, _, _, acts = device_profile(lambda: r._process(tb))
        print(f"  TxRadio {kind}: a batch of {len(tb)} datagrams {hm:.3f} ms (host clock, "
              f"median of {SERVING_TIMED}, sc16 quantisation and the sends included); a "
              f"group of {len(tgroup)} {ev:.4f} ms (CUDA events); a profiled batch {busy:.3f} "
              f"ms device busy, {acts} device activities ({card})")
    print(f"serving graphs, TxRadio (MCS {tg.mcs}, scale {tg.scale}): {len(tbatches)} batches, "
          f"{len(want)} sample streams bit for bit the eager radio's, the capture pass and the "
          f"replay pass; {graph_stats(tg.graphs)} ({card})")
    tg.stop()
    te.stop()
    del tg, te

    # -- the codec and Mode 1 --------------------------------------------------
    codec = JSCE.packaged(device=dev)
    t0 = time.perf_counter()
    codec.warm()
    t_warm = time.perf_counter() - t0
    codec_e = JSCE.packaged(device=dev)
    codec_e.graphs = EagerGraphs()
    codec_e.warm()
    images = mode1_images()
    latent = codec_e.img2msg(images)
    for _ in range(2):
        check(np.array_equal(codec.img2msg(images), latent),
              "serving graphs, codec: the latent differs from the eager codec's")
        for u in TARGET:
            check(np.array_equal(np.asarray(codec.msg2img(latent, u)),
                                 np.asarray(codec_e.msg2img(latent, u))),
                  f"serving graphs, codec: user {u}'s reconstruction differs from the eager "
                  f"codec's")
    for kind in turns:
        c = codec if kind == "graph" else codec_e
        enc = cuda_event_ms(lambda: c.img2msg(images), SERVING_TIMED)
        dec = cuda_event_ms(lambda: c.msg2img(latent, "3-4"), SERVING_TIMED)
        hm = host_ms(lambda: c.msg2img(latent, "3-4"))
        _, busy, _, _, acts = device_profile(lambda: c.msg2img(latent, "3-4"))
        print(f"  codec {kind}: img2msg (2 users) {enc:.3f} ms, msg2img {dec:.3f} ms (CUDA "
              f"events, median of {SERVING_TIMED}); msg2img {hm:.3f} ms (host clock, median); "
              f"a profiled msg2img {busy:.3f} ms device busy, {acts} device activities "
              f"({card})")
    print_profile(f"msg2img through its graph ({card})",
                  device_profile(lambda: codec.msg2img(latent, "3-4")))
    # msg2img step by step, and the receiver's JPEG of each reconstruction
    label = codec._label("3-4")

    def upload():
        return torch.from_numpy(np.array(latent, dtype=np.float32)).to(dev)

    xd = upload()

    def replay_fetch():
        with torch.inference_mode():
            return codec._run("decode", codec.decode, xd, label).cpu().numpy()

    rec = replay_fetch()

    def post():
        return np.asarray(Image.fromarray(
            (np.clip(denormalize(rec), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)))

    shown = post()
    steps = {name: round(host_ms(f), 4) for name, f in (
        ("upload", upload), ("replay and fetch", replay_fetch), ("denormalise to uint8", post),
        ("receiver's JPEG", lambda: apps._jpeg_b64(shown)))}
    print(f"msg2img step by step through its graph, host ms (median of {SERVING_TIMED}): "
          f"{json.dumps(steps)} ({card})")
    print(f"serving graphs, codec: JSCE.packaged() ({codec.img_size[0]} x {codec.img_size[1]}, "
          f"c = {codec.c}) warmed (both graphs captured) in {t_warm:.2f} s; the latent and "
          f"both users' reconstructions bit for bit the eager codec's, twice; "
          f"{graph_stats(codec.graphs)} ({card})")

    lpieces = image.detach_image(latent)
    nl = len(lpieces)
    first, rates = None, {"eager": [], "graph": []}
    for run, kind in enumerate(turns):
        label = f"serving graphs, mode1-loopback {kind} run {run + 1}"
        c = codec if kind == "graph" else codec_e
        rx_port = free_udp_port()
        radio = bridge.LoopbackRadio(in_port=0, out_port=rx_port, device=dev)
        cache = graphs_of(kind, radio, first)
        if kind == "graph" and first is None:
            first = (cache, radio._gen)
        spy = radio.graphs = _GroupSpy(cache)
        receiver = apps.FeatureMapReceiverApp(c, rx_port=rx_port, radio=radio,
                                              latent_shape=latent.shape)
        decodes = _Passes(c, capture=0, attr="msg2img")

        def live():
            """Laps of the pieces until the latent is whole, each in a new
            order, as the sender app sends them (a receiver that falls
            behind its socket loses pieces): (laps, wall s until whole)."""
            receiver.start()
            radio.start()
            t0 = time.perf_counter()

            def whole():
                return np.array_equal(receiver.feature_map, latent)

            order = np.random.default_rng(21)
            for laps in range(1, APP_MAX_LAPS + 1):
                send_paced([lpieces[i] for i in order.permutation(nl)], radio.in_port, spacing)
                if wait_whole(receiver, whole):
                    break
            wall = time.perf_counter() - t0
            alive = (radio._thread.is_alive(), receiver._rx_thread.is_alive())
            radio.stop()
            receiver.stop()
            if not whole():
                fm = receiver.feature_map
                missing = sum(not np.array_equal(fm[y: y + 10, x: x + 10, c: c + 1], p)
                              for (y, x, c), p in lpieces)
                fail(f"{label}: the latent is not whole after {laps} laps: {missing} pieces "
                     f"missing or wrong; the receiver drew {receiver.pieces_received} pieces; "
                     f"radio {radio.stats}, {len(spy.keys)} groups, {len(decodes.seconds)} "
                     f"decodes; threads alive (radio, receiver) {alive}")
            return laps, wall

        reset()
        with recording(*targets, keep=RADIO_HELD) as calls:
            laps, wall = quiet(label, live)
        launches = counts()
        del c.msg2img
        check_groups(label, launches, len(spy.keys))
        if kind == "graph":
            merge_held(held, hold_recorded(calls, label))
            out_launches["mode1-loopback"] = launches
        dec_ms = np.array(decodes.seconds) * 1e3
        rates[kind].append((nl / wall, dec_ms.size / wall, float(np.median(dec_ms))))
        print(f"{label}: the latent {latent.shape} bit for bit after {wall:.2f} s in {laps} "
              f"lap(s), {nl / wall:.0f} pieces/s ({nl} pieces sent at {1e3 * spacing:g} ms: at "
              f"most about 1 000/s); {dec_ms.size} decodes ({dec_ms.size / wall:.1f}/s), msg2img in "
              f"the receive thread median {np.median(dec_ms):.2f} ms (p90 "
              f"{np.percentile(dec_ms, 90):.2f}); {len(spy.keys)} groups; launches "
              f"{json.dumps(launches)} ({card})")
    print(f"serving graphs, mode1-loopback in turns [pieces/s, decodes/s, msg2img ms]: eager "
          f"{[[round(v, 2) for v in r] for r in rates['eager']]}, graph "
          f"{[[round(v, 2) for v in r] for r in rates['graph']]} (host clock; {card})")
    shapes = {k: len(v[1]) for k, v in held.items()}
    print(f"serving graphs: kernel calls held against their plain versions {json.dumps(shapes)}, "
          f"max error {json.dumps({k: v[0] for k, v in held.items()})}; memory_reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB ({card})")
    del codec, codec_e, first
    torch.cuda.empty_cache()
    return out_launches


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch + CUDA port.")
    ap.add_argument("--parent", help="another checkout's root: time its K3 and K4 beside "
                                     "this tree's in phase 17, and its device_step "
                                     "(tools/step_ab.py) in phase 36, in turns")
    ap.add_argument("--fir-times", metavar="ROOT",
                    help="only time the K3 and K4 of the checkout at ROOT")
    args = ap.parse_args()
    if args.fir_times:
        fir_times(os.path.abspath(args.fir_times))
        return
    parent = os.path.abspath(args.parent) if args.parent else None

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        port = __import__(PKG)
    except ImportError as e:
        fail(f"the port package {PKG} is not beside this script ({e})")
    check(os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(HERE, PKG),
          f"{PKG} was imported from {port.__file__}, not from this checkout")

    import scipy.signal

    from gnuradio_wifi_imagetransfer_tpu_torch import ops
    from gnuradio_wifi_imagetransfer_tpu_torch.config import (
        ExecutorConfig,
        FrontendConfig,
        PhyConfig,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import build
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir as k34
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
    from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel import StreamExecutor
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.executor import (
        HALO_LEFT,
        corrected_resident,
    )
    from gnuradio_wifi_imagetransfer_tpu_torch.parallel.frontend import cached_frontend
    from gnuradio_wifi_imagetransfer_tpu_torch.phy import sync, tx, viterbi

    dev = torch.device("cuda")
    kernels = [k1.sync_stats, k1.sync_detect, k2.viterbi_decode, k2.viterbi_decode_many,
               k34.fir_filter, k34.polyphase_resample]
    phy = PhyConfig()
    thr, mp = phy.sync_threshold, phy.min_plateau

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in kernels}

    def check_path_launches(launches, steps, label, also=()):
        """A step launches the fused detector once and the segmented
        Viterbi kernel once, dense K1 and one-segment K2 never."""
        check(launches["sync_detect"] == steps and launches["viterbi_decode_many"] == steps
              and launches["sync_stats"] == 0 and launches["viterbi_decode"] == 0
              and all(launches[k] > 0 for k in also),
              f"{label}: launches {launches} for {steps} steps")

    def n_steps(executor, capture):
        return len(range(0, executor.effective_len(capture.shape[1]), TIME_BLOCKS * BLOCK))

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path, HERE)}")

    # -- 2. card -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)

    # the executor's stream, made first: K1 is checked on its real blocks
    rng = np.random.default_rng(0)
    n = TIME_BLOCKS * BLOCK
    n_frames = FRAMES_PER_BLOCK * TIME_BLOCKS
    gap = n // n_frames
    positions = [min(150 + i * gap, n - 2000) for i in range(n_frames)]
    streams, payloads = zip(*(make_stream(tx, n, positions, n_frames, rng, dev)
                              for _ in range(CHANNELS)))
    stream = np.stack(streams)
    cfg = ExecutorConfig(block_size=BLOCK, time_shards=TIME_BLOCKS, channels=CHANNELS,
                         max_frames_per_block=MAX_FRAMES, wire_format="sc16")
    ex = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), exec_cfg=cfg, device=dev)
    ex.stage_resident(stream)
    blocks = ex.extended_blocks(0)              # (64, 263 840) complex64
    # the flagship block (phases 3 and 7): 4 frames in 32 768 samples
    frng = np.random.default_rng(0)
    frames = frng.integers(0, 256, (4, PSDU_LEN), dtype=np.uint8)
    bursts = tx.transmit(frames, MCS, device=dev).cpu().numpy()
    nf = 1 << 15
    xf = np.zeros(nf, np.complex64)
    for i, b in enumerate(bursts):
        pos = min(200 + i * (nf // 4), nf - b.size - 1)
        xf[pos: pos + b.size] += 0.5 * b
    xf = (xf + 0.01 * (frng.standard_normal(nf) + 1j * frng.standard_normal(nf))
          ).astype(np.complex64)

    # the front-end captures of the same frames (phases 6, 10, 11): 4/3
    # and 2x oversampled by FFT on the card, the 2x one skewed by +40 ppm
    # on the host (one thread a channel)
    t0 = time.perf_counter()
    up4 = fft_oversample(torch.from_numpy(stream).to(dev), 4)
    cap_34 = up4[:, ::3].cpu().numpy()                  # input at 4/3 the rate
    del up4
    up2 = fft_oversample(torch.from_numpy(stream).to(dev), 2).cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(CHANNELS) as pool:
        cap_ppm = np.stack(list(pool.map(lambda row: sample_clock_offset(row, 40.0), up2)))
    del up2
    print(f"front-end captures: 3/4 {cap_34.shape}, (1/2, +40 ppm) {cap_ppm.shape} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 3. K1 against its plain version ---------------------------------
    k1_err = 0.0
    for x in (blocks[:1], blocks):
        a, p, c = k1.sync_stats(x)
        pa, pp, pc = k1.sync_stats_plain(x)
        torch.cuda.synchronize()
        mask = pp > 1e-3
        errs = [max_err(a, pa), max_err(p, pp), (c - pc).abs()[mask].max().item()]
        check(errs[0] <= 2e-4 and errs[1] <= 2e-4 and errs[2] <= 1e-3,
              f"sync_stats kernel disagrees with its plain version on "
              f"{tuple(x.shape)}: max |da|, |dp|, |dc| = {errs}")
        k1_err = max(k1_err, errs[0], errs[1])
        print(f"K1 sync_stats {tuple(x.shape)}: max |da| {errs[0]:.3g}, |dp| {errs[1]:.3g}, "
              f"|dc| {errs[2]:.3g} (atol 2e-4, 2e-4, 1e-3): ok")

    k1d_err, n_valid = 0.0, {}
    for x, k, lo, hi, label in (
            (blocks, MAX_FRAMES, HALO_LEFT, HALO_LEFT + BLOCK, "executor blocks"),
            (torch.from_numpy(xf).to(dev), 8, 0, None, "flagship block")):
        e_cfo, e_ratio, n_valid[label] = hold_detect((x, k, thr, mp, lo, hi), label)
        k1d_err = max(k1d_err, e_cfo, e_ratio)
    check(n_valid["executor blocks"] >= CHANNELS * n_frames and n_valid["flagship block"] >= 4,
          f"sync_detect: valid candidates {n_valid}")
    # edges on tile boundaries, more than K in one tile, near the end
    edges = [[991, 1984], [992, 1985], [993, 1983], [1023, 2976], [1024], [1025],
             list(range(2100, 3072, 112)) + [5000], [7000], []]
    for plateau in (1, 2, 3):
        x = torch.from_numpy(burst_rows(7200, edges, plateau, seed=plateau)).to(dev)
        for k, lo, hi in ((4, 0, None), (1, 0, None), (8, 0, None), (4, 992, None),
                          (4, 993, None), (4, 0, 992), (4, 0, 993), (4, 991, 994),
                          (4, 1023, 1026), (4, 2976, 7000), (4, 2977, 7001)):
            label = f"burst rows, min_plateau {plateau}, K {k}, search [{lo}, {hi})"
            e_cfo, e_ratio, _ = hold_detect((x, k, thr, plateau, lo, hi), label)
            k1d_err = max(k1d_err, e_cfo, e_ratio)
        starts = k1.sync_detect(x, 4, thr, plateau)[0].cpu().tolist()
        check(all(starts[r][: len(e)] == [v - (plateau - 1) for v in sorted(e)[:4]]
                  for r, e in enumerate(edges)),
              f"sync_detect: burst triggers {starts} not where placed")
    print(f"K1 sync_detect: executor blocks ({n_valid['executor blocks']} valid), flagship "
          f"({n_valid['flagship block']} valid), burst rows at tile boundaries / more than K "
          f"a tile / search bounds, min_plateau 1-3: starts and valid exact, max |dcfo|, "
          f"|dratio| {k1d_err:.3g} (atol 1e-4, 1e-3); bit-identical to dense K1 + glue: ok")

    # -- 4. K2 against its plain version, bit-exact ----------------------
    def llrs(b, steps, kind, seed):
        r = np.random.default_rng(seed)
        if kind == "tied":
            v = r.integers(-2, 3, (b, steps, 2)).astype(np.float32)
        else:
            v = (4 * r.standard_normal((b, steps, 2))).astype(np.float32)
        if kind == "punctured":                 # 3/4-rate erasure pattern
            flat = v.reshape(b, -1)
            keep = np.tile(np.array([1, 1, 1, 0, 0, 1], bool), flat.shape[1] // 6 + 1)
            flat[:, ~keep[: flat.shape[1]]] = 0
        return torch.from_numpy(v).to(dev)

    payload_steps = 16 + 8 * PSDU_LEN + 6
    k2_err = 0
    for steps in (payload_steps, 24):
        for kind in ("random", "punctured", "tied"):
            for terminated in (True, False):
                v = llrs(256, steps, kind, seed=steps)
                got = k2.viterbi_decode(v, terminated)
                want = k2.viterbi_decode_plain(v, terminated)
                k2_err = max(k2_err, (got.int() - want.int()).abs().max().item())
                check(torch.equal(got, want),
                      f"viterbi kernel != plain on 256x{steps} {kind} "
                      f"terminated={terminated}: {(got != want).sum().item()} bits differ")
        print(f"K2 viterbi 256x{steps} random/punctured/tied, terminated and not: bit-exact")
    k2m_err = 0
    for kind in ("random", "punctured", "tied"):
        for terminated in (True, False):
            segs = [llrs(256, payload_steps, kind, seed=7), llrs(256, 24, kind, seed=8)]
            flags = [terminated, not terminated]
            want = k2.viterbi_decode_many_plain(segs, flags)
            got = k2.viterbi_decode_many(segs, flags)
            k2m_err = max([k2m_err] + [(g.int() - w.int()).abs().max().item()
                                       for g, w in zip(got, want)])
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"viterbi_decode_many != plain on 256x{payload_steps} + 256x24 {kind} "
                  f"terminated={flags}")
    print(f"K2 viterbi_decode_many 256x{payload_steps} + 256x24 in one launch, "
          f"random/punctured/tied, terminated and not: bit-exact")

    # -- 5. K3 against its plain version ---------------------------------
    def rand(shape, seed, cplx):
        r = np.random.default_rng(seed)
        v = r.standard_normal(shape)
        if cplx:
            v = v + 1j * r.standard_normal(shape)
        return torch.from_numpy(v.astype(np.complex64 if cplx else np.float32)).to(dev)

    k3_err = 0.0
    for n_taps in (5, 48, 129, 200):
        taps = np.random.default_rng(n_taps).standard_normal(n_taps).astype(np.float32)
        for cplx in (False, True):
            x = rand((2, 300), 7, cplx)
            e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
            check(e <= 2e-4, f"fir kernel != plain: {n_taps} taps, complex={cplx}: {e:.3g}")
            k3_err = max(k3_err, e)
    # rows around the 2048-output tile, taps around the 256-tap chunk
    # (unit energy), more than 65 535 rows
    for n_taps in (1, 65, 256, 257, 1000):
        taps = (np.random.default_rng(n_taps).standard_normal(n_taps)
                / np.sqrt(n_taps)).astype(np.float32)
        for cplx in (False, True):
            for shape in ((3, 2047), (3, 2048), (3, 2049), (3, 4097)):
                x = rand(shape, n_taps, cplx)
                e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
                check(e <= 2e-4, f"fir kernel != plain: {shape} x {n_taps} taps, "
                                 f"complex={cplx}: {e:.3g}")
                k3_err = max(k3_err, e)
    x = rand((70_000, 40), 5, True)
    taps = np.random.default_rng(5).standard_normal(65).astype(np.float32) / 8
    e = max_err(k34.fir_filter(x, taps), k34.fir_filter_plain(x, taps))
    check(e <= 2e-4, f"fir kernel != plain on (70000, 40): {e:.3g}")
    k3_err = max(k3_err, e)
    iso = torch.zeros(2, 256, device=dev)
    iso[0, 250] = 1.0
    y_iso = k34.fir_filter(iso, np.ones(64, np.float32))
    check(y_iso[1].abs().max().item() == 0.0 and y_iso[0, 250:].min().item() == 1.0,
          "fir kernel: samples leak across rows")
    fir_taps = scipy.signal.firwin(FIR_TAPS, 0.5).astype(np.float32)     # 65-tap low-pass
    fir_x = torch.from_numpy(stream).to(dev)                            # (4, 4 194 304)
    fir_h = torch.from_numpy(fir_taps).to(dev)
    e = max_err(k34.fir_filter(fir_x, fir_h), k34.fir_filter_plain(fir_x, fir_h))
    check(e <= 2e-4, f"fir kernel != plain on {tuple(fir_x.shape)}: {e:.3g}")
    k3_err = max(k3_err, e)
    print(f"K3 fir (2, 300) x 5/48/129/200 taps, (3, 2047/2048/2049/4097) x 1/65/256/257/1000 "
          f"taps, real and complex, (70000, 40) complex, {tuple(fir_x.shape)} complex x "
          f"{FIR_TAPS} taps: max |dy| {k3_err:.3g} (atol 2e-4); rows kept apart: ok")

    # -- 6. K4 against its plain version ---------------------------------
    k4_err = 0.0
    for (l, m) in ((1, 2), (2, 1), (3, 4), (4, 3), (5, 2)):
        taps = ops.design_lowpass(l, m)
        for cplx in (False, True):
            for shape in ((600,), (2, 4, 90)):
                x = rand(shape, l * 10 + m, cplx)
                got = k34.polyphase_resample(x, l, m, taps)
                want = k34.polyphase_resample_plain(x, l, m, taps)
                check(got.shape == want.shape, f"resampler shape {got.shape} != {want.shape}")
                e = max_err(got, want)
                check(e <= 2e-4, f"resampler kernel != plain: {l}/{m} {shape} "
                                 f"complex={cplx}: {e:.3g}")
                k4_err = max(k4_err, e)
    # rows around the 2048-output tile (2730-2732 and 5462 give 2048, 2049
    # and 4097 outputs at 3/4), spans that shrink the tile (1/96), phase
    # rows of other lengths (the generic loop) and of 7000 taps (restaged
    # passes), more than 65 535 rows
    cases = [((3, n), l, m, 12) for n in (2047, 2048, 2049, 4097, 2730, 2731, 2732, 5462)
             for l, m in ((3, 4), (1, 2), (2, 1))]
    cases += [((2, 20_000), 1, 96, 12), ((2, 20_000), 3, 4, 16), ((2, 20_000), 7, 5, 9),
              ((2, 20_000), 1, 2, 7000), ((70_000, 50), 3, 4, 12)]
    for shape, l, m, tpp in cases:
        taps = ops.design_lowpass(l, m, tpp)
        for cplx in (False, True):
            x = rand(shape, l + m + tpp, cplx)
            e = max_err(k34.polyphase_resample(x, l, m, taps),
                        k34.polyphase_resample_plain(x, l, m, taps))
            check(e <= 2e-4, f"resampler kernel != plain: {l}/{m} x {tpp} taps a phase "
                             f"{shape} complex={cplx}: {e:.3g}")
            k4_err = max(k4_err, e)
    # the executor's general front-end input: the 4/3 capture, padded
    ex_34 = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), device=dev, exec_cfg=dataclasses.replace(
        cfg, frontend=FrontendConfig(resample=(3, 4))))
    fe_34 = ex_34.frontend
    np_out = ex_34.padded_out_len(fe_34.out_len(cap_34.shape[1]))
    p_in, n_in_pad, _ = fe_34.padded_geometry(np_out, HALO_LEFT)
    k4_x = torch.zeros(CHANNELS, n_in_pad, dtype=torch.complex64, device=dev)
    k4_x[:, p_in: p_in + cap_34.shape[1]] = torch.from_numpy(cap_34).to(dev)
    k4_taps = ops.design_lowpass(3, 4)
    k4_h = torch.from_numpy(k4_taps).to(dev)
    k4_y = k34.polyphase_resample(k4_x, 3, 4, k4_h)
    e = max_err(k4_y, k34.polyphase_resample_plain(k4_x, 3, 4, k4_h))
    check(e <= 2e-4, f"resampler kernel != plain on {tuple(k4_x.shape)} at 3/4: {e:.3g}")
    k4_err = max(k4_err, e)
    # past the int32 index range: j * M passes 2**31 after 85 900 outputs
    f0, n_tone = 0.01, 1 << 20
    tone = torch.from_numpy(np.exp(2j * np.pi * f0 * np.arange(n_tone))[None].astype(
        np.complex64)).to(dev)
    big_taps = ops.design_lowpass(25001, 25000)
    y_tone = k34.polyphase_resample(tone, 25001, 25000, big_taps)
    e = max_err(y_tone, k34.polyphase_resample_plain(tone, 25001, 25000, big_taps))
    check(e <= 2e-4, f"resampler kernel != plain at 25001/25000: {e:.3g}")
    k4_err = max(k4_err, e)
    j = np.arange(200, y_tone.shape[-1] - 200)
    truth = np.exp(2j * np.pi * f0 * j * (25000 / 25001))
    e_tone = float(np.abs(y_tone[0, 200:-200].cpu().numpy() - truth).max())
    check(j[-1] * 25000 >= 2**31 and e_tone <= 1e-3,
          f"resampler at 25001/25000: tone error {e_tone:.3g} > 1e-3")
    print(f"K4 resample 1/2 2/1 3/4 4/3 5/2 real and complex at (600,) and (2, 4, 90), "
          f"rows around the tile at 3/4 1/2 2/1, 1/96, 12-16-9-7000 taps a phase, "
          f"(70000, 50), "
          f"{tuple(k4_x.shape)} at 3/4, (1, {n_tone}) at 25001/25000: max |dy| {k4_err:.3g} "
          f"(atol 2e-4); tone error past j*M = 2**31: {e_tone:.3g} (<= 1e-3): ok")

    # -- 7. flagship block through sync.receive --------------------------
    plan = tx.tx_plan(MCS, PSDU_LEN)
    reset()
    res, cand = sync.receive(xf, plan, max_frames=8, device=dev)
    flag_launches = counts()
    valid = cand.valid.cpu().numpy()
    psdu = res.psdu.cpu().numpy()
    check(valid.sum() == 4 and np.array_equal(psdu[valid], frames),
          f"flagship: {valid.sum()} valid slots of 8, or the frames differ")
    cres, ccand = sync.receive(xf, plan, max_frames=8, device="cpu")
    check(np.array_equal(ccand.starts.numpy(), cand.starts.cpu().numpy())
          and np.array_equal(ccand.valid.numpy(), valid)
          and np.array_equal(cres.psdu.numpy(), psdu)
          and np.abs(ccand.cfo.numpy() - cand.cfo.cpu().numpy()).max() < 1e-4,
          "flagship: the CUDA path disagrees with the port's CPU path")
    check_path_launches(flag_launches, 1, "flagship")
    print(f"flagship receive: 4/4 frames bit-exact, matches the CPU path; "
          f"launches {json.dumps(flag_launches)}")

    # -- 8. StreamExecutor at the device_step shape ----------------------
    def check_records(records, label):
        for ci in range(CHANNELS):
            got = {tuple(r.psdu) for r in records if r.channel == ci and r.parity_ok}
            missing = [i for i, f in enumerate(payloads[ci]) if tuple(f) not in got]
            check(not missing, f"{label}: channel {ci} frames {missing} not recovered")
        n_ok = sum(r.parity_ok for r in records)
        check(n_ok == CHANNELS * n_frames,
              f"{label}: {n_ok} good records, expected {CHANNELS * n_frames}")
        return n_ok

    reset()
    records = ex.run(stream)
    main_launches = counts()
    check_path_launches(main_launches, n_steps(ex, stream), "executor")
    n_ok = check_records(records, "executor")
    print(f"executor run: {n_ok}/{CHANNELS * n_frames} frames bit-exact; "
          f"launches {json.dumps(main_launches)}")

    ex.stage_resident(stream)
    reps = 5
    step_ms = cuda_ms(lambda: ex.step(0), reps)
    samples = CHANNELS * TIME_BLOCKS * BLOCK
    print(f"executor device_step {CHANNELS}x{TIME_BLOCKS}x{BLOCK} sc16: {step_ms:.3f} ms/step, "
          f"{samples / step_ms / 1e3:.1f} Msamples/s (CUDA events, {reps} steps; {card})")

    # where one step's device time goes (torch.profiler, CUDA activity)
    print_profile("step", device_profile(lambda: ex.step(0)))
    del ex

    # -- 9. the stand-alone entry points ---------------------------------
    reset()
    fir_y = ops.fir_filter(fir_x, fir_taps)
    fir_launches = counts()
    check(fir_launches["fir_filter"] > 0, f"ops.fir_filter: K3 was not launched: {fir_launches}")
    check(bool(torch.isfinite(fir_y).all()) and fir_y.shape == fir_x.shape,
          "ops.fir_filter: output not finite or of the wrong shape")
    print(f"ops.fir_filter {tuple(fir_x.shape)} x {FIR_TAPS} taps; "
          f"launches {json.dumps(fir_launches)}")
    del fir_y
    reset()
    a, p, c = sync.sync_stats(blocks)
    stats_launches = counts()
    check(stats_launches["sync_stats"] == 1 and all(
        bool(torch.isfinite(v).all()) and v.shape == blocks.shape for v in (a, p, c)),
          f"sync.sync_stats: not one dense K1 launch ({stats_launches}), or bad output")
    del a, p, c
    n_slots = CHANNELS * TIME_BLOCKS * MAX_FRAMES
    pay, sig = llrs(n_slots, payload_steps, "random", 1), llrs(n_slots, 24, "random", 2)
    reset()
    vit_bits = viterbi.decode(pay.reshape(n_slots, -1), payload_steps)
    vit_launches = counts()
    check(vit_launches["viterbi_decode"] == 1 and vit_bits.shape == (n_slots, payload_steps),
          f"viterbi.decode: not one one-segment K2 launch ({vit_launches}), or bad output")
    print(f"sync.sync_stats {tuple(blocks.shape)}; launches {json.dumps(stats_launches)}; "
          f"viterbi.decode ({n_slots}, {2 * payload_steps}); launches {json.dumps(vit_launches)}")

    # -- 10. executor with the general front-end (3/4) -------------------
    reset()
    t_run = time.perf_counter()
    records = ex_34.run(cap_34)
    gen_launches = counts()
    t_run = time.perf_counter() - t_run
    check_path_launches(gen_launches, n_steps(ex_34, cap_34), "executor 3/4",
                        also=("polyphase_resample",))
    n_ok = check_records(records, "executor 3/4")
    print(f"executor run, resample=(3, 4), input {cap_34.shape}: {n_ok}/{CHANNELS * n_frames} "
          f"frames bit-exact ({t_run:.2f} s wall); launches {json.dumps(gen_launches)}")
    del ex_34

    # -- 11. executor with decimation + clock trim -----------------------
    ex_ppm = StreamExecutor(tx.tx_plan(MCS, PSDU_LEN), device=dev, exec_cfg=dataclasses.replace(
        cfg, frontend=FrontendConfig(resample=(1, 2), ppm=40.0)))
    reset()
    t_run = time.perf_counter()
    records = ppm_records = ex_ppm.run(cap_ppm)
    ppm_launches = counts()
    t_run = time.perf_counter() - t_run
    check_path_launches(ppm_launches, n_steps(ex_ppm, cap_ppm), "executor (1/2, +40 ppm)")
    n_ok = check_records(records, "executor (1/2, +40 ppm)")
    print(f"executor run, resample=(1, 2) ppm=40, input {cap_ppm.shape}: "
          f"{n_ok}/{CHANNELS * n_frames} frames bit-exact ({t_run:.2f} s wall); "
          f"launches {json.dumps(ppm_launches)}")
    del ex_ppm

    fps, amain, held, astreams = adaptive_phases(dev, card, reset, counts)

    # -- 16. front-end pass rates ----------------------------------------
    frng = np.random.default_rng(5)
    rates = {}
    for label, fe_cfg in (("decim2", FrontendConfig(resample=(1, 2))),
                          ("ppm40", FrontendConfig(ppm=40.0)),
                          ("general3/4", FrontendConfig(resample=(3, 4)))):
        fe = cached_frontend(fe_cfg)
        _, n_pad, aux = fe.padded_geometry(FE_OUT_PAD, 256)
        wire = torch.from_numpy((frng.standard_normal((1, n_pad, 2)) * 0.1).astype(
            np.float32)).to(dev)
        aux = tuple(a.to(dev) for a in aux)
        ms = cuda_ms(lambda: corrected_resident(fe, wire, FE_OUT_PAD, aux), 5)
        rates[label] = {"input_samples": n_pad, "ms": round(ms, 4),
                        "input_msamples_per_s": round(n_pad / ms / 1e3, 1)}
    print(f"front-end pass, {FE_OUT_PAD} padded outputs, f32 wire, 1 channel (CUDA events, "
          f"5 passes; {card}): {json.dumps(rates)}")

    # -- 17. kernel timings at the main paths' shapes --------------------
    rows, n_ext = blocks.shape
    k1_ms = cuda_ms(lambda: k1.sync_stats(blocks), 20)
    k1_plain = cuda_ms(lambda: k1.sync_stats_plain(blocks), 3)
    k1_bound = sync_stats_bound(blocks)
    # the fused detector as the executor calls it, beside the PR 2 path
    # it replaces (dense K1 and the torch glue: top-k, cats, elementwise)
    det_args = (MAX_FRAMES, thr, mp, HALO_LEFT, HALO_LEFT + BLOCK)

    def dense_and_glue():
        a, _, c = k1.sync_stats(blocks)
        return k1.detect_from_stats(a, c, *det_args)

    det_buf = k1._detect_buffer(rows, n_ext, MAX_FRAMES, dev)
    k1d_ms = cuda_ms(lambda: k1._detect_launch(blocks, *det_args, det_buf), 20)
    k1d_call = cuda_ms(lambda: k1.sync_detect(blocks, *det_args), 20)
    k1d_glue = cuda_ms(dense_and_glue, 10)
    k1d_plain = cuda_ms(lambda: k1.sync_detect_plain(blocks, *det_args), 3)
    k1d_bound = sync_detect_bound(blocks, MAX_FRAMES)

    # K2 on the step's payload (pay) and SIGNAL (sig) trellises
    k2_pay, k2_sig = (cuda_ms(lambda: k2.viterbi_decode(v), 20) for v in (pay, sig))
    k2_pay_plain, k2_sig_plain = (cuda_ms(lambda: k2.viterbi_decode_plain(v), 2)
                                  for v in (pay, sig))
    k2_ms, k2_plain = k2_pay + k2_sig, k2_pay_plain + k2_sig_plain
    k2m_ms = cuda_ms(lambda: k2.viterbi_decode_many([pay, sig], [True, True]), 20)
    k2m_plain = cuda_ms(lambda: k2.viterbi_decode_many_plain([pay, sig], [True, True]), 2)
    k2_steps = n_slots * (payload_steps + 24)
    k2_bound = viterbi_bound(k2_steps)
    # the adaptive path's inputs (phase 12, the MCS-2 dense run): the
    # detector on (4, 262 960) with 128 slots, stage A's SIGNAL trellises
    # (the viterbi_decode row), one stage-B bucket (SIGNAL + payload)
    sig_a = amain["viterbi_decode"][0]
    k1a_ms = cuda_ms(lambda: k1.sync_detect(*amain["sync_detect"]), 20)
    k2a_ms = cuda_ms(lambda: k2.viterbi_decode(*amain["viterbi_decode"]), 20)
    k2a_plain = cuda_ms(lambda: k2.viterbi_decode_plain(*amain["viterbi_decode"]), 3)
    k2b_ms = cuda_ms(lambda: k2.viterbi_decode_many(*amain["viterbi_decode_many"]), 20)
    k2a_steps = sig_a.shape[0] * sig_a.shape[1]
    k2a_bound = viterbi_bound(k2a_steps)
    k1a_bound = sync_detect_bound(*amain["sync_detect"][:2])
    k2b_bound = viterbi_bound(sum(v.shape[0] * v.shape[1]
                                  for v in amain["viterbi_decode_many"][0]))
    print(f"adaptive path (MCS {MCS} dense run): sync_detect on "
          f"{tuple(amain['sync_detect'][0].shape)} with {amain['sync_detect'][1]} slots "
          f"{k1a_ms:.4f} ms (bound {bound_str(k1a_bound)}); viterbi_decode on stage A's "
          f"{tuple(sig_a.shape)} {k2a_ms:.4f} ms, plain {k2a_plain:.3f} ms (bound "
          f"{bound_str(k2a_bound)}); viterbi_decode_many on a stage-B bucket "
          f"{[tuple(v.shape) for v in amain['viterbi_decode_many'][0]]} {k2b_ms:.4f} ms (bound "
          f"{bound_str(k2b_bound)}) (CUDA events; {card})")
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    k2_floor = chain_floor_ms(payload_steps, sm_mhz)
    print(f"K1 on ({rows}, {n_ext}): dense {k1_ms:.4f} ms (bound bytes "
          f"{k1_bound['bytes']:.4f}, operations {k1_bound['operations']:.4f}); fused detector, "
          f"both launches {k1d_ms:.4f} ms, the wrapper's whole call {k1d_call:.4f} ms, against "
          f"dense K1 + torch glue {k1d_glue:.4f} ms (bound bytes {k1d_bound['bytes']:.4f}, "
          f"operations {k1d_bound['operations']:.4f}); K2 one launch for ({n_slots}, "
          f"{payload_steps}) + ({n_slots}, 24) {k2m_ms:.4f} ms, "
          f"two one-segment launches {k2_ms:.4f} ms; chain floor "
          f"({K2_ACS_CYCLES} + {K2_TRACEBACK_CYCLES} cycles a step x {payload_steps} steps at "
          f"{sm_mhz:.0f} MHz) {k2_floor:.4f} ms (CUDA events; {card})")

    # K3 on the 4-channel stream, 65 taps; library: cuDNN conv1d on the
    # re/im rows (laid out outside the timed call) with flipped taps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # numpy taps, as ops.fir_filter's callers pass them; then the same
    # taps as a CUDA tensor
    k3_ms = cuda_ms(lambda: k34.fir_filter(fir_x, fir_taps), 20)
    k3_dev_ms = cuda_ms(lambda: k34.fir_filter(fir_x, fir_h), 20)
    k3_plain = cuda_ms(lambda: k34.fir_filter_plain(fir_x, fir_h), 3)
    re_im = torch.view_as_real(fir_x).permute(0, 2, 1).reshape(-1, 1, n).contiguous()
    w3 = fir_h.flip(0).reshape(1, 1, -1)
    k3_lib = cuda_ms(lambda: torch.nn.functional.conv1d(re_im, w3, padding=FIR_TAPS - 1), 20)
    lib_y = torch.nn.functional.conv1d(re_im, w3, padding=FIR_TAPS - 1)[..., :n]
    k3_lib_err = max_err(torch.view_as_complex(lib_y.reshape(CHANNELS, 2, n).permute(
        0, 2, 1).contiguous()), k34.fir_filter(fir_x, fir_h))
    del re_im, lib_y
    k3_bound = fir_bound(fir_x.numel(), FIR_TAPS)

    # K4 on the general front-end's input; library: conv1d with stride M
    # over the L-fold zero-stuffed re/im rows (stuffed and padded outside
    # the timed call) with flipped taps
    # numpy taps, as the front-end passes them (phase table cached on the card)
    k4_ms = cuda_ms(lambda: k34.polyphase_resample(k4_x, 3, 4, k4_taps), 20)
    k4_plain = cuda_ms(lambda: k34.polyphase_resample_plain(k4_x, 3, 4, k4_h), 3)
    n_out4 = k4_y.shape[-1]
    n_t4 = k4_taps.size
    stuffed = torch.zeros(2 * CHANNELS, 1, n_in_pad * 3, device=dev)
    stuffed[:, 0, ::3] = torch.view_as_real(k4_x).permute(0, 2, 1).reshape(-1, n_in_pad)
    left = n_t4 - 1 - (n_t4 - 1) // 2
    right = max(0, (n_out4 - 1) * 4 + n_t4 - stuffed.shape[-1] - left)
    stuffed = torch.nn.functional.pad(stuffed, (left, right))
    w4 = k4_h.flip(0).reshape(1, 1, -1)
    k4_lib = cuda_ms(lambda: torch.nn.functional.conv1d(stuffed, w4, stride=4), 20)
    lib_y = torch.nn.functional.conv1d(stuffed, w4, stride=4)[..., :n_out4]
    k4_lib_err = max_err(torch.view_as_complex(lib_y.reshape(CHANNELS, 2, n_out4).permute(
        0, 2, 1).contiguous()), k4_y)
    del stuffed, lib_y
    k4_bound = resample_bound(k4_x.numel(), k4_y.numel(), n_t4,
                              CHANNELS * resample_terms(n_in_pad, 3, 4, n_t4))
    print(f"library yardsticks (conv1d, TF32 off): fir {k3_lib:.4f} ms (max |dy| vs K3 "
          f"{k3_lib_err:.3g}), resample {k4_lib:.4f} ms (max |dy| vs K4 {k4_lib_err:.3g})")

    # -- 18-19. the radios ----------------------------------------------
    radio_launches, radio_inputs = radio_phases(dev, card, reset, counts, held)

    # -- 20-22. both modes' apps over LoopbackRadio, the codec ---------------
    app_launches, app_inputs, codec = app_phases(dev, card, reset, counts, held)
    codec_phase(codec, card)
    del codec

    # -- 23-25. SV fading through K1 and K2, IRS physics, training ----------
    sv_launches = sv_phase(dev, card, reset, counts, held)
    irs_phase(dev, card)
    train_launches = training_phase(dev, card, reset, counts)

    # -- 26-27. the DQN controller and the model zoo (no kernel of ours) ----
    dqn_launches = dqn_phase(dev, card, reset, counts)
    zoo_launches = zoo_phase(dev, card, reset, counts)

    # -- 28-30. the (channel, time) mesh and the data-parallel trainer ------
    mesh_launches, mesh_held = mesh_phases(dev, card, reset, counts, cap_ppm, ppm_records)
    del cap_ppm, ppm_records
    merge_held(held, mesh_held)

    # -- 31. the root scripts ------------------------------------------------
    script_phase(card)

    # -- 32. the multi-card dry run, one NCCL rank a card ---------------------
    multichip_launches = multichip_phase(card)

    # -- 33. the bench, bench_torch.py ----------------------------------------
    bench_phase(card)

    # -- 34-35. the PER waterfall and the Mode-2 soak --------------------------
    waterfall_launches = waterfall_phase(dev, card, reset, counts, held)
    soak_launches = soak_phase(dev, card, reset, counts, held)

    # -- 36. the local executors' CUDA graphs ----------------------------------
    graph_launches = graph_phase(dev, card, reset, counts, stream, plan, cfg, check_records,
                                 astreams, parent)
    del astreams

    # -- 37. the serving programs' CUDA graphs ---------------------------------
    serving_launches = serving_graph_phase(dev, card, reset, counts)

    for label, calls in {**radio_inputs, **app_inputs}.items():
        det_args, det_kw = calls["sync_detect"]
        vit_args, vit_kw = calls["viterbi_decode_many"]
        det_ms = cuda_ms(lambda: k1.sync_detect(*det_args, **det_kw), 20)
        vit_ms = cuda_ms(lambda: k2.viterbi_decode_many(*vit_args, **vit_kw), 20)
        longest = max(v.shape[1] for v in vit_args[0])
        print(f"{label}, a steady pass's largest calls: sync_detect on "
              f"{tuple(det_args[0].shape)} with {det_args[1]} slots {det_ms:.4f} ms (bound "
              f"{bound_str(sync_detect_bound(*det_args[:2]))}); viterbi_decode_many on "
              f"{[tuple(v.shape) for v in vit_args[0]]} {vit_ms:.4f} ms (bound "
              f"{bound_str(viterbi_bound(sum(v.shape[0] * v.shape[1] for v in vit_args[0])))}; "
              f"chain floor of the design {longest} steps x {K2_ACS_CYCLES + K2_TRACEBACK_CYCLES}"
              f" cycles at {sm_mhz:.0f} MHz "
              f"{chain_floor_ms(longest, sm_mhz):.4f} ms) "
              f"(CUDA events; {card})")

    pkg_src = f"{PKG}/csrc"
    jax_ops = "gnuradio_wifi_imagetransfer_tpu/ops"
    def held_err(name, err):
        return float(max(err, held.get(name, (0.0, []))[0]))

    out = []
    # viterbi_decode: the adaptive stage A it serves (launches of the MCS-2
    # dense run, time and bound at its 512 x 24 trellises)
    for name, src, replaces, launches, err, ms, plain, bound, lib in (
            ("sync_stats", "sync_stats.cu", "pallas_sync.py:104",
             stats_launches["sync_stats"], k1_err, k1_ms, k1_plain, k1_bound, None),
            ("sync_detect", "sync_stats.cu", "pallas_sync.py:104",
             main_launches["sync_detect"], held_err("sync_detect", k1d_err), k1d_ms, k1d_plain,
             k1d_bound, None),
            ("viterbi_decode", "viterbi_acs.cu", "pallas_viterbi.py:125",
             amain["launches"]["viterbi_decode"], held_err("viterbi_decode", k2_err), k2a_ms,
             k2a_plain, k2a_bound, None),
            ("viterbi_decode_many", "viterbi_acs.cu", "pallas_viterbi.py:125",
             main_launches["viterbi_decode_many"], held_err("viterbi_decode_many", k2m_err),
             k2m_ms, k2m_plain, k2_bound, None),
            ("fir_filter", "fir.cu", "pallas_fir.py:84", fir_launches["fir_filter"],
             k3_err, k3_ms, k3_plain, k3_bound, k3_lib),
            ("polyphase_resample", "fir.cu", "pallas_fir.py:179",
             gen_launches["polyphase_resample"], held_err("polyphase_resample", k4_err), k4_ms,
             k4_plain, k4_bound, k4_lib)):
        by = max(bound, key=bound.get)
        out.append({"name": name, "route": "cuda", "source": f"{pkg_src}/{src}",
                    "replaces": f"{jax_ops}/{replaces}", "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound[by],
                    "bound_by": by, "library_ms": lib,
                    "radio_launches": {k: v[name] for k, v in radio_launches.items()},
                    "app_launches": {k: v[name] for k, v in app_launches.items()},
                    "sv_launches": sv_launches[name], "train_launches": train_launches[name],
                    "dqn_launches": dqn_launches[name], "zoo_launches": zoo_launches[name],
                    "mesh_launches": {k: v[name] for k, v in mesh_launches.items()},
                    "multichip_launches": {k: v[name] for k, v in multichip_launches.items()},
                    "waterfall_launches": waterfall_launches[name],
                    "soak_launches": soak_launches[name],
                    "graph_launches": {k: v[name] for k, v in graph_launches.items()},
                    "serving_graph_launches": {k: v[name]
                                               for k, v in serving_launches.items()}})
    print(f"per executor step: sync_detect on ({rows}, {n_ext}): {k1d_ms:.4f} ms, plain "
          f"{k1d_plain:.3f} ms; viterbi_decode_many on ({n_slots}, {payload_steps}) + "
          f"({n_slots}, 24): {k2m_ms:.4f} ms, plain {k2m_plain:.2f} ms. Off the step: "
          f"sync_stats {k1_ms:.4f} ms, plain {k1_plain:.3f} ms; viterbi_decode "
          f"{k2_pay:.4f} + {k2_sig:.4f} ms, plain {k2_pay_plain:.2f} + {k2_sig_plain:.2f} ms "
          f"(CUDA events; {card})")
    k3_b, k4_b = max(k3_bound.values()), max(k4_bound.values())
    print(f"fir_filter on {tuple(fir_x.shape)} x {FIR_TAPS} taps: {k3_ms:.4f} ms ({k3_b / k3_ms:.0%} "
          f"of its {k3_b:.4f} ms bound; taps as a CUDA tensor {k3_dev_ms:.4f} ms), plain "
          f"{k3_plain:.3f} ms, conv1d {k3_lib:.4f} ms; "
          f"polyphase_resample 3/4 on {tuple(k4_x.shape)} -> {n_out4}: {k4_ms:.4f} ms "
          f"({k4_b / k4_ms:.0%} of its {k4_b:.4f} ms bound), plain {k4_plain:.3f} ms, conv1d "
          f"{k4_lib:.4f} ms (CUDA events; {card})")
    if parent:
        # the parent checkout's K3 and K4 beside this one's, in turns
        for root in (parent, HERE, HERE, parent):
            r = fir_times_of(root)
            f, fd, rs = (min(r[k]) for k in ("fir_ms", "fir_device_taps_ms", "resample_ms"))
            print(f"  {'parent' if root == parent else 'this tree'} ({root}): fir_filter "
                  f"{f:.4f} ms ({k3_b / f:.0%} of bound; taps as a CUDA tensor {fd:.4f} ms), "
                  f"polyphase_resample {rs:.4f} ms ({k4_b / rs:.0%} of bound) (best of 3 x 20, "
                  f"CUDA events; {card})")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "gnuradio_wifi_imagetransfer_tpu"
                    or m.startswith("gnuradio_wifi_imagetransfer_tpu."))
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")
    print(f"adaptive frames/s ({card}): {json.dumps({k: round(v, 1) for k, v in fps.items()})}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except AssertionError as e:          # a kernel call held against its plain version
        fail(str(e))
