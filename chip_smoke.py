#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each ending with one JSON progress line on stdout (with the seconds
since the script started, `elapsed_s`):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the three CUDA kernels (dream_tpu_torch/csrc/score_kernel.cu,
   warp_kernel.cu and conv_int8_kernel.cu) with nvcc for sm_90a, one nvcc
   each, started together; the build time and ptxas's registers and spills;
3. hold the score kernel against its plain torch version on the card: f32
   belief maps (Gaussian blobs plus noise) at 100x100 (N=448), at the vgg-Q
   batch shape (N=112), at 400x400 (N=14) and at an odd 37x53; peak counts
   must be equal, and on valid peaks coords agree to 1e-4 and scores to 1e-5;
4. hold the warp kernel against its plain torch version on the card: 0-255
   f32 images at the training shape [32, 400, 400, 3] under in-range random
   affines, the extreme in-range affine, an out-of-range affine that folds
   more than once and the identity, and at an odd [3, 37, 53, 3]; the max
   abs error must be <= 2e-3 and the identity exact;
5. the evaluation path: load the vgg-Q r5 checkpoint and its YAML sidecar
   through the port, render the seed-99 64-frame 640x480 panda holdout in
   memory, and run evaluate_frames in float32 (set in the loaded config
   dict; the sidecar says bfloat16; TF32 off for matmuls and cuDNN); the
   score kernel's launch counter must have gone up, and the
   metrics must meet bounds around
   trained_models/results_r5/eval_vggq_r5/analysis_results.txt (a bf16 TPU
   run, so exact equality is not expected);
6. the training path: a float32 vgg-Q network from the r5 sidecar with the
   port's initial parameters (seed 0), 32 frames rendered at 640x480 (seed 0, not
   the holdout), train_raw steps at batch 32 with augmentation and EMA on
   (the warp kernel must launch once a step, every loss be finite); then a
   short run on one fixed batch with augmentation off must end below its
   first loss; the same augmented step from the same state and seeds through
   the kernel and through the plain warp must give losses within 1e-5
   relative (cuDNN deterministic); and a save to a temporary directory,
   reloaded through the port, must give bit-equal parameters and identical
   belief maps;
7. timings with CUDA events after warm-up: the score kernel's device time
   (a CUDA graph of 50 launches, so no host dispatch) at the vgg-Q shape
   [112, 100, 100] and at [14, 400, 400], its wrapper's time a call and its
   plain version's (back-to-back calls) at the vgg-Q shape, the model
   forward at B=16 and frames/s of the evaluation loop; the warp kernel on a
   given inverse (what F.grid_sample is given too) by device time and a
   call, the wrapper with its inverse, the plain version and F.grid_sample
   (device time and a call) at [32, 400, 400, 3]; the train step at
   B=32, split into the batch processor, forward, forward+backward and
   forward+backward+optimizer; peak device memory of training; and one
   step under torch.profiler: the device's busy share and longest kernels.

8. hold the int8 conv kernel (dream_tpu_torch/csrc/conv_int8_kernel.cu)
   against its plain torch version on the card, bit for bit: the 19 links
   of vgg-Q's int8 chain at B=2, each also without its ReLU where it has
   one, a two-link chain, and odd shapes ([1, 25, 50, 64] -> 64, H and W
   that are not multiples of the 5x25 tile, Co that ends inside a 64- or
   128-channel tile, a partial third channel tile)
   (phase 11 adds the 19 links at B=16, the main path's batch);
9. the int8 evaluation path on the phase-5 holdout, in the sidecars'
   bf16, against three bf16 TPU reports with phase 5's bounds: the float
   r4 vgg-Q
   (trained_models/results_r4/eval_vggq_plain), the same checkpoint with
   int8_calibration_frames=32 (results_r5/eval_vggq_ptq), and the QAT
   checkpoint (its sidecar says quant_mode: qat) calibrated the same way
   (results_r5/eval_vggq_qat_int8); each int8 run must launch the conv
   kernel 19 times a batch of 16 and the score kernel once, and the PTQ belief
   maps of one batch must correlate with the float maps at >= 0.99;
10. two augmented train_raw steps of the QAT network at batch 32 from its
   checkpoint: finite losses, one warp launch a step;
11. at each of the 19 links at B=16, the main path's shapes: the kernel
   against its plain version bit for bit, and torch._int_mm on the link's
   im2col matrix against the exact accumulator; then, with CUDA events
   after warm-up, the kernel, its plain version and torch._int_mm (the
   im2col built beforehand, outside the timing), per link and summed over
   the chain; the int8 forward against the float forward at B=16, and its
   longest kernels under torch.profiler; frames/s of the int8 evaluation
   loop; then a line with the conv kernel's limits at each link: its tile
   plan, ring stages, tiles and blocks launched, registers, spills and
   shared memory, and the share of the link's bound it reaches, and the
   chain's TOP/s per map size (25, 50, 100, 200);
12. vgg-Q r5 in its sidecar's bf16 on the holdout, against the r5 report
   with phase 5's bounds;
13. vgg-F r5 (trained_models/results_r5/vggf) on the holdout in bf16 and in
   float32, each against results_r5/eval_vggf: in-frame found within 6,
   out-of-frame found within 2, PCK AUC within 0.01, PnP at least 57/60,
   ADD AUC within 0.03, the score kernel once a batch of 16 (its 400x400
   maps); frames/s of a second evaluation loop; then three augmented
   train_raw steps at batch 32 from the vgg-F sidecar in bf16 (port initial
   parameters, seed 0): finite losses, one warp launch a step;
14. ResNet-H and ResNet-F (ResNet-101, 400x400) from their committed
   sidecars in bf16 with the port's initial parameters (`.chiprunignore`
   leaves their checkpoints out of remote runs): from those, a fixed-batch run of six steps
   ending below its first loss; then three augmented train_raw steps at
   batch 32 (finite losses, one warp launch a step), every BatchNorm running
   statistic moved by them and none by loss or inference, a save and reload through a
   temporary directory giving bit-equal parameters and buffers and
   identical maps, inference at batch 16 launching the score kernel once on
   208x208 or 416x416 maps, and float32 maps of the same state correlating
   with the bf16 maps at >= 0.99;
15. the score kernel against its plain version at [112, 400, 400], [112,
   208, 208] and [112, 416, 416] (phase 3's checks), and its device time
   there (CUDA graph) against its bound;
16. with CUDA events after warm-up, for vgg-Q, vgg-F, ResNet-H and ResNet-F
   in float32 and bf16 (port initial parameters): the forward at B=16, the
   augmented train_raw step at B=32 and its peak memory, and for bf16 one
   step under torch.profiler (busy share, longest kernels).

17. datasets on disk through the dataset CLI in a temporary directory: the
   seed-99 64-frame 640x480 panda holdout, which must decode bit for bit to
   phase 5's frames with keypoints equal in float32, and a 128-frame seed-11
   training set; ms a frame to write and to decode;
18. the evaluation CLI on the holdout (batch 16, no mosaics): vgg-Q r5 in
   its sidecar's bf16 under phase 5's bounds around the r5 report, with the
   report's lines, paths and numbers masked, equal to the committed
   report's, the committed CSV headers and row names, the score kernel
   once a batch, and its keypoints against the committed keypoints.csv
   (printed, not gated); vgg-F r5 under phase 13's bounds; the r4
   checkpoint with --int8-calibration-frames 32 under results_r5/eval_vggq_ptq's
   bounds, the conv kernel 19 times a batch; vgg-Q r5 with --ransac, with
   --pnp-weight-by-score --pnp-reject-outliers-px 10 and with
   --pnp-soft-detections --pnp-reject-outliers-px 5, each keeping PnP
   successes at or above the plain run's and ADD AUC in [0, 1];
19. the training CLI on the 128 frames with the r5 recipe's flags (batch
   32, bf16, clipping, --cache-device, EMA), which scan each epoch (the
   CLI prints so; one CUDA graph of the step, replayed): vgg-Q for 2
   epochs, then -r to 3 (the checkpoint layout, one warp launch a step
   counted through the replays, finite losses, the optimizer's count equal
   to the steps taken, the log's epochs and resume, best_network through
   the evaluation CLI, the peak device memory the CLI prints); one epoch of
   vgg-F grafted from the r5 vgg-Q checkpoint (--init-encoder,
   --loss-pos-weight 800); one QAT epoch from the r4 checkpoint;
20. timings: the evaluation CLI's frames/s against evaluate_frames in
   memory in the same dtype, the CLI's stages (decode, preprocess, model,
   peak decode, PnP), each PnP mode over the 64 frames, the training
   CLI's epochs in images/s against train_raw (phases 7 and 16), and an
   epoch checkpoint's host snapshot and file writes.

21. serving, live, on the phase-17 holdout on disk: make_http_server
   in-process on 127.0.0.1 (a free port) serving vgg-Q r5 in its sidecar's
   bf16, single-frame mode, one timed first request and two more warm-up
   requests, then the port's client CLI as a subprocess (--rate 1000) over
   the 64 frames: 64 image requests answered, the score kernel 64 times;
   the score kernel bit for bit against its plain version at a request's
   shapes (a served frame's [7, 100, 100] maps and random ones); the detections against
   phase 18's bf16 keypoints.csv (found state equal on at least 445 of 448,
   median distance at most 0.05 px); poses published on phase 18's PnP
   successes +-1; the ADD AUC of the published camera_from_robot poses
   (the client posts camera-frame keypoints, so the true pose is the
   identity) within 0.01 of phase 18's; then a multi-frame server over 16
   frames capturing every fourth: the buffer holds the captured solved
   frames' detections, a pose is published, /clear_buffer empties it;
22. serving with online int8: the r4 checkpoint with
   int8_calibration_frames=32 over the 64 frames in order: /status reads
   calibrating after frames 1-31 and active from frame 32's answer on, the
   conv kernel 19 x 32 = 608 times; the amax the server calibrated beside
   phase 18's PTQ calibration recomputed (the same 32 frames in batches of
   16) within 1e-2 relative; frames 33-64's found state equal to that run's
   keypoints.csv on at least 98% of the keypoints; the conv kernel bit for
   bit against its plain version at B=1, the request's batch: each link of
   the served chain at its own input on frame 33 (and the chain's maps
   against the exact plain route's), and random operands at each link's
   shape;
23. export through the export CLI (batch 1, 640x480, on the card,
   --self-test): vgg-Q r5 in bf16, and r4 PTQ calibrated on the holdout's
   first 32 frames; each .pt2 loaded and run in a subprocess that imports
   torch alone (the package never enters sys.modules; its keypoints equal
   the in-process call's); the int8 artifact over the 64 frames at batch 1
   against the PTQ CLI's keypoints.csv (445 of 448, median 0.05 px); the
   float artifact served by serve_dream --artifact (3 warm-up requests) to
   the client over the 64 frames: the detections against phase 21's (445
   of 448, median 0.05 px); no kernel launch in any artifact call;
24. timings: POST /image latency p50, p90 and max of the live bf16 and
   artifact servers (the client runs of phases 21 and 23) and of live int8
   (phase 22's requests once int8 was active), the first request's, the
   stages of a request (PNG decode, preprocessing, model, peak decode, PnP,
   and the HTTP remainder against the live bf16 p50), the unthrottled
   client's frames/s, the export times, the .pt2 sizes, and each
   artifact's ms a frame at batch 1.

25. the exact int32 route of the quantized conv graphs
   (dream_tpu_torch/ops/conv_int32.py: torch._int_mm on im2col matrices,
   transposed convs by phases) against its plain float64 version, bit for
   bit, on random int8 operands at every distinct conv of vgg-F's int8
   graph and of ResNet-H/F's deploy graphs at B=2 (400x400 input: the 7x7
   stride-2 stem, 1x1, 3x3 stride 2, the 4x4 stride-2 transposed convs at
   each upsampler's size) and at an odd transposed conv;
26. vgg-F r5 with --int8-calibration-frames 32 (the quantconv graph)
   through the evaluation CLI on the phase-17 holdout, batch 16, in its
   sidecar's bf16, against phase 18's float run of the same checkpoint:
   in-frame found within 6, PCK AUC within 0.02, ADD AUC within 0.03, PnP
   at least 56/60, the score kernel once a batch and the int8 conv kernel
   never; one batch's int8 maps correlating with the float maps at >= 0.99;
27. ResNet-H and ResNet-F at full width from the port's initial parameters
   in bf16: the BatchNorm-folded deploy graph in float32 against the
   BatchNorm model's eval maps (largest difference at most 1e-3 of the
   largest map value, correlation >= 0.99999), then int8 after calibrating
   on the holdout's first 32 frames: maps correlating with the float maps at
   >= 0.98, the score kernel once a batch of 16;
28. the export CLI on vgg-F r5 with --int8-calibration-dir (the holdout, 32
   frames, batch 1, 640x480): the sidecar names the quantconv graph; the
   .pt2 loaded in a subprocess that imports torch alone and run over 16
   holdout frames, equal to the in-process artifact, no kernel launched,
   and against the live int8 network: found state equal on all but 1% of
   the keypoints, median distance at most 0.05 px;
29. vgg-Q from the r5 sidecar with the soft-argmax head (learned beta),
   port initial parameters, batch 16 in float32, bf16 and int8 (quantconv):
   the keypoints within 1e-3 px of a float64 soft-argmax of the returned
   maps, no kernel launched; DOPE at [1, 400, 400, 3] gives six [1, 7, 50,
   50] stage maps; then timings: the int8 forward at B=16 against the bf16
   forward for vgg-F, ResNet-H and ResNet-F, the exact route's ms summed
   over each graph's convs at B=16 and its peak memory, phase 26's CLI
   frames/s against phase 18's, and the soft-argmax decode at B=16.

30. the visualization layer on the phase-17 holdout (vgg-Q r5 in its
   sidecar's bf16, batch 16): (a) whether cv2, PIL, matplotlib, webcolors
   and ffmpeg are there (nothing is installed; none of the four libraries
   may enter sys.modules through the port); (b) the evaluation CLI's
   default command line, mosaics on: the three 3,216x480 mosaics,
   keypoints.csv byte-equal to phase 18's, the score kernel once a batch,
   red at the centre of each detection no ground-truth dot covers, the
   mosaics' seconds; (c) the single-image CLI on frame 000000: its five
   PNGs at their sizes, one score launch, its detections against phase
   18's row (found state equal, median within 0.05 px: batch 1 against 16
   in bf16); (d) the video CLI on frames 0-15, all four types: 16 frames
   each, one score launch, an .mp4 exactly when ffmpeg is there, frames/s
   by type; again with --int8-calibration-frames 16: 19 conv launches;
   (e) one more request to phase 21's server, then its five debug streams
   as 200 image/png at their sizes, an unknown stream 404, and the artifact
   server's net_input_image 404; (f) a HEAVY dump of 4 frames (12 PNGs) and
   an INTERACTIVE one (and index.html); (g) host ms a call of the drawing.

31. the host image loader and JPEG frames, encoder pretraining and the
   workflow's remaining tools, on the phase-17 sets: (a) which of libjpeg,
   libpng and zlib (headers and libraries) and which compilers the
   machine has, the loader's build time (into a temporary directory), the
   64 holdout PNGs decoded by the loader bit for bit as decode_png decodes
   them, and ms a frame at 1 and 8 threads; (b) a JPEG copy of the holdout
   (quality 90, 4:2:0) written by scripts/make_jpeg_copy.py with PIL in a
   process of its own (this script imports no PIL; without PIL the phase
   fails), each frame decoded by the loader bit for bit as PIL decodes it,
   ms a frame at 1 and 8 threads, and the evaluation CLI with vgg-Q r5 bf16
   on it: 4 score launches, phase 18's PNG run's report as the reference
   under phase 13's bounds (out-of-frame found within 2; PnP at least
   56/60), frames/s; (b') a progressive copy (the same quality and
   subsampling, libjpeg's 10-scan script, `--progressive`): each frame as
   PIL decodes it and equal to (b)'s frame, ms a frame at 1 and 8 threads
   beside (b)'s, the evaluation CLI on it: 4 score launches and
   keypoints.csv equal line for line to (b)'s; after (c), 8 progressive
   bodies posted to a server on phase 21's network: 8 score launches, each
   request's detections equal to (c)'s for the same frame and within (c)'s
   bounds of the progressive CLI run's rows; (c) the 64 JPEG frames through the
   client to a live bf16 server on phase 21's network: the score kernel
   once a request, found states as (b)'s keypoints.csv on all but 3
   keypoints (median 0.05 px), poses published within 1 of (b)'s PnP
   successes, request p50; (d) pretrain_encoder at its defaults (256x256,
   batch 32, bf16), 200 steps on a 64-scene device pool (finite losses, the
   last 50's mean below the first 50's) and 20 streamed steps, images/s of
   each; (e) one training-CLI epoch of vgg-Q with the r5 flags from (d)'s
   encoder (--init-encoder) on the 128-frame set: 32 leaves grafted, none
   skipped, the warp kernel once a step; (f) resolve_pnp on (b)'s
   keypoints.csv: plain reproduces (b)'s pnp_results.csv (names, success,
   in-frame counts equal, poses and ADD within 1e-4), and --ransac, each
   timed; (g) compress_checkpoint of (e)'s best network and of phase 19's
   vgg-Q, each file and its float16 copy on 16 holdout frames: belief
   maps correlating at >= 0.999 and PCK AUC within 0.005 (found states
   printed).  With DREAM_SMOKE_ARTIFACTS naming a directory, the phase copies
   (b)'s and phase 18's keypoints.csv and (f)'s RANSAC pnp_results.csv
   there.

32. the multi-GPU layer and the plots on the one card (dream_tpu_torch/
   parallel): (a) vgg-Q r5 from its checkpoint, two augmented train_raw
   steps at batch 32 on phase 6's frames, unsharded in bf16 and in float32,
   each also with cuDNN choosing its algorithms by timing (rounding's own
   spread, printed), then in bf16 as one NCCL rank through shard_for_mesh;
   (b) two ranks sharing the card under gloo (spawned), in bf16 and in
   float32: vgg-Q (data 2) and (data 1, model 2), and (b') ResNet-H from
   initial parameters, batch 8, (data 2); and vgg-Q (data 1, model 2) in
   float64 for one step against the unsharded float64 step; the ranks run
   with this process's TF32 settings (off).  Each run is held to the unsharded run
   of its network and dtype by the fixed gates of MESH_GATES (first step:
   loss, gradients, running statistics; last step: loss, parameter
   updates, running statistics), and the phase checks each gate against
   the readings of planted faults (state unchanged, gradients summed over
   the data ranks, split gradients scaled by the model axis, BatchNorm on
   one rank's rows), printed beside it; ms a step of each layout; the warp
   kernel once a step on each rank; where vgg-Q's float32 (data 1, model
   2) gradients part from the unsharded step's, each leaf against the
   float64 step and the forward's decisions that part on 2 frames
   (split_gradient_reading; MESH_GATES says why); (c) the training CLI with
   --mesh-data 2 --dist-backend gloo for one epoch on the 128-frame set
   with the r5 flags, each rank loading 16 frames of each global batch of
   32: finite losses, the best network's msgpack layout equal to phase
   19's one-rank run's, the warp kernel once a step on each rank; (d) a
   2-stage vgg-Q cascade at 400x400 (the r5 sidecar with n_stages 2,
   initial parameters, float32), batch 16 in 4 microbatches on [cuda:0,
   cuda:0]: the pipelined maps within 1e-5 of the sequential forward's, the
   keypoints equal, and one pipelined train step's loss within 1e-5
   relative of the sequential criterion's; (e) analyze_training on (c)'s
   run (the loss plot and the evaluation through the score kernel), then
   add_plots (PNG) and oks_plots (PDF) on phase 18's CSVs: AUCs equal to
   that run's report to its 5 digits, host ms to render a plot; (f)
   dryrun_multichip(2, "cuda", "gloo").  The spawned ranks report their
   kernel launches back.

33. scanned epochs (DreamNetwork.enable_scanned_training + train_epoch_raw:
   the fused step captured once as a CUDA graph and replayed for each step)
   on phase 6's 32 frames held on the card, batch 32, three steps an epoch
   (each a permutation of the frames), augmentation on: vgg-Q in bf16 from the r5
   sidecar's initial parameters on the r5 recipe's optimizer (Adam 2e-4,
   clip 1.0) with an EMA of 0.999, ResNet-H in bf16 from initial parameters
   (its sidecar's Adam, clip and cosine schedule; BatchNorm's running
   statistics move inside the graph) and the QAT checkpoint (its sidecar's
   optimizer); for each, two scanned epochs and two eager epochs of the same
   step (train_epoch_raw_plain) from one start and one seed, cuDNN
   deterministic: losses, parameters, running statistics, EMA, Adam's
   moments and counts bit-equal, the warp kernel once a step counted
   through the replays; then for vgg-Q and ResNet-H, under cuDNN's
   defaults, with CUDA events after a warm-up epoch, ms a step both ways
   (the median of 3 epochs), one epoch of each under torch.profiler (the
   host's launch and copy calls, the device's busy share) and the peak
   device memory of each.

Then a line listing the kernels with their measurements (each row's ms and
library_ms time the same work; the score and warp rows' ms is device time
from a CUDA graph, and the warp's library_ms too; the score row adds its
device time at phase 15's shapes; redesigned_in names the design the kernel
now has; launches are counted on the CLI runs of phases 18-19, the
counted serving runs of phases 21-22, the runs of phases 30, 31 and 32
(with its spawned ranks), the scanned runs of phase 33 and,
for the score kernel, the int8 runs of phases 26-27), and as the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before that line.  Without CUDA the script exits non-zero at once.
"""

import contextlib
import copy
import csv
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
REFERENCE = os.path.join(ROOT, "trained_models/results_r5/eval_vggq_r5/analysis_results.txt")
R4_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r4/vggq/dream_vgg_q_r4.msgpack")
R4_CONFIG = os.path.join(ROOT, "trained_models/results_r4/vggq/dream_vgg_q_r4.yaml")
QAT_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.msgpack")
QAT_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.yaml")
VGGF_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.msgpack")
VGGF_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.yaml")
VGGF_REFERENCE = "trained_models/results_r5/eval_vggf/analysis_results.txt"
# The ResNets' sidecars and map sizes; `.chiprunignore` leaves their
# checkpoints out of remote runs, so they start from initial parameters.
RESNETS = {
    "resnet-H": (os.path.join(ROOT, "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml"), 208),
    "resnet-F": (os.path.join(ROOT, "trained_models/results_r5/resnetf/dream_resnet_f_r5.yaml"), 416),
}
PANDA = os.path.join(ROOT, "manip_configs/panda.yaml")
VGGQ_ARCH = os.path.join(ROOT, "arch_configs/dream_vgg_q.yaml")
VGGF_ARCH = os.path.join(ROOT, "arch_configs/dream_vgg_f.yaml")
REFERENCE_DIR = os.path.join(ROOT, "trained_models/results_r5/eval_vggq_r5")
# The r5 training recipe's flags (scripts/r5_artifact_queue.sh:59-61), and
# the sizes of the sets the workflow phases write.
R5_TRAIN_FLAGS = ["-b", "32", "-lr", "2e-4", "--grad-clip-norm", "1.0", "--cache-device",
                  "--compute-dtype", "bfloat16", "-s", "42", "-w", "8"]
HOLDOUT_FRAMES = 64
TRAIN_SET_FRAMES = 128
# What the training CLI prints when it scans its epochs on the card.
SCANNED_LINE = "Scanned-epoch training: the step captured once as a CUDA graph"
# Phase 33: steps of a scanned epoch at batch 32 (each a permutation of
# phase 6's 32 frames), and the r5 recipe's optimizer
# (scripts/r5_artifact_queue.sh:59-61).
SCAN_STEPS = 3
R5_OPTIMIZER = {"type": "adam", "learning_rate": 2e-4, "grad_clip_norm": 1.0}
INT8_REFERENCES = {
    "float_r4": "trained_models/results_r4/eval_vggq_plain/analysis_results.txt",
    "ptq_r4": "trained_models/results_r5/eval_vggq_ptq/analysis_results.txt",
    "ptq_qat": "trained_models/results_r5/eval_vggq_qat_int8/analysis_results.txt",
}

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 off the tensor
# cores, dense int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
CALIBRATION_FRAMES = 32
QAT_STEPS = 2
TRAIN_BATCH = 32
AUGMENTED_STEPS = 3
FIXED_BATCH_STEPS = 6
WARP_ATOL = 2e-3
STEP_LOSS_RTOL = 1e-5
# Phase 32: steps a mesh run takes, and the fixed gates that hold each mesh
# run to the unsharded run of its network in its dtype: the first step's
# loss (relative), gradients (relative L2, over every parameter and over the
# channel-split ones alone: these hold a small share of vgg-Q's gradient
# norm) and BatchNorm running statistics (largest difference over largest
# magnitude), and after the last step the
# loss, the parameter updates (mean absolute difference over the mean
# update) and the running statistics.  Each gate lies below what a planted
# fault reads, which the phase computes and checks: the state left
# unchanged reads 1 on the updates; gradients summed over the D data ranks
# instead of averaged read D - 1; the split convs' gradients scaled by the
# M model ranks read M - 1 over the split parameters;
# BatchNorm on one rank's rows (statistics not all-reduced) reads what the
# unsharded network's first step on rank 0's rows gives.  None: printed,
# not gated.  ResNet-H's gradient from initial parameters is ~1e-6 of the
# signal its BatchNorm backward receives (the rest cancels), so rounding
# alone moves it: 6% in float32, ~120% in bf16 (the unsharded bf16 run
# against float32), the same on every leaf.  Its bf16 gradients and the
# updates Adam makes of them are therefore held in float32 alone, where the
# 0.1 gradient gate stands on scripts/mesh_gradient_conditioning.py's
# witness (float64: two ranks equal one to rounding; float32: 6% from
# float64, one rank or two).  vgg-Q's (data 1, model 2) float32 gradients
# lie 2.8e-3 from the unsharded float32 run's, which lies 1.6e-4 from
# float64, while the same layout in float64 (one step,
# ``dream_tpu_torch.parallel.dryrun.to_float64``) equals the unsharded
# float64 run to float64's rounding (gate 1e-9).  The cause is float32
# rounding flipping a few discrete decisions of the forward, not the
# split path.  Over the batch, each float32 run takes 0-24 of a layer's
# ReLU signs and 2x2 max-pool picks otherwise than float64 does, and the
# split run takes no more than the unsharded one.  Where a flip lands on a
# large gradient, it moves that layer's weight gradient.  On the H100
# (scripts/split_gradient_layers.py) the split run's gap enters at
# down4.conv3's weight gradient: 1.46e-2 against the unsharded run's
# 3.8e-6.  Replaying the split run's down4 decisions in float64 moves that
# gradient by 1.46e-2; the unsharded run's decisions move it by 4.2e-7.
# That conv alone, split or whole, is as precise as float32 allows
# (2.4-3.2e-6).  Which flips land where is chance: with cuDNN's
# algorithms chosen by timing, one call read 2.2e-4 and another 2.75e-3.
# So that layout's float32 gradient gates are 1e-2, and phase 32 prints
# the reading (``split_gradient_reading``).  Keys: (network, dtype) and,
# where a layout's gates differ, (network, dtype, layout).
MESH_STEPS = 2
MESH_GATES = {
    ("vgg-Q", "bfloat16"): {"loss_1": 5e-3, "grads_1": 0.1, "grads_split_1": 0.2, "loss_last": 2e-2,
                            "update_last": 0.2},
    ("vgg-Q", "float32"): {"loss_1": 1e-5, "grads_1": 1e-3, "loss_last": 1e-4, "update_last": 0.02},
    ("vgg-Q", "float32", "model2"): {"loss_1": 1e-5, "grads_1": 1e-2, "grads_split_1": 1e-2,
                                     "loss_last": 1e-4, "update_last": 0.02},
    ("vgg-Q", "float64", "model2"): {"loss_1": 1e-6, "grads_1": 1e-9, "grads_split_1": 1e-9,
                                     "loss_last": 1e-6, "update_last": 1e-9},
    ("resnet-H", "bfloat16"): {"loss_1": 5e-3, "grads_1": None, "running_1": 0.1, "loss_last": 5e-2,
                               "update_last": None, "running_last": 0.5},
    ("resnet-H", "float32"): {"loss_1": 1e-5, "grads_1": 0.1, "running_1": 1e-4, "loss_last": 5e-3,
                              "update_last": 0.5, "running_last": 0.05},
}


STARTED = time.perf_counter()


def progress(phase, **fields):
    """A phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - STARTED, 1), **fields}),
          flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches=50, reps=5):
    """Device milliseconds a call of ``fn()``, without host dispatch: CUDA
    events around the replay of a CUDA graph of ``launches`` calls,
    captured after a warm-up on a side stream; the least of ``reps``
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return min(times)


def random_maps(rng, n, h, w):
    """f32 [n, h, w] maps: 1-3 Gaussian blobs of random height plus noise."""
    from dream_tpu_torch.ops.belief_maps import create_belief_maps

    maps = np.zeros((n, h, w), np.float32)
    for blob in range(3):
        kp = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        amp[rng.rand(n) < 0.4 * blob] = 0.0
        maps += amp * create_belief_maps(torch.from_numpy(kp)[:, None], (w, h))[:, 0].numpy()
    maps += rng.rand(n, h, w).astype(np.float32) * 0.004
    return torch.from_numpy(maps).cuda()


def compare_kernel(maps):
    """Kernel vs plain on the card; returns the largest error it saw."""
    from dream_tpu_torch.ops.belief_maps import _subpixel_refine
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain

    scored_k, count_k = score_maps_kernel(maps)
    scored_p, count_p = score_maps_plain(maps)
    torch.cuda.synchronize()
    if not torch.equal(count_k, count_p):
        bad = int((count_k != count_p).sum())
        raise AssertionError(f"peak counts differ on {bad} of {maps.shape[0]} maps")
    if not torch.equal(torch.isinf(scored_k), torch.isinf(scored_p)):
        raise AssertionError("peak masks differ")
    coords_k, scores_k = _subpixel_refine(maps, scored_k, 0.4395, 8)
    coords_p, scores_p = _subpixel_refine(maps, scored_p, 0.4395, 8)
    valid = torch.arange(8, device=maps.device)[None, :] < count_p[:, None]
    coord_err = float((coords_k - coords_p)[valid].abs().max()) if valid.any() else 0.0
    score_err = float((scores_k - scores_p)[valid].abs().max()) if valid.any() else 0.0
    if coord_err > 1e-4 or score_err > 1e-5:
        raise AssertionError(f"coords err {coord_err} (bound 1e-4), scores err {score_err} (bound 1e-5)")
    return max(coord_err, score_err), int(count_p.sum())


def reference_metrics(path):
    text = open(path).read()

    def frac(label):
        m = re.search(re.escape(label) + r"[^(]*\((\d+)/(\d+)\)", text)
        if m is None:
            raise ValueError(f"{label!r} not found in {path}")
        return int(m.group(1)), int(m.group(2))

    aucs = [float(x) for x in re.findall(r"^\s*AUC: ([0-9.]+)", text, flags=re.M)]
    return {
        "outframe_found": frac("out-of-frame gt keypoints found (incorrect)"),
        "inframe_found": frac("in-frame gt keypoints found (correct)"),
        "pnp_success": frac("PNP was successful when viable (correct)"),
        "pck_auc": aucs[0],
        "add_auc": aucs[1],
    }


def kernel_bound_ms(n, h, w):
    """Least time for the score kernel's work on an H100: read each map once,
    write the scored map and the count once; 2 flops per blur tap taken."""
    from dream_tpu_torch.ops.score_kernel import PEAK_BLUR_SIGMA, _blur_band

    taps_h = int(np.count_nonzero(_blur_band(h, float(PEAK_BLUR_SIGMA))))
    taps_w = int(np.count_nonzero(_blur_band(w, float(PEAK_BLUR_SIGMA))))
    bytes_moved = n * h * w * 4 * 2 + n * 4 + (h + w) * 25 * 4
    flops = n * 2 * (taps_h * w + taps_w * h)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def warp_inputs(n, h, w, kind, seed):
    """0-255 f32 images and [n, 2, 3] forward affines on the card."""
    from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, affine_matrices, sample_augment_params

    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.rand((n, h, w, 3), generator=g, device="cuda") * 255.0
    ones = torch.ones(n, device="cuda")
    apply = ones > 0
    if kind == "random":
        cfg = DEFAULT_AUGMENT._replace(p_shift_scale_rotate=1.0)
        affines = sample_augment_params(g, n, h, w, cfg).affines
    elif kind == "extreme":  # the TPU kernel's worst case: folds on every side
        affines = affine_matrices(apply, 15 * ones, 0.9 * ones, 0.0625 * w * ones,
                                  -0.0625 * h * ones, h, w)
    elif kind == "multifold":  # outside the augmentation's range, folds twice or more
        affines = affine_matrices(apply, 70 * ones, 0.3 * ones, 1.7 * w * ones,
                                  -2.3 * h * ones, h, w)
    else:
        affines = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], device="cuda").expand(n, 2, 3)
    return images, affines


def compare_warp(images, affines, identity):
    """Warp kernel vs plain on the card; returns the largest error."""
    from dream_tpu_torch.ops.warp import warp_batch_kernel, warp_batch_plain

    out = warp_batch_kernel(images, affines)
    ref = warp_batch_plain(images, affines)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if identity and not torch.equal(out, images):
        raise AssertionError("the warp kernel changed an image under the identity affine")
    if not err <= WARP_ATOL:
        raise AssertionError(f"warp kernel differs from plain by {err} (bound {WARP_ATOL})")
    return err


def warp_bound_ms(n, h, w, c):
    """Least time for the warp's work on an H100: read each image value once,
    write each output value once, read the [n, 6] inverse; ~30 flops a pixel
    for the coordinates, fold and weights, 11 a channel for the taps."""
    bytes_moved = 2 * n * h * w * c * 4 + n * 6 * 4
    flops = n * h * w * (30 + 11 * c)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grid_sample_warp(images_nchw, inverse):
    """The yardstick: F.grid_sample with reflection padding and
    align_corners=True (reflect-101 about the border pixels' centres) on the
    inverse-affine grid."""
    import torch.nn.functional as F

    n, _, h, w = images_nchw.shape
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32), indexing="ij")
    i = inverse[:, :, None, None]
    src_x = i[:, 0] * xs + i[:, 1] * ys + i[:, 2]
    src_y = i[:, 3] * xs + i[:, 4] * ys + i[:, 5]
    grid = torch.stack([src_x / (w - 1) * 2 - 1, src_y / (h - 1) * 2 - 1], dim=-1)

    def run():
        return F.grid_sample(images_nchw, grid, mode="bilinear", padding_mode="reflection",
                             align_corners=True)

    return run


def profile_busy(fn, top=5, kernels=()):
    """Wall ms of ``fn()`` unprofiled and under torch.profiler, the device's
    busy ms in the profiled run (the sum of device-side events, which counts
    overlapping kernels twice), launches and the ``top`` longest kernels,
    the host's launch and copy calls into CUDA (``cuda*`` and ``cu*``;
    a CUDA graph's replay is one ``cudaGraphLaunch``) and, for each name in
    ``kernels``, the device-side events whose name holds it: the device's
    own count of that kernel's runs, a CUDA graph's replays included."""
    from torch.autograd import DeviceType

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = timed()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms_profiled = timed()
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    busy_ms = sum(device_us(e) for e in events) / 1e3
    longest = sorted(events, key=device_us, reverse=True)[:top]
    host_calls = {e.key: e.count for e in averages if e.device_type == DeviceType.CPU
                  and e.key.startswith("cu") and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}
    return {"wall_ms": wall_ms, "wall_ms_profiled": wall_ms_profiled, "device_busy_ms": busy_ms,
            "device_idle_share_profiled": 1 - busy_ms / wall_ms_profiled,
            "device_launches": sum(e.count for e in events),
            "host_launch_calls": sum(host_calls.values()), "host_calls": host_calls,
            "kernel_runs": {k: sum(e.count for e in events if k in e.key) for k in kernels},
            "top_kernels": [{"name": e.key[:80], "count": e.count, "ms": device_us(e) / 1e3}
                            for e in longest]}


def eval_bounds(result, ref, outframe_tol=0, min_pnp=56):
    """The measured metrics of an evaluate_frames result and the bounds they
    miss around a bf16 TPU reference report (empty when they meet them):
    in-frame found within 6, out-of-frame found within ``outframe_tol``,
    PCK AUC within 0.01, at least ``min_pnp`` PnP successes, ADD AUC within
    0.03."""
    kp, pnp = result["keypoints"], result["pnp"]
    measured = {
        "inframe_found": [kp["num_found_gt_inframe"], kp["num_gt_inframe"]],
        "outframe_found": [kp["num_found_gt_outframe"], kp["num_gt_outframe"]],
        "pck_auc": kp["l2_error_auc"],
        "pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
        "add_auc": pnp["add_auc"],
        "add_auc_transposed": result["pnp_transposed"]["add_auc"],
        "l2_error_mean_px": kp["l2_error_mean_px"],
        "add_mean": pnp["add_mean"],
    }
    failures = []
    if kp["num_gt_inframe"] != ref["inframe_found"][1] or kp["num_gt_outframe"] != ref["outframe_found"][1]:
        failures.append("the rendered holdout's ground truth differs from the reference run's")
    if abs(kp["num_found_gt_inframe"] - ref["inframe_found"][0]) > 6:
        failures.append(f"in-frame found {kp['num_found_gt_inframe']} not within 6 of {ref['inframe_found'][0]}")
    if abs(kp["num_found_gt_outframe"] - ref["outframe_found"][0]) > outframe_tol:
        failures.append(f"out-of-frame found {kp['num_found_gt_outframe']} not within "
                        f"{outframe_tol} of {ref['outframe_found'][0]}")
    if kp["l2_error_auc"] is None or abs(kp["l2_error_auc"] - ref["pck_auc"]) > 0.01:
        failures.append(f"PCK AUC {kp['l2_error_auc']} not within 0.01 of {ref['pck_auc']}")
    if pnp["num_pnp_possible"] != ref["pnp_success"][1] or pnp["num_pnp_found"] < min_pnp:
        failures.append(f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']} below "
                        f"{min_pnp}/{ref['pnp_success'][1]}")
    if not np.isfinite(pnp["add_auc"]) or abs(pnp["add_auc"] - ref["add_auc"]) > 0.03:
        failures.append(f"ADD AUC {pnp['add_auc']} not within 0.03 of {ref['add_auc']}")
    return measured, failures


def int8_case(gen, b, h, w, ci, co):
    """Random int8 activations and OHWI weights on the card, with k and b
    that spread the outputs over the whole int8 range."""
    x_q = torch.randint(-127, 128, (b, h, w, ci), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (co, 3, 3, ci), generator=gen, device="cuda", dtype=torch.int8)
    k = (torch.rand(co, generator=gen, device="cuda") + 0.5) / (80.0 * (9 * ci) ** 0.5)
    bias = torch.rand(co, generator=gen, device="cuda") * 60.0 - 30.0
    return x_q, w_q, k, bias


def compare_conv_int8(x_q, w_q, k, bias, relu):
    """int8 conv kernel vs plain on the card; raises unless bit-equal.
    Returns the kernel's output and the largest difference (0)."""
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel, conv3x3_int8_plain

    out = conv3x3_int8_kernel(x_q, w_q, k, bias, relu)
    ref = conv3x3_int8_plain(x_q, w_q, k, bias, relu)
    torch.cuda.synchronize()
    diff = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
    if diff != 0:
        raise AssertionError(f"int8 conv kernel differs from plain at {tuple(x_q.shape)} -> "
                             f"{w_q.shape[0]} relu={relu} on {int((out != ref).sum())} outputs")
    return out, diff


def conv_int8_bound_ms(shapes):
    """Least time for the chain's int8 convs on an H100: 2*9*Ci*Co operations
    an output pixel at the dense int8 tensor-core rate, against reading each
    input and weight once and writing each output once."""
    ops = sum(2 * 9 * b * h * w * ci * co for b, h, w, ci, co, _ in shapes)
    bytes_moved = sum(b * h * w * (ci + co) + 9 * ci * co + 8 * co for b, h, w, ci, co, _ in shapes)
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


def im2col_int8(x_q):
    """NHWC int8 -> [B*H*W, 9*Ci] int8, taps in the order of an OHWI
    weight's [Co, 9*Ci] rows."""
    b, h, w, ci = x_q.shape
    xp = torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * ci)


def snapshot(network):
    """The parameters, the optimizer's state as its optax tree (moments,
    count, so the schedule's position) and the EMA, as host or cloned
    copies."""
    return {
        "model": copy.deepcopy(network.model.state_dict()),
        "optimizer": network.optimizer_state(),
        "ema": {k: v.clone() for k, v in network.ema_params.items()},
    }


def restore(network, snap):
    """Back to ``snap``: the parameters and the EMA copied in place, the
    optimizer's state loaded from the tree (fresh tensors each time)."""
    network.model.load_state_dict(snap["model"])
    network.load_optimizer_state(snap["optimizer"])
    for k, v in snap["ema"].items():
        network.ema_params[k].copy_(v)


def config_in(config_path, compute_dtype=None):
    """A sidecar's config, with ``compute_dtype`` set in the loaded dict
    when given (the file's otherwise)."""
    from dream_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(config_path)
    if compute_dtype is not None:
        cfg["architecture"]["compute_dtype"] = compute_dtype
    return cfg


def load_network(config_path, params_path=None, compute_dtype=None, seed=0):
    """A network on the card from a sidecar (``compute_dtype`` as in
    :func:`config_in`), with the committed weights when ``params_path`` is
    given and the port's initial parameters from ``seed`` otherwise."""
    from dream_tpu_torch.network import DreamNetwork

    network = DreamNetwork(config_in(config_path, compute_dtype), device="cuda", seed=seed)
    if params_path is not None:
        network.load_network_params(params_path)
    return network


def processor_for(network, augment):
    """The batch processor of ``network``'s sidecar (640x480 raw frames)."""
    from dream_tpu_torch.data.dataset import make_batch_processor

    tcfg = network.network_config["training"]["config"]
    return make_batch_processor(
        tuple(tcfg["image_raw_resolution"]), network.trained_net_input_resolution(),
        network.trained_net_output_resolution(), network.image_preprocessing(),
        network.image_normalization, augment=augment)


def map_correlation(a, b):
    return float(np.corrcoef(a.double().cpu().numpy().ravel(), b.double().cpu().numpy().ravel())[0, 1])


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept in memory (the CLIs print
    whole configs); returns ``(result, text)``.  On an error the text's
    tail is printed before the error propagates."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args), buf.getvalue()
    except BaseException:
        sys.stdout.write(buf.getvalue()[-4000:])
        raise


NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def masked_report(path):
    """A report's lines with paths and numbers masked: its layout."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [NUMBER.sub("#", " ".join("<path>" if "/" in w else w for w in line.split(" ")))
            for line in lines]


def csv_layout(path):
    """A CSV's header and its row names."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]]


def csv_detections(path):
    """keypoints.csv's detected raw-frame keypoints ``[frames, n_kp, 2]``, in
    row order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    n_kp = (len(rows[0]) - 1) // 4
    return np.array([r[1:1 + 2 * n_kp] for r in rows[1:]], float).reshape(len(rows) - 1, n_kp, 2)


def detection_agreement(a, b):
    """How two sets of raw-frame detections agree: the keypoints (and their
    share) with the same found state, and the median and largest px
    distance where both found it."""
    found_a, found_b = a[..., 0] > -999.0, b[..., 0] > -999.0
    both = found_a & found_b
    dist = np.linalg.norm(a - b, axis=-1)[both]
    return {"same_found_state": int(np.sum(found_a == found_b)), "keypoints": int(found_a.size),
            "same_found_state_share": float(np.mean(found_a == found_b)),
            "both_found": int(both.sum()), "median_px": float(np.median(dist)),
            "max_px": float(dist.max())}


def keypoint_agreement(ours_csv, ref_csv):
    """:func:`detection_agreement` of two keypoints.csv files."""
    return detection_agreement(csv_detections(ours_csv), csv_detections(ref_csv))


def alternate_add_auc(text):
    m = re.search(r"rotation convention: ([0-9.]+) / ", text)
    return float(m.group(1)) if m else float("nan")


def workflow_phases(kernels_of_port, reset_counts, smi, holdout):
    """Phases 17-20: the command-line workflow on disk at full width, in a
    temporary directory: datasets written and read through the port's CLI
    and PNG codec, the evaluation CLI on four checkpoints and in every PnP
    mode, the training CLI with resume, an encoder graft and QAT, and their
    timings.  Returns the CLI runs' kernel launches, the timings, and under
    ``work`` the temporary directory with the holdout and the evaluation
    runs the serving phases hold themselves against."""
    from dream_tpu_torch import analysis
    from dream_tpu_torch.checkpoint import load_flax_checkpoint, state_to_flax
    from dream_tpu_torch.cli import make_synthetic_dataset as dataset_cli
    from dream_tpu_torch.cli import network_inference_dataset as eval_cli
    from dream_tpu_torch.cli import train_network as train_cli
    from dream_tpu_torch.data.dataset import ManipulatorNDDSDataset, make_batch_processor
    from dream_tpu_torch.network import create_network_from_config_file, dtype_name
    from dream_tpu_torch.ops import coords as coord_ops
    from dream_tpu_torch.utils.config import load_yaml
    from dream_tpu_torch.utils.png import read_png

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    def timed(fn, *args):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, text = quiet(fn, *args)
        torch.cuda.synchronize()
        return result, text, time.perf_counter() - t0, launches()

    out = {"launches": {}, "timings": {"card": smi}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name

    # 17. Datasets on disk through the dataset CLI.
    hold = os.path.join(tmp, "hold64")
    _, _, write_s, _ = timed(dataset_cli.main, dataset_cli.make_parser().parse_args(
        ["-m", PANDA, "-o", hold, "-n", str(HOLDOUT_FRAMES), "--seed", "99", "--holdout"]))
    names = [kp["name"] for kp in load_yaml(PANDA)["manipulator"]["keypoints"]]
    disk = ManipulatorNDDSDataset(hold, "panda", names, (400, 400), (100, 100), n_decode_threads=8)
    t0 = time.perf_counter()
    images = disk.load_images(range(HOLDOUT_FRAMES))
    decode_threaded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(8):
        read_png(disk.ndds_dataset_data[i]["image_paths"]["rgb"])
    decode_one_ms = (time.perf_counter() - t0) / 8 * 1e3
    if not np.array_equal(images, holdout["images"]):
        raise AssertionError("the holdout written to disk does not decode to the in-memory frames")
    if not (np.array_equal(disk.kp_projs_raw, holdout["projections"].astype(np.float32))
            and np.array_equal(disk.kp_positions, holdout["positions"].astype(np.float32))):
        raise AssertionError("the holdout's keypoints on disk differ from the in-memory ones")
    train_set = os.path.join(tmp, "train128")
    _, _, train_write_s, _ = timed(dataset_cli.main, dataset_cli.make_parser().parse_args(
        ["-m", PANDA, "-o", train_set, "-n", str(TRAIN_SET_FRAMES), "--seed", "11"]))
    out["timings"]["dataset"] = {
        "write_ms_per_frame": write_s / HOLDOUT_FRAMES * 1e3,
        "write_train_set_ms_per_frame": train_write_s / TRAIN_SET_FRAMES * 1e3,
        "decode_ms_per_frame_8_threads": decode_threaded_s / HOLDOUT_FRAMES * 1e3,
        "decode_ms_per_frame_one_thread": decode_one_ms}
    progress("datasets_on_disk", holdout="equal to the in-memory frames, bit for bit",
             keypoints="equal in float32", **out["timings"]["dataset"])

    # 18. The evaluation CLI on the card.
    def evaluate_cli(name, argv, reference, outframe_tol=0, min_pnp=56):
        out_dir = os.path.join(tmp, "eval_" + re.sub(r"\W+", "_", name))
        args = eval_cli.make_parser().parse_args(
            argv + ["-d", hold, "-o", out_dir, "--no-visualization", "-b", "16", "-w", "8"])
        (kp, pnp), text, seconds, counts = timed(eval_cli.network_inference_dataset, args)
        result = {"keypoints": kp, "pnp": pnp, "pnp_transposed": {"add_auc": alternate_add_auc(text)}}
        ref = reference_metrics(os.path.join(ROOT, reference))
        measured, failures = eval_bounds(result, ref, outframe_tol, min_pnp)
        if counts["score_kernel"] != HOLDOUT_FRAMES // 16:
            failures.append(f"the score kernel launched {counts['score_kernel']} times, not once a batch")
        if failures:
            raise AssertionError(f"{name}: " + "; ".join(failures))
        progress("evaluation_cli", run=name, seconds=seconds,
                 frames_per_s=HOLDOUT_FRAMES / seconds, launches=counts, measured=measured)
        return out_dir, result, seconds, counts

    vggq_dir, plain, plain_s, vggq_counts = evaluate_cli(
        "vgg-Q r5 bf16", ["-i", CHECKPOINT], REFERENCE)
    out["launches"]["score_kernel"] = vggq_counts["score_kernel"]
    if masked_report(os.path.join(vggq_dir, "analysis_results.txt")) != masked_report(REFERENCE):
        raise AssertionError("the report's lines differ from the committed report's")
    for f in ("keypoints.csv", "pnp_results.csv"):
        if csv_layout(os.path.join(vggq_dir, f)) != csv_layout(os.path.join(REFERENCE_DIR, f)):
            raise AssertionError(f"{f}: header or row names differ from the committed file's")
    agreement = keypoint_agreement(os.path.join(vggq_dir, "keypoints.csv"),
                                   os.path.join(REFERENCE_DIR, "keypoints.csv"))
    progress("evaluation_cli_layout", report="the committed report's lines, paths and numbers masked",
             csv="the committed headers and row names", keypoints_vs_committed=agreement)
    _, vggf_result, vggf_eval_s, _ = evaluate_cli("vgg-F r5 bf16", ["-i", VGGF_CHECKPOINT],
                                                  VGGF_REFERENCE, outframe_tol=2, min_pnp=57)
    ptq_dir, _, _, ptq_counts = evaluate_cli(
        "vgg-Q r4 PTQ", ["-i", R4_CHECKPOINT, "--int8-calibration-frames", str(CALIBRATION_FRAMES)],
        INT8_REFERENCES["ptq_r4"])
    if ptq_counts["conv_int8_kernel"] != 19 * (HOLDOUT_FRAMES // 16):
        raise AssertionError(f"the PTQ run launched the conv kernel {ptq_counts['conv_int8_kernel']} "
                             "times, not 19 a batch")
    out["launches"]["conv_int8_kernel"] = ptq_counts["conv_int8_kernel"]
    modes = {"ransac": ["--ransac"],
             "weighted+reject10": ["--pnp-weight-by-score", "--pnp-reject-outliers-px", "10"],
             "soft+reject5": ["--pnp-soft-detections", "--pnp-reject-outliers-px", "5"]}
    robust = {}
    for mode, flags in modes.items():
        out_dir = os.path.join(tmp, "eval_" + mode.replace("+", "_"))
        args = eval_cli.make_parser().parse_args(
            ["-i", CHECKPOINT, "-d", hold, "-o", out_dir, "--no-visualization", "-b", "16"] + flags)
        (kp, pnp), _, seconds, _ = timed(eval_cli.network_inference_dataset, args)
        robust[mode] = {"pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
                        "add_auc": pnp["add_auc"], "add_mean": pnp["add_mean"],
                        "pck_auc": kp["l2_error_auc"], "seconds": seconds}
        if pnp["num_pnp_found"] < plain["pnp"]["num_pnp_found"] or not 0.0 <= pnp["add_auc"] <= 1.0:
            raise AssertionError(f"{mode}: PnP {pnp['num_pnp_found']} (plain "
                                 f"{plain['pnp']['num_pnp_found']}), ADD AUC {pnp['add_auc']}")
    progress("evaluation_cli_pnp_modes", plain={"pnp_success": [plain["pnp"]["num_pnp_found"],
                                                              plain["pnp"]["num_pnp_possible"]],
                                                "add_auc": plain["pnp"]["add_auc"], "seconds": plain_s},
             modes=robust)

    # 19. The training CLI on the card: vgg-Q with the r5 recipe, then a
    # resume; vgg-F from the r5 vgg-Q encoder; a QAT epoch.
    def train(argv):
        return timed(train_cli.train_network, train_cli.make_parser().parse_args(argv))

    vggq_out = os.path.join(tmp, "train_vggq")
    argv = (["-i", train_set, "-m", PANDA, "-ar", VGGQ_ARCH, "-o", vggq_out, "--loss-pos-weight", "50",
             "--ema-decay", "0.999"] + R5_TRAIN_FLAGS)
    steps_per_epoch = int(round(TRAIN_SET_FRAMES * 0.8)) // TRAIN_BATCH
    _, first_text, first_s, first_counts = train(argv + ["-e", "2"])
    files = set(os.listdir(vggq_out))
    layout = {"epoch_2.yaml", "epoch_2.msgpack", "epoch_2.opt.msgpack", "epoch_2.ema.msgpack",
              "best_network.yaml", "best_network.msgpack", "best_network_ema.yaml",
              "best_network_ema.msgpack", "training_log.pkl"}
    if not layout <= files or "epoch_1.msgpack" in files:
        raise AssertionError(f"checkpoint layout after two epochs: {sorted(files)}")
    trainer, resume_text, resume_s, resume_counts = train(argv + ["-e", "3", "-r"])
    scanned = [SCANNED_LINE in text for text in (first_text, resume_text)]
    if not all(scanned):
        raise AssertionError(f"--cache-device on one rank did not take the scanned path: {scanned}")
    peaks = [float(v) for v in re.findall(r"Peak device memory: ([\d.]+) GiB", first_text + resume_text)]
    out["launches"]["warp_kernel"] = first_counts["warp_kernel"]
    if (first_counts["warp_kernel"] != 2 * steps_per_epoch
            or resume_counts["warp_kernel"] != steps_per_epoch):
        raise AssertionError(f"warp launches {first_counts['warp_kernel']} and "
                             f"{resume_counts['warp_kernel']}, not one a step ({steps_per_epoch} an epoch)")
    with open(os.path.join(vggq_out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    losses = [x for epoch in log["batch_training_losses"] for x in epoch]
    if log["epochs"] != [1, 2, 3] or log["epochs_resumed"] != [3] or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training log: epochs {log['epochs']}, resumed "
                             f"{log.get('epochs_resumed')}, losses {losses}")
    opt = load_flax_checkpoint(os.path.join(vggq_out, "epoch_3.opt.msgpack"))
    count = int(opt["1"]["0"]["count"])
    if count != 3 * steps_per_epoch or trainer.steps != count:
        raise AssertionError(f"optimizer count {count}, steps {trainer.steps}, expected {3 * steps_per_epoch}")
    (kp, _), _, _, _ = timed(eval_cli.network_inference_dataset, eval_cli.make_parser().parse_args(
        ["-i", os.path.join(vggq_out, "best_network.msgpack"), "-d", hold, "-o",
         os.path.join(tmp, "eval_trained"), "--no-visualization", "-b", "16"]))
    # Epoch seconds from the log (timestamps count from each run's start,
    # so the first and the resumed epoch include the run's set-up).
    ts = log["timestamps"]
    epoch_s = [ts[0], ts[1] - ts[0], ts[2]]
    # The epoch checkpoint's two halves: the host snapshot, then the files.
    t0 = time.perf_counter()
    snapshot = (copy.deepcopy(trainer.network_config), state_to_flax(trainer.model.state_dict()),
                trainer.optimizer_state(), None, state_to_flax(trainer.ema_variables()))
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_cli._write_checkpoint(tmp, "timed", *snapshot)
    write_files_s = time.perf_counter() - t0
    progress("training_cli", arch="vgg-Q", flags=R5_TRAIN_FLAGS, seconds=[first_s, resume_s],
             launches=[first_counts, resume_counts], epochs=log["epochs"],
             epochs_resumed=log["epochs_resumed"], optimizer_count=count, losses=log["losses"],
             scanned_epochs=SCANNED_LINE, peak_device_gib_by_epoch=peaks,
             validation_losses=log["validation_losses"], layout=sorted(files),
             best_network_evaluated={"inframe_found": kp["num_found_gt_inframe"]})
    del trainer

    vggf_out = os.path.join(tmp, "train_vggf")
    _, text, vggf_s, vggf_counts = train(
        ["-i", train_set, "-m", PANDA, "-ar", VGGF_ARCH, "-o", vggf_out, "-e", "1",
         "--loss-pos-weight", "800", "--init-encoder", CHECKPOINT] + R5_TRAIN_FLAGS)
    grafted = re.search(r"\((\d+) leaves grafted, (\d+) shape-skipped\)", text)
    if (grafted is None or int(grafted.group(1)) == 0 or vggf_counts["warp_kernel"] != steps_per_epoch
            or SCANNED_LINE not in text):
        raise AssertionError(f"vgg-F: graft {grafted and grafted.group(0)}, launches {vggf_counts}")
    qat_out = os.path.join(tmp, "train_qat")
    qat, qat_text, qat_s, qat_counts = train(
        ["-i", train_set, "-m", PANDA, "-ar", VGGQ_ARCH, "-o", qat_out, "-e", "1", "--quant-mode", "qat",
         "--init-params", R4_CHECKPOINT, "--loss-pos-weight", "50"] + R5_TRAIN_FLAGS + ["-lr", "5e-5"])
    with open(os.path.join(qat_out, "training_log.pkl"), "rb") as f:
        qat_losses = pickle.load(f)["batch_training_losses"][0]
    if qat.quant_mode != "qat" or qat_counts["warp_kernel"] != steps_per_epoch or not np.all(
            np.isfinite(qat_losses)) or SCANNED_LINE not in qat_text:
        raise AssertionError(f"QAT: mode {qat.quant_mode}, launches {qat_counts}, losses {qat_losses}")
    progress("training_cli_graft_qat", vggf={"n_grafted": int(grafted.group(1)),
                                              "n_skipped": int(grafted.group(2)), "seconds": vggf_s,
                                              "launches": vggf_counts},
             qat={"seconds": qat_s, "launches": qat_counts, "losses": qat_losses})
    del qat

    # 20. Timings: the evaluation CLI's stages, each PnP mode over the 64
    # frames, the training CLI's epochs and its checkpoint writes.
    network = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    raw_res = (640, 480)
    netin, netout = network.net_resolutions_from_image_raw_resolution(raw_res)
    process = make_batch_processor(raw_res, netin, netout, network.image_preprocessing(),
                                   network.image_normalization, include_belief_maps=False)
    kp_to_raw = coord_ops.affine_raw_from_netin(netin, raw_res, network.image_preprocessing()).compose(
        coord_ops.affine_netin_from_netout(netout, netin))
    stages = dict.fromkeys(("decode", "preprocess", "model", "peak_decode"), 0.0)
    detected, scores, best = [], [], []

    def clock(stage, t0):
        torch.cuda.synchronize()
        stages[stage] += time.perf_counter() - t0
        return time.perf_counter()

    for start in range(0, HOLDOUT_FRAMES, 16):
        t0 = time.perf_counter()
        batch = disk.host_batch(list(range(start, start + 16)))
        t0 = clock("decode", t0)
        x = process(None, torch.from_numpy(batch["image_rgb_raw"]).cuda(),
                    torch.from_numpy(batch["keypoint_projections_raw"]).cuda())["image_rgb_input"]
        t0 = clock("preprocess", t0)
        with torch.no_grad():
            belief = network._belief_maps(x)
        t0 = clock("model", t0)
        kp_netout, peaks = network._keypoints(belief)
        detected.append(kp_to_raw(kp_netout))
        scores.append(peaks["scores"][..., 0])
        best.append(kp_to_raw(peaks["coords"][..., 0, :]))
        clock("peak_decode", t0)
    positions = torch.from_numpy(disk.kp_positions).cuda()
    K = holdout["camera_K"]
    n_inframe = analysis._inframe_counts(disk.kp_projs_raw.astype(float), raw_res)
    detected, soft = torch.cat(detected), torch.cat(best)
    scores = torch.cat(scores).cpu().numpy()
    weighted = torch.from_numpy(analysis._pnp_weights(scores, True, False, 0.05)).cuda()
    soft_w = torch.from_numpy(analysis._pnp_weights(scores, False, True, 0.05)).cuda()
    pnp_cases = {
        "plain": dict(pnp_input_raw=detected),
        "ransac": dict(pnp_input_raw=detected, ransac=True),
        "weighted+reject10": dict(pnp_input_raw=detected, weights=weighted, reject_outliers_px=10.0),
        "soft+reject5": dict(pnp_input_raw=soft, weights=soft_w, reject_outliers_px=5.0,
                             detect_mask=(soft[..., 0] > -999.0) & (soft_w > 0)),
    }
    pnp_s = {}
    for mode, kwargs in pnp_cases.items():
        pnp_s[mode] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            analysis._pnp_and_add(positions, camera_K=K, n_inframe=n_inframe, **kwargs)
            torch.cuda.synchronize()
            pnp_s[mode].append(time.perf_counter() - t0)
    gt = {"projections": holdout["projections"], "positions": holdout["positions"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    analysis.evaluate_frames(network, holdout["images"], gt, K, batch_size=16)
    torch.cuda.synchronize()
    in_memory_s = time.perf_counter() - t0
    images_per_epoch = steps_per_epoch * TRAIN_BATCH
    out["timings"].update({
        "eval_cli_frames_per_s": HOLDOUT_FRAMES / plain_s,
        "eval_in_memory_frames_per_s": HOLDOUT_FRAMES / in_memory_s,
        "eval_stages_s": {**stages, "pnp": pnp_s["plain"][-1]},
        "pnp_modes_s_64_frames": pnp_s,
        "train_cli_epoch_s": epoch_s,
        "train_cli_images_per_s": [images_per_epoch / s for s in epoch_s],
        "train_cli_epoch_note": "epochs 1 and 3 (resumed) include set-up; each includes validation",
        "checkpoint_snapshot_s": snapshot_s,
        "checkpoint_write_files_s": write_files_s,
        "dtype": dtype_name(network.compute_dtype),
    })
    progress("workflow_timings", **out["timings"])
    # What the serving phases read; the caller removes the directory.
    out["work"] = {"tmp_dir": tmp_dir, "hold": hold, "disk": disk, "vggq_dir": vggq_dir,
                   "vggq_pnp": plain["pnp"], "ptq_dir": ptq_dir,
                   "vggf": {"result": vggf_result, "seconds": vggf_eval_s}}
    return out


def http_post(url, path, data):
    with urllib.request.urlopen(urllib.request.Request(url + path, data=data), timeout=300) as resp:
        return json.loads(resp.read())


def http_get(url, path):
    with urllib.request.urlopen(url + path, timeout=300) as resp:
        return json.loads(resp.read())


def start_http(server):
    """``make_http_server`` on a free loopback port, served by a thread."""
    from dream_tpu_torch.serve import make_http_server

    httpd = make_http_server(server, "127.0.0.1", 0)
    return serve_in_thread(httpd)


def serve_in_thread(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_http(httpd):
    httpd.shutdown()
    httpd.server_close()


def record_frames(server):
    """Wrap ``server.process_image`` to keep each frame's status, raw-frame
    detections and, when the frame published one, its pose (the client is
    sequential, so the latest ones are the frame's)."""
    records = []
    process = server.process_image

    def process_and_record(image):
        status = process(image)
        with server._lock:
            detected = server.latest_detection["detected_keypoints"]
            pose = server.latest_pose if status["pnp"] else None
        records.append({"status": status, "detected": detected, "pose": pose})
        return status

    server.process_image = process_and_record
    return records


CLIENT_SUMMARY = re.compile(r"(\d+) frames in ([0-9.]+) s: ([0-9.]+) frames/s; POST /image ms "
                            r"p50 ([0-9.]+) p90 ([0-9.]+) max ([0-9.]+)")


def run_client(url, dataset):
    """The port's client CLI, unthrottled (--rate 1000), as a subprocess over
    every frame of ``dataset``; returns its frame lines and its summary."""
    out = subprocess.run(
        [sys.executable, "-m", "dream_tpu_torch.cli.dream_client_example", "--server", url,
         "--dataset", dataset, "--rate", "1000"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        sys.stdout.write(out.stdout[-3000:] + out.stderr[-3000:])
        raise AssertionError(f"the client exited with {out.returncode}")
    lines = [line for line in out.stdout.splitlines() if re.match(r"^\d+: (detected|no pose)", line)]
    m = CLIENT_SUMMARY.search(out.stdout)
    if m is None:
        raise AssertionError("the client printed no summary line:\n" + out.stdout[-2000:])
    summary = dict(zip(("frames", "seconds", "frames_per_s", "image_ms_p50", "image_ms_p90",
                        "image_ms_max"), (float(v) for v in m.groups())))
    return lines, summary


def published_add_auc(records, positions, gt_projections, raw_res):
    """ADD AUC of the poses a server published, frame by frame: the client
    posts camera-frame keypoints, so each frame's true camera_from_robot
    pose is the identity; ADD averages over the keypoints PnP was fed (the
    found ones), and a frame without a pose counts as a failure, as in
    ``analysis._pnp_and_add``."""
    from dream_tpu_torch import analysis
    from dream_tpu_torch.ops import geometric_vision as gv

    adds = np.full(len(records), -999.99)
    for i, record in enumerate(records):
        if record["pose"] is None:
            continue
        pose = record["pose"]["camera_from_robot"]
        found = torch.from_numpy((record["detected"][:, 0] > -999.0).astype(np.float32))[None]
        adds[i] = float(gv.add_from_pose(torch.tensor([pose["translation"]], dtype=torch.float32),
                                         torch.tensor([pose["quaternion_xyzw"]], dtype=torch.float32),
                                         torch.from_numpy(positions[i : i + 1]), found)[0])
    n_inframe = analysis._inframe_counts(gt_projections.astype(float), raw_res)
    return analysis.pnp_metrics(adds, n_inframe)


def latency_summary(ms):
    return {"p50": float(np.percentile(ms, 50)), "p90": float(np.percentile(ms, 90)),
            "max": float(np.max(ms)), "n": len(ms)}


def compare_chain_links(chain, net_in, dtype):
    """The int8 chain on ``net_in`` with every link's conv held bit for bit
    against its plain version at the link's own input (compare_conv_int8
    raises on a difference); then the whole chain's maps on the kernels
    against the exact plain route's.  Returns the largest difference (0)."""
    from dream_tpu_torch.models import vgg_int8_deploy

    kernel_conv = vgg_int8_deploy.conv3x3_int8_ohwi
    vgg_int8_deploy.conv3x3_int8_ohwi = lambda x_q, w_q, k, b, relu: compare_conv_int8(
        x_q, w_q, k, b, relu)[0]
    try:
        checked = vgg_int8_deploy.run_int8_chain(chain, net_in, dtype, backend="auto")
    finally:
        vgg_int8_deploy.conv3x3_int8_ohwi = kernel_conv
    plain = vgg_int8_deploy.run_int8_chain(chain, net_in, dtype, backend="plain")
    diff = float((checked - plain).abs().max())
    if diff != 0.0:
        raise AssertionError(f"the int8 chain's maps on the kernel differ from the plain route's by {diff}")
    return diff


def serving_phases(kernels_of_port, reset_counts, smi, work):
    """Phases 21-24: the pose server at full width on the phase-17 holdout,
    live in bf16 and with online int8, the torch.export artifacts and the
    server on them, and their timings.  Returns the serving runs' kernel
    launches."""
    from dream_tpu_torch.cli import export_inference as export_cli
    from dream_tpu_torch.cli import serve_dream as serve_cli
    from dream_tpu_torch.data.dataset import collect_calibration_batches, make_batch_processor
    from dream_tpu_torch.export import load_inference
    from dream_tpu_torch.models.quant import calibrate
    from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes
    from dream_tpu_torch.network import create_network_from_config_file
    from dream_tpu_torch.ops import geometric_vision as gv
    from dream_tpu_torch.serve import DreamInferenceServer
    from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, load_camera_intrinsics
    from dream_tpu_torch.utils.png import decode_png

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    hold, disk, tmp = work["hold"], work["disk"], work["tmp_dir"].name
    raw_res = (640, 480)
    found_data, found_configs = find_ndds_data_in_dir(hold)
    K = load_camera_intrinsics(found_configs["camera"])
    camera_info = json.dumps({"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}).encode()
    pngs = []
    for datum in found_data:
        with open(datum["image_paths"]["rgb"], "rb") as f:
            pngs.append(f.read())
    positions = disk.kp_positions  # float32 [64, 7, 3], camera frame

    def request(url, i):
        """One frame as the client sends it: keypoints, then the image; returns
        the /image JSON and its ms."""
        http_post(url, "/keypoint_positions", json.dumps(positions[i].tolist()).encode())
        t0 = time.perf_counter()
        result = http_post(url, "/image", pngs[i])
        return result, (time.perf_counter() - t0) * 1e3

    out = {"launches": {}, "timings": {"card": smi}}

    # 21. Serving, live: vgg-Q r5 in its sidecar's bf16, single-frame mode.
    net = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    if net.compute_dtype != torch.bfloat16:
        raise AssertionError("the r5 sidecar's bfloat16 did not reach the served network")
    server = DreamInferenceServer(net, base_frame="panda_link0")
    httpd, url = start_http(server)
    http_post(url, "/camera_info", camera_info)
    # The first request on a frame the evaluation CLI found 4 keypoints or
    # more in, so that it solves PnP too.
    cli_detected = csv_detections(os.path.join(work["vggq_dir"], "keypoints.csv"))
    first = int(np.argmax((cli_detected[..., 0] > -999.0).sum(-1) >= 4))
    first_result, first_ms = request(url, first)
    for i in range(2):  # with the first, 3 warm-up requests before the timed ones
        request(url, i)
    records = record_frames(server)
    reset_counts()
    lines, client = run_client(url, hold)
    counts = launches()
    failures = []
    if len(records) != HOLDOUT_FRAMES or len(lines) != HOLDOUT_FRAMES:
        failures.append(f"{len(records)} frames served and {len(lines)} client lines, not {HOLDOUT_FRAMES}")
    if counts["score_kernel"] != HOLDOUT_FRAMES or counts["conv_int8_kernel"] != 0:
        failures.append(f"launches {counts}: not the score kernel once a request")
    detected = np.stack([r["detected"] for r in records])
    vs_cli = detection_agreement(detected, cli_detected)
    if vs_cli["same_found_state"] < 445 or vs_cli["median_px"] > 0.05:
        failures.append(f"detections against the evaluation CLI's: {vs_cli}")
    published = sum(bool(r["status"]["pnp"]) for r in records)
    if abs(published - work["vggq_pnp"]["num_pnp_found"]) > 1:
        failures.append(f"{published} poses published, the evaluation CLI solved "
                        f"{work['vggq_pnp']['num_pnp_found']}")
    pnp = published_add_auc(records, positions, disk.kp_projs_raw, raw_res)
    if abs(pnp["add_auc"] - work["vggq_pnp"]["add_auc"]) > 0.01:
        failures.append(f"ADD AUC {pnp['add_auc']} of the published poses not within 0.01 of "
                        f"{work['vggq_pnp']['add_auc']}")
    # The score kernel against its plain version at a request's shapes: a
    # served frame's [7, 100, 100] maps, and random ones (compare_kernel
    # raises on any difference in peaks or masks).
    with torch.no_grad():
        served_maps = net._belief_maps(net.preprocess(torch.from_numpy(decode_png(pngs[first]))[None]))[0]
    request_shapes = {"served frame 7x100x100": compare_kernel(served_maps.contiguous()),
                      "random 7x100x100": compare_kernel(random_maps(np.random.RandomState(21), 7, 100, 100))}
    out["max_abs_err"] = {"score_kernel": max(err for err, _ in request_shapes.values())}
    progress("serving_live", checkpoint="vgg-Q r5", compute_dtype="bfloat16", requests=len(records),
             score_kernel_vs_plain_at_request_shapes={k: {"max_abs_err": e, "peaks": p}
                                                      for k, (e, p) in request_shapes.items()},
             launches=counts, detections_vs_evaluation_cli=vs_cli, poses_published=published,
             evaluation_cli_pnp=[work["vggq_pnp"]["num_pnp_found"], work["vggq_pnp"]["num_pnp_possible"]],
             add_auc=pnp["add_auc"], evaluation_cli_add_auc=work["vggq_pnp"]["add_auc"],
             add_mean=pnp["add_mean"], client=client,
             first_request={"frame": first, "ms": first_ms, "pnp": first_result["pnp"]})
    if failures:
        raise AssertionError("serving, live: " + "; ".join(failures))
    out["launches"]["score_kernel"] = counts["score_kernel"]

    # Multi-frame: every fourth of 16 frames captured into the buffer.
    multi = DreamInferenceServer(net, base_frame="panda_link0", single_frame_mode=False)
    multi_httpd, multi_url = start_http(multi)
    http_post(multi_url, "/camera_info", camera_info)
    expected, captured = 0, []
    for i in range(16):
        if i % 4 == 0:
            http_post(multi_url, "/capture_frame", b"")
        result, _ = request(multi_url, i)
        if i % 4 == 0:
            captured.append([result["n_detected"], result["pnp"]])
            expected += result["n_detected"] if result["pnp"] else 0
        elif result["pnp"]:
            raise AssertionError(f"frame {i} was not captured but solved in multi-frame mode")
    status, pose = http_get(multi_url, "/status"), http_get(multi_url, "/pose")
    cleared = (http_post(multi_url, "/clear_buffer", b""), http_get(multi_url, "/status"))
    stop_http(multi_httpd)
    progress("serving_multi_frame", captured_n_detected_and_pnp=captured, buffer_size=status["buffer_size"],
             expected_buffer_size=expected, pose_published=pose["ok"],
             n_correspondences=pose.get("n_correspondences"), buffer_after_clear=cleared[1]["buffer_size"])
    if (status["buffer_size"] != expected or expected == 0 or not pose["ok"]
            or pose["n_correspondences"] != expected or cleared[1]["buffer_size"] != 0):
        raise AssertionError("multi-frame buffer: " + json.dumps([status, pose, cleared[1]]))

    # 22. Serving with online int8: r4, calibrated on its first 32 frames.
    r4 = create_network_from_config_file(R4_CONFIG, R4_CHECKPOINT, device="cuda")
    server8 = DreamInferenceServer(r4, base_frame="panda_link0", int8_calibration_frames=CALIBRATION_FRAMES)
    served_qvars = {}
    enable = r4.enable_int8_inference

    def enable_and_keep(batches):
        served_qvars.update(enable(batches))
        return served_qvars

    r4.enable_int8_inference = enable_and_keep
    records8 = record_frames(server8)
    httpd8, url8 = start_http(server8)
    http_post(url8, "/camera_info", camera_info)
    before = http_get(url8, "/status")["int8"]
    reset_counts()
    int8_status, int8_ms = [], []
    for i in range(HOLDOUT_FRAMES):
        int8_ms.append(request(url8, i)[1])
        int8_status.append(http_get(url8, "/status")["int8"])
    counts8 = launches()
    # Phase 18's PTQ run calibrated on the same 32 frames in batches of 16.
    process = make_batch_processor(raw_res, r4.trained_net_input_resolution(),
                                   r4.trained_net_output_resolution(), r4.image_preprocessing(),
                                   r4.image_normalization, include_belief_maps=False)
    batches = collect_calibration_batches(
        disk.load_images(range(CALIBRATION_FRAMES)),
        lambda g, images, kp: process(g, images.cuda(), kp.cuda()), CALIBRATION_FRAMES, 16)
    cli_qvars = calibrate(copy.deepcopy(r4.model), [b.permute(0, 3, 1, 2) for b in batches])
    amax = {k: [float(served_qvars[k]), float(cli_qvars[k])] for k in sorted(cli_qvars)}
    amax_rel = max(abs(a / b - 1.0) for a, b in amax.values())
    ptq_detected = csv_detections(os.path.join(work["ptq_dir"], "keypoints.csv"))
    vs_ptq = detection_agreement(np.stack([r["detected"] for r in records8])[CALIBRATION_FRAMES:],
                                 ptq_detected[CALIBRATION_FRAMES:])
    # The conv kernel against its plain version at a request's shapes
    # (B=1): every link of the served chain on frame 33, at the link's own
    # input, and random operands over the whole int8 range; both raise on
    # any difference.
    x33 = r4.preprocess(torch.from_numpy(decode_png(pngs[CALIBRATION_FRAMES]))[None])
    chain_diff = compare_chain_links(r4.int8_chain, x33.float(), r4.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(22)
    for b, h, w, ci, co, relu in chain_shapes(1):
        compare_conv_int8(*int8_case(gen, b, h, w, ci, co), relu)
    out["max_abs_err"]["conv_int8_kernel"] = chain_diff
    progress("serving_online_int8", checkpoint="vgg-Q r4", status_before=before,
             status_after_each_frame=int8_status, launches=counts8,
             request_ms_frames_33_64=latency_summary(int8_ms[CALIBRATION_FRAMES:]),
             amax_served_vs_evaluation_cli=amax, amax_max_rel_diff=amax_rel,
             conv_kernel_vs_plain_b1={"chain_links_frame_33": chain_diff, "random_links": 0},
             detections_frames_33_64_vs_ptq_cli=vs_ptq)
    failures = []
    want_status = ["calibrating"] * (CALIBRATION_FRAMES - 1) + ["active"] * (HOLDOUT_FRAMES - CALIBRATION_FRAMES + 1)
    if before != "calibrating" or int8_status != want_status:
        failures.append("the int8 status did not read calibrating through frame 31 and active from frame 32 on")
    if counts8["conv_int8_kernel"] != 19 * CALIBRATION_FRAMES or counts8["score_kernel"] != HOLDOUT_FRAMES:
        failures.append(f"launches {counts8}: not 19 conv launches on each of the {CALIBRATION_FRAMES} int8 frames")
    if set(amax) != set(served_qvars) or not amax_rel <= 1e-2:
        failures.append(f"amax differs from the evaluation CLI's calibration by {amax_rel} relative")
    if vs_ptq["same_found_state_share"] < 0.98:
        failures.append(f"frames 33-64 against the PTQ CLI run: {vs_ptq}")
    if failures:
        raise AssertionError("serving with online int8: " + "; ".join(failures))
    out["launches"]["score_kernel"] += counts8["score_kernel"]
    out["launches"]["conv_int8_kernel"] = counts8["conv_int8_kernel"]

    # 23. Export: vgg-Q r5 in bf16 and r4 PTQ, batch 1, 640x480, on the card.
    artifacts, export_s, export_text = {}, {}, {}
    for name, argv in (("vgg-Q r5", ["-i", CHECKPOINT]),
                       ("vgg-Q r4 PTQ", ["-i", R4_CHECKPOINT, "--int8-calibration-dir", hold,
                                         "--int8-calibration-frames", str(CALIBRATION_FRAMES)])):
        path = os.path.join(tmp, re.sub(r"\W+", "_", name) + ".pt2")
        args = export_cli.make_parser().parse_args(
            argv + ["-o", path, "-b", "1", "--raw-resolution", "640x480", "--device", "cuda", "--self-test"])
        t0 = time.perf_counter()
        (_, data), text = quiet(export_cli.export_inference_cli, args)
        export_s[name] = time.perf_counter() - t0
        if "self-test OK" not in text:
            raise AssertionError(f"{name}: the export CLI's self-test did not pass:\n{text[-2000:]}")
        m = re.search(r"exported in ([0-9.]+) s", text)
        export_text[name] = {"export_s": float(m.group(1)), "self_test": re.search(
            r"self-test on .*", text).group(0)}
        artifacts[name] = (path, data)
    frame_path = os.path.join(tmp, "frame0.npy")
    np.save(frame_path, disk.load_images([0]))
    torch_only = {}
    for name, (path, data) in artifacts.items():
        script = (
            "import json, sys\n"
            "import numpy as np\n"
            "import torch\n"
            f"program = torch.export.load({path!r})\n"
            "with torch.no_grad():\n"
            f"    _, kps = program.module()(torch.from_numpy(np.load({frame_path!r})).cuda())\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('dream_tpu_torch', 'dream_tpu', 'jax'))\n"
            "print(json.dumps({'modules': bad, 'keypoints': kps.cpu().tolist()}))\n")
        ran = subprocess.run([sys.executable, "-c", script], cwd=tmp, capture_output=True, text=True,
                             timeout=300, env={**os.environ, "PYTHONPATH": ""})
        if ran.returncode != 0:
            raise AssertionError(f"{name}: the torch-only load failed:\n{ran.stderr[-3000:]}")
        loaded = json.loads(ran.stdout.strip().splitlines()[-1])
        with torch.no_grad():
            here = load_inference(data)(torch.from_numpy(np.load(frame_path)).cuda())[1].cpu().numpy()
        torch_only[name] = {"modules_of_the_package": loaded["modules"],
                            "keypoints_equal_in_process": bool(np.array_equal(np.asarray(loaded["keypoints"]), here))}
        if loaded["modules"] or not torch_only[name]["keypoints_equal_in_process"]:
            raise AssertionError(f"{name}: torch-only load {torch_only[name]}")
    serve_args = serve_cli.make_parser().parse_args(
        ["--artifact", artifacts["vgg-Q r5"][0], "-b", "panda_link0", "-p", "0", "--device", "cuda"])
    server_a, httpd_a = serve_cli.build_server(serve_args)
    httpd_a, url_a = serve_in_thread(httpd_a)
    http_post(url_a, "/camera_info", camera_info)
    for i in range(3):  # warm-up requests
        request(url_a, i)
    records_a = record_frames(server_a)
    call8 = load_inference(artifacts["vgg-Q r4 PTQ"][1])
    reset_counts()
    # The int8 artifact over the 64 frames at batch 1, against the PTQ
    # CLI's int8 detections (phase 18, the same 32 calibration frames in
    # batches of 16).
    with torch.no_grad():
        detected8 = np.stack([call8(torch.from_numpy(decode_png(png))[None].cuda())[1][0].cpu().numpy()
                              for png in pngs])
    lines_a, client_a = run_client(url_a, hold)
    counts_a = launches()
    vs_live = detection_agreement(np.stack([r["detected"] for r in records_a]), detected)
    int8_vs_ptq = detection_agreement(detected8, ptq_detected)
    sizes = {name: os.path.getsize(path) for name, (path, _) in artifacts.items()}
    progress("export", artifacts={n: os.path.basename(p) for n, (p, _) in artifacts.items()},
             cli=export_text, torch_only_subprocess=torch_only, bytes=sizes,
             served_artifact_requests=len(records_a), launches_during_artifact_calls=counts_a,
             detections_vs_live_bf16=vs_live, int8_artifact_vs_ptq_cli=int8_vs_ptq, client=client_a)
    if len(records_a) != HOLDOUT_FRAMES or len(lines_a) != HOLDOUT_FRAMES:
        raise AssertionError(f"the artifact server answered {len(records_a)} frames")
    if any(counts_a.values()):
        raise AssertionError(f"kernels launched during artifact calls: {counts_a}")
    if vs_live["same_found_state"] < 445 or vs_live["median_px"] > 0.05:
        raise AssertionError(f"artifact detections against the live server's: {vs_live}")
    if int8_vs_ptq["same_found_state"] < 445 or int8_vs_ptq["median_px"] > 0.05:
        raise AssertionError(f"int8 artifact detections against the PTQ CLI's: {int8_vs_ptq}")

    # 24. Timings: request latencies from the client runs (after 3 warm-up
    # requests) and from phase 22's int8 requests once int8 was active;
    # a request's stages in-process, the remainder being HTTP and the
    # server's own work.
    client_ms = ("image_ms_p50", "image_ms_p90", "image_ms_max")
    request_ms = {"live bf16": dict(zip(("p50", "p90", "max"), (client[k] for k in client_ms)), n=64),
                  "live int8": latency_summary(int8_ms[CALIBRATION_FRAMES:]),
                  "artifact": dict(zip(("p50", "p90", "max"), (client_a[k] for k in client_ms)), n=64)}
    stages = {k: [] for k in ("png_decode", "preprocess", "model", "peak_decode", "pnp")}
    K_t = torch.as_tensor(K[None], dtype=torch.float32, device="cuda")

    def lap(stage, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage].append((now - t0) * 1e3)
        return now

    with torch.no_grad():
        for i in range(11):
            t0 = time.perf_counter()
            image = decode_png(pngs[i])
            t0 = lap("png_decode", t0)
            x = net.preprocess(torch.from_numpy(image)[None])
            t0 = lap("preprocess", t0)
            belief = net._belief_maps(x)
            t0 = lap("model", t0)
            kp_netout, _ = net._keypoints(belief)
            kp = kp_netout.cpu()
            t0 = lap("peak_decode", t0)
            found = (kp[0, :, 0] > -999.0).numpy()
            det = records[i]["detected"][found]
            gv.solve_pnp(torch.as_tensor(positions[i][found][None], device="cuda"),
                         torch.as_tensor(det[None], dtype=torch.float32, device="cuda"), K_t)
            lap("pnp", t0)
    stage_ms = {k: float(np.median(v[3:])) for k, v in stages.items()}
    stage_ms["http_and_rest"] = request_ms["live bf16"]["p50"] - sum(stage_ms.values())
    x1 = torch.from_numpy(disk.load_images([0])).cuda()
    artifact_ms = {}
    with torch.no_grad():
        for name, (_, data) in artifacts.items():
            call = load_inference(data)
            artifact_ms[name] = cuda_ms(lambda: call(x1), 5, warmup=2)
        live_model_ms = cuda_ms(lambda: net._belief_maps(net.preprocess(x1)), 5, warmup=2)
    out["timings"].update({
        "request_ms": request_ms, "first_request_ms": first_ms, "first_request_pnp": first_result["pnp"],
        "stages_ms_median_of_8": stage_ms,
        "client_frames_per_s": {"live bf16": client["frames_per_s"], "artifact": client_a["frames_per_s"]},
        "export_s": export_text, "export_cli_s_with_self_test": export_s, "artifact_bytes": sizes,
        "artifact_ms_a_frame_b1": artifact_ms, "live_preprocess_and_model_ms_b1": live_model_ms,
    })
    progress("serving_timings", **out["timings"])
    stop_http(httpd8)
    del r4, server8
    torch.cuda.empty_cache()
    # Phase 30 reads the debug streams of the live bf16 server (after phase
    # 21's frames) and of the artifact server, then stops both.
    out["live"] = {"server": server, "httpd": httpd, "url": url, "artifact_httpd": httpd_a,
                   "artifact_url": url_a, "camera_info": camera_info, "pngs": pngs,
                   "positions": positions, "first": first}
    return out


def quant_conv_shapes(model, x_shape):
    """Each distinct quantizable conv of ``model`` in a forward over an
    input of ``x_shape``, on the meta device: ``{(kind, input shape, weight
    shape, stride, padding, output_padding): times it runs}``."""
    from dream_tpu_torch.models.quant import QuantConvTranspose2d, quant_convs

    seen = {}

    def record(module, args):
        kind = "transposed" if isinstance(module, QuantConvTranspose2d) else "conv"
        key = (kind, tuple(args[0].shape), tuple(module.weight.shape), module.stride[0],
               module.padding[0], module.output_padding[0] if kind == "transposed" else 0)
        seen[key] = seen.get(key, 0) + 1

    hooks = [conv.register_forward_pre_hook(record) for conv in quant_convs(model).values()]
    with torch.no_grad():
        model(torch.empty(x_shape, device="meta"))
    for hook in hooks:
        hook.remove()
    return seen


def zoo_graphs():
    """The quantized graphs of phases 25-29 on the meta device: vgg-F's
    hourglass and the ResNets' deploy graphs, in int8 mode."""
    from dream_tpu_torch.models import DreamHourglass, ResnetSimpleDeploy

    with torch.device("meta"):
        return {"vgg-F": DreamHourglass(7, deconv_decoder=True, quant_mode="int8"),
                "resnet-H": ResnetSimpleDeploy(7, full=False, mode="int8"),
                "resnet-F": ResnetSimpleDeploy(7, full=True, mode="int8")}


def route_operands(gen, key):
    x_shape, w_shape = key[1:3]
    x_q = torch.randint(-127, 128, x_shape, generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, w_shape, generator=gen, device="cuda", dtype=torch.int8)
    return x_q, w_q


def route_fns(key):
    """(the exact route, its plain version) for one conv shape."""
    from dream_tpu_torch.ops import conv_int32

    kind, _, _, stride, pad, out_pad = key
    if kind == "conv":
        return (lambda x, w: conv_int32.conv2d_int32(x, w, stride, pad),
                lambda x, w: conv_int32.conv2d_int32_plain(x, w, stride, pad))
    return (lambda x, w: conv_int32.conv_transpose2d_int32(x, w, stride, pad, out_pad),
            lambda x, w: conv_int32.conv_transpose2d_int32_plain(x, w, stride, pad, out_pad))


def zoo_phases(kernels_of_port, reset_counts, smi, work, gen):
    """Phases 25-29: the int8 graphs of vgg-F and the ResNets (the exact
    int32 route on the card, the evaluation CLI, the ResNets' folded deploy
    graphs, export), the soft-argmax head and DOPE, and their timings.
    Returns the score kernel's launches in phases 26-27."""
    from dream_tpu_torch.cli import export_inference as export_cli
    from dream_tpu_torch.cli import network_inference_dataset as eval_cli
    from dream_tpu_torch.data.dataset import collect_calibration_batches
    from dream_tpu_torch.export import load_inference
    from dream_tpu_torch.models import DopeNetworkBelief, ResnetSimpleDeploy, fold_batchnorm_resnet
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file
    from dream_tpu_torch.ops.spatial_softmax import soft_argmax

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    hold, disk, tmp = work["hold"], work["disk"], work["tmp_dir"].name
    score_launches = 0
    images16 = torch.from_numpy(disk.load_images(range(16))).cuda()
    timings = {"card": smi}

    # 25. The exact route against its plain version, bit for bit, at every
    # distinct conv of vgg-F's int8 graph and of the ResNets' deploy graphs
    # at B=2 (400x400 input), and an odd transposed conv.
    graphs = zoo_graphs()
    keys = {}
    for name, graph in graphs.items():
        for key in quant_conv_shapes(graph, (2, 3, 400, 400)):
            keys.setdefault(key, name)
    keys[("transposed", (3, 24, 13, 11), (24, 16, 3, 3), 2, 1, 1)] = "odd"
    route_err = {}
    for key, name in keys.items():
        x_q, w_q = route_operands(gen, key)
        route, plain = route_fns(key)
        got, want = route(x_q, w_q), plain(x_q, w_q)
        diff = int((got.long() - want.long()).abs().max())
        if got.dtype != torch.int32 or got.shape != want.shape or diff != 0:
            raise AssertionError(f"the exact route differs from its plain version at {key}: {diff}")
        route_err[f"{name} {key[0]} {list(key[1])}x{list(key[2])} s{key[3]} p{key[4]}"] = diff
        del x_q, w_q, got, want
    progress("exact_route_vs_plain", cases=len(route_err), max_abs_err=max(route_err.values()),
             shapes=list(route_err))

    # 26. vgg-F r5 int8 through the evaluation CLI on the phase-17 holdout,
    # against phase 18's bf16 float run of the same checkpoint.
    out_dir = os.path.join(tmp, "eval_vggf_int8")
    args = eval_cli.make_parser().parse_args(
        ["-i", VGGF_CHECKPOINT, "--int8-calibration-frames", str(CALIBRATION_FRAMES), "-d", hold,
         "-o", out_dir, "--no-visualization", "-b", "16", "-w", "8"])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (kp, pnp), _ = quiet(eval_cli.network_inference_dataset, args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launches()
    score_launches += counts["score_kernel"]
    ref_kp, ref_pnp = work["vggf"]["result"]["keypoints"], work["vggf"]["result"]["pnp"]
    measured = {"inframe_found": [kp["num_found_gt_inframe"], kp["num_gt_inframe"]],
                "outframe_found": [kp["num_found_gt_outframe"], kp["num_gt_outframe"]],
                "pck_auc": kp["l2_error_auc"], "pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
                "add_auc": pnp["add_auc"]}
    float_run = {"inframe_found": ref_kp["num_found_gt_inframe"], "pck_auc": ref_kp["l2_error_auc"],
                 "pnp_success": ref_pnp["num_pnp_found"], "add_auc": ref_pnp["add_auc"]}
    failures = []
    if abs(kp["num_found_gt_inframe"] - ref_kp["num_found_gt_inframe"]) > 6:
        failures.append("in-frame found not within 6 of the float run's")
    if abs(kp["l2_error_auc"] - ref_kp["l2_error_auc"]) > 0.02:
        failures.append("PCK AUC not within 0.02 of the float run's")
    if not abs(pnp["add_auc"] - ref_pnp["add_auc"]) <= 0.03:
        failures.append("ADD AUC not within 0.03 of the float run's")
    if pnp["num_pnp_possible"] != 60 or pnp["num_pnp_found"] < 56:
        failures.append(f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']} below 56/60")
    if counts["score_kernel"] != HOLDOUT_FRAMES // 16 or counts["conv_int8_kernel"] != 0:
        failures.append(f"launches {counts}: the score kernel once a batch, the conv kernel never")
    # One batch's int8 maps against the float maps, the CLI's calibration.
    vggf = create_network_from_config_file(VGGF_CONFIG, VGGF_CHECKPOINT, device="cuda")
    x16 = vggf.preprocess(images16)
    float_maps, _ = vggf.inference(x16)
    process = processor_for(vggf, augment=False)
    calib = collect_calibration_batches(
        disk, lambda g, images, kp: process(g, images.cuda(), kp.cuda()), CALIBRATION_FRAMES, 16)
    vggf.enable_int8_inference(calib)
    int8_maps, _ = vggf.inference(x16)
    corr = map_correlation(int8_maps, float_maps)
    if vggf.int8_impl != "quantconv" or not corr >= 0.99:
        failures.append(f"int8 graph {vggf.int8_impl}, maps correlate with float at {corr} (< 0.99)")
    progress("vggf_int8_cli", seconds=cli_s, frames_per_s=HOLDOUT_FRAMES / cli_s,
             float_cli_frames_per_s=HOLDOUT_FRAMES / work["vggf"]["seconds"], launches=counts,
             measured=measured, float_run=float_run, int8_vs_float_map_correlation=corr,
             int8_graph=vggf.int8_impl)
    if failures:
        raise AssertionError("vgg-F int8 through the evaluation CLI: " + "; ".join(failures))
    timings["vggf_cli_frames_per_s"] = {"int8": HOLDOUT_FRAMES / cli_s,
                                        "bf16": HOLDOUT_FRAMES / work["vggf"]["seconds"]}
    nets = {"vgg-F": vggf}

    # 27. ResNet-H and ResNet-F int8 at full width from the port's initial
    # parameters, in bf16, calibrated on the holdout's first 32 frames.
    resnet_out = {}
    for arch, (config, side) in RESNETS.items():
        net = load_network(config, seed=0)
        x = net.preprocess(images16)
        process = processor_for(net, augment=False)
        calib = collect_calibration_batches(
            disk, lambda g, images, kp: process(g, images.cuda(), kp.cuda()), CALIBRATION_FRAMES, 16)
        # The folded graph in float mode against the BatchNorm model, float32.
        state = net.model.state_dict()
        bn32 = DreamNetwork(config_in(config, "float32"), device="cuda")
        bn32.model.load_state_dict(state, strict=True)
        deploy = ResnetSimpleDeploy(7, full=net.model.full).cuda()
        deploy.load_state_dict(fold_batchnorm_resnet(state), strict=True)
        x2 = x[:2].permute(0, 3, 1, 2)
        with torch.no_grad():
            bn_maps, folded_maps = bn32.model.eval()(x2), deploy(x2)
        fold_err = float((bn_maps - folded_maps).abs().max() / bn_maps.abs().max())
        fold_corr = map_correlation(folded_maps, bn_maps)
        del bn32, deploy, bn_maps, folded_maps
        float_maps, _ = net.inference(x)
        net.enable_int8_inference(calib)
        reset_counts()
        int8_maps, keypoints = net.inference(x)
        counts = launches()
        score_launches += counts["score_kernel"]
        corr = map_correlation(int8_maps, float_maps)
        resnet_out[arch] = {"fold_max_err_over_max": fold_err, "fold_correlation": fold_corr,
                            "int8_vs_float_map_correlation": corr, "maps": list(int8_maps.shape),
                            "launches": counts, "int8_graph": net.int8_impl,
                            "keypoints_found": int((keypoints[..., 0] > -999).sum())}
        if not (fold_err <= 1e-3 and fold_corr >= 0.99999):
            raise AssertionError(f"{arch}: the folded graph against the BatchNorm model: {resnet_out[arch]}")
        if (not corr >= 0.98 or tuple(int8_maps.shape) != (16, 7, side, side)
                or counts["score_kernel"] != 1 or counts["conv_int8_kernel"] != 0):
            raise AssertionError(f"{arch} int8: {resnet_out[arch]}")
        nets[arch] = net
        del float_maps, int8_maps
    progress("resnet_int8", card=smi, results=resnet_out)

    # 28. Export of vgg-F r5's quantconv graph (batch 1, 640x480), loaded in
    # a subprocess with torch alone and run over 16 holdout frames, against
    # the live int8 network.
    path = os.path.join(tmp, "vggf_int8.pt2")
    args = export_cli.make_parser().parse_args(
        ["-i", VGGF_CHECKPOINT, "--int8-calibration-dir", hold, "--int8-calibration-frames",
         str(CALIBRATION_FRAMES), "-o", path, "-b", "1", "--raw-resolution", "640x480", "--device", "cuda"])
    t0 = time.perf_counter()
    (live, data), text = quiet(export_cli.export_inference_cli, args)
    export_s = time.perf_counter() - t0
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    frames16 = images16.cpu().numpy()
    frames_path = os.path.join(tmp, "frames16.npy")
    np.save(frames_path, frames16)
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "import torch\n"
        f"call = torch.export.load({path!r}).module()\n"
        f"frames = torch.from_numpy(np.load({frames_path!r})).cuda()\n"
        "with torch.no_grad():\n"
        "    kps = [call(frames[i:i + 1])[1][0].cpu().tolist() for i in range(len(frames))]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('dream_tpu_torch', 'dream_tpu', 'jax'))\n"
        "print(json.dumps({'modules': bad, 'keypoints': kps}))\n")
    ran = subprocess.run([sys.executable, "-c", script], cwd=tmp, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    if ran.returncode != 0:
        raise AssertionError(f"the torch-only load of the int8 vgg-F artifact failed:\n{ran.stderr[-3000:]}")
    loaded = json.loads(ran.stdout.strip().splitlines()[-1])
    artifact_kp = np.asarray(loaded["keypoints"])
    call = load_inference(data)
    reset_counts()
    with torch.no_grad():
        here = np.stack([call(images16[i:i + 1])[1][0].cpu().numpy() for i in range(16)])
    artifact_counts = launches()
    live_kp = np.stack([live.keypoints_from_image(frame)["detected_keypoints"] for frame in frames16])
    agreement = detection_agreement(artifact_kp, live_kp)
    progress("vggf_int8_export", export_s=export_s, bytes=len(data), int8_impl=meta["int8_impl"],
             live_int8_graph=live.int8_impl, modules_of_the_package=loaded["modules"],
             subprocess_equal_in_process=bool(np.array_equal(artifact_kp, here)),
             launches_during_artifact_calls=artifact_counts, artifact_vs_live=agreement)
    if (meta["int8_impl"] != "quantconv" or live.int8_impl != "quantconv" or loaded["modules"]
            or not np.array_equal(artifact_kp, here) or any(artifact_counts.values())):
        raise AssertionError("the int8 vgg-F artifact: see the line above")
    if agreement["same_found_state"] < agreement["keypoints"] - agreement["keypoints"] // 100 \
            or agreement["median_px"] > 0.05:
        raise AssertionError(f"the int8 vgg-F artifact against the live int8 network: {agreement}")
    timings["vggf_int8_export_s"] = export_s
    del live, call, data

    # 29. The soft-argmax head on vgg-Q (the r5 sidecar, port initial
    # parameters) in float32, bf16 and int8, and DOPE.
    soft = {}
    for label, dtype in (("float32", "float32"), ("bfloat16", "bfloat16"), ("int8", "bfloat16")):
        cfg = config_in(CONFIG, dtype)
        cfg["architecture"]["spatial_softmax"] = {"learned_beta": True, "initial_beta": 1.0}
        cfg["architecture"]["output_heads"] = ["belief_maps", "keypoints"]
        net = DreamNetwork(cfg, device="cuda", seed=0)
        x = net.preprocess(images16)
        if label == "int8":
            net.enable_int8_inference([net.preprocess(images16)])
        reset_counts()
        maps, keypoints = net.inference(x)
        counts = launches()
        ref = soft_argmax(maps.double(), net.model.beta.detach().double())
        err = float((keypoints.double() - ref).abs().max())
        soft[label] = {"max_px_vs_float64": err, "launches": counts, "maps": list(maps.shape),
                       "int8_graph": net.int8_impl}
        if err > 1e-3 or any(counts.values()) or tuple(keypoints.shape) != (16, 7, 2):
            raise AssertionError(f"soft-argmax head, {label}: {soft[label]}")
    maps16 = maps.float()
    beta = net.model.beta.detach()
    timings["soft_argmax_decode_ms_b16"] = cuda_ms(lambda: soft_argmax(maps16, beta), 20)
    dope = DopeNetworkBelief(7, stage_out=6, generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        stages = dope(x16[:1].permute(0, 3, 1, 2).float())
    dope_shapes = [list(s.shape) for s in stages]
    if dope_shapes != [[1, 7, 50, 50]] * 6 or not all(bool(torch.isfinite(s).all()) for s in stages):
        raise AssertionError(f"DOPE stages {dope_shapes}")
    progress("soft_argmax_and_dope", soft_argmax=soft, dope_stages=dope_shapes)
    del net, dope, stages

    # Timings: the int8 forward against bf16 at B=16, the exact route over
    # each graph's convs, peak memory.
    forward = {}
    for arch, net in nets.items():
        x = net.preprocess(images16)
        int8_ms = cuda_ms(lambda: net._belief_maps(x), 3, warmup=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net._belief_maps(x)
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        int8_graph, net.int8_model = net.int8_model, None
        bf16_ms = cuda_ms(lambda: net._belief_maps(x), 3, warmup=1)
        net.int8_model = int8_graph
        route_ms, route_peak = 0.0, 0.0
        for key, count in quant_conv_shapes(graphs[arch], (16, 3, 400, 400)).items():
            x_q, w_q = route_operands(gen, key)
            route = route_fns(key)[0]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            route_ms += count * cuda_ms(lambda: route(x_q, w_q), 2, warmup=1)
            route_peak = max(route_peak, (torch.cuda.max_memory_allocated() - before) / 2**30)
            del x_q, w_q
        forward[arch] = {"int8_forward_ms": int8_ms, "bf16_forward_ms": bf16_ms,
                         "int8_forward_extra_peak_gib": peak_gib, "exact_route_ms_summed": route_ms,
                         "exact_route_peak_gib": route_peak}
        torch.cuda.empty_cache()
    timings["forward_b16"] = forward
    progress("zoo_timings", **timings)
    del nets
    torch.cuda.empty_cache()
    return score_launches


VIZ_LIBRARIES = ("cv2", "PIL", "matplotlib", "webcolors")


def http_get_raw(url, path):
    """``(status, content type, body)`` of a GET, errors included."""
    try:
        with urllib.request.urlopen(url + path, timeout=300) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read()


def ms_a_call(fn, reps=5):
    """Host ms a call of ``fn`` after one warm-up call, the least of ``reps``."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def visualization_phase(kernels_of_port, reset_counts, smi, work, live):
    """Phase 30: the visualization layer at full width on the phase-17
    holdout: the evaluation CLI's default command line (with its mosaics),
    the single-image and video CLIs, the server's five debug streams, the
    dataset's debug dumps, and host timings of the drawing.  Returns the
    phase's kernel launches."""
    import importlib.util
    import shutil

    from dream_tpu_torch import analysis
    from dream_tpu_torch import visualize as viz
    from dream_tpu_torch.cli import network_inference as single_cli
    from dream_tpu_torch.cli import network_inference_dataset as eval_cli
    from dream_tpu_torch.cli import visualize_network_inference as video_cli
    from dream_tpu_torch.data.dataset import ManipulatorNDDSDataset
    from dream_tpu_torch.utils.config import load_yaml
    from dream_tpu_torch.utils.png import decode_png, read_png

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    hold, tmp = work["hold"], work["tmp_dir"].name
    loaded_before = {m for m in VIZ_LIBRARIES if m in sys.modules}
    probe = {m: importlib.util.find_spec(m) is not None for m in VIZ_LIBRARIES}
    probe["ffmpeg"] = shutil.which("ffmpeg")
    progress("visualization_probe", installed=probe, already_imported=sorted(loaded_before))
    counts = {k: 0 for k in kernels_of_port}

    def add(c):
        for k, v in c.items():
            counts[k] += v

    # (b) The evaluation CLI's default command line: mosaics on.
    mosaic_s = []
    write_mosaics = analysis._write_sample_mosaics

    def timed_mosaics(*args):
        t0 = time.perf_counter()
        write_mosaics(*args)
        mosaic_s.append(time.perf_counter() - t0)

    analysis._write_sample_mosaics = timed_mosaics
    out_dir = os.path.join(tmp, "eval_vggq_mosaics")
    reset_counts()
    try:
        quiet(eval_cli.network_inference_dataset, eval_cli.make_parser().parse_args(
            ["-i", CHECKPOINT, "-d", hold, "-o", out_dir, "-b", "16", "-w", "8"]))
    finally:
        analysis._write_sample_mosaics = write_mosaics
    eval_counts = launches()
    add(eval_counts)
    failures = []
    with open(os.path.join(out_dir, "keypoints.csv"), "rb") as f, \
            open(os.path.join(work["vggq_dir"], "keypoints.csv"), "rb") as g:
        if f.read() != g.read():
            failures.append("keypoints.csv differs from phase 18's")
    if eval_counts["score_kernel"] != HOLDOUT_FRAMES // 16:
        failures.append(f"launches {eval_counts}: not the score kernel once a batch")
    detected = csv_detections(os.path.join(out_dir, "keypoints.csv"))
    with open(os.path.join(out_dir, "keypoints.csv"), newline="") as f:
        rows = list(csv.reader(f))[1:]
    gt = np.array([r[15:29] for r in rows], float).reshape(-1, 7, 2)
    ranked = sorted(range(len(rows)), key=lambda i: analysis.sample_l2_metric(
        detected[i], gt[i], (640, 480)))
    n = len(ranked)
    middle = int(np.floor(n / 2.0 - 5 / 2.0))  # dream_tpu/analysis.py:854-861, 5 a group
    groups = {"best": ranked[:5], "medians": ranked[middle : middle + 5], "worst": ranked[n - 5 :]}
    centres_red = 0
    mosaic_shapes = {}
    for group, members in groups.items():
        path = os.path.join(out_dir, f"{group}_samples.png")
        if not os.path.exists(path):
            failures.append(f"{group}_samples.png was not written")
            continue
        mosaic = read_png(path)
        mosaic_shapes[group] = list(mosaic.shape)
        if mosaic.shape != (480, 5 * 640 + 4 * 4, 3):
            failures.append(f"{group}_samples.png is {mosaic.shape}")
            continue
        for tile, i in enumerate(members):
            for x, y in detected[i]:
                # A red (6 px) detection no green (4 px) ground truth covers.
                if x < -999.0 or not (0 <= x < 640 and 0 <= y < 480):
                    continue
                if np.min(np.linalg.norm(gt[i] - (x, y), axis=1)) <= 4.0:
                    continue
                pixel = mosaic[int(y), tile * 644 + int(x)]
                if tuple(pixel) != (255, 0, 0):
                    failures.append(f"{group} tile {tile}: pixel {tuple(pixel)} at detection ({x}, {y})")
                centres_red += 1
    progress("visualization_evaluation_cli", mosaics=mosaic_shapes, mosaic_s=mosaic_s,
             keypoints_csv="byte-equal to phase 18's" if not failures else "see failures",
             launches=eval_counts, red_detection_centres_checked=centres_red, card=smi)
    if failures or not mosaic_s or centres_red == 0:
        raise AssertionError("phase 30 (b): " + "; ".join(failures or ["no mosaic timed or no centre checked"]))

    # (c) The single-image CLI on holdout frame 000000.
    single_dir = os.path.join(tmp, "single_image")
    frame = os.path.join(hold, "000000.rgb.png")
    reset_counts()
    detection, _ = quiet(single_cli.network_inference, single_cli.make_parser().parse_args(
        ["-i", CHECKPOINT, "-m", frame, "-o", single_dir]))
    single_counts = launches()
    add(single_counts)
    sizes = {"keypoints_raw.png": (480, 640), "keypoints_net_input.png": (400, 400),
             "belief_maps.png": (100, 7 * 100 + 6 * 10), "belief_blends.png": (400, 7 * 400),
             "keypoints_vs_gt.png": (480, 640)}
    written = {f: list(read_png(os.path.join(single_dir, f)).shape) for f in sorted(os.listdir(single_dir))}
    vs_cli = detection_agreement(detection["detected_keypoints"][None], detected[:1])
    progress("visualization_single_image_cli", files=written, launches=single_counts,
             detections_vs_phase_18=vs_cli)
    if (written != {f: list(hw) + [3] for f, hw in sizes.items()} or single_counts["score_kernel"] != 1
            or vs_cli["same_found_state"] != 7 or vs_cli["median_px"] > 0.05):
        raise AssertionError("phase 30 (c): see the line above")

    # (d) The video CLI on frames 0-15, all four types; then int8.
    video_dir = os.path.join(tmp, "video")
    reset_counts()
    summary, _ = quiet(video_cli.visualize_network_inference, video_cli.make_parser().parse_args(
        ["-i", CHECKPOINT, "-d", hold, "-o", video_dir, "-s", "0", "-e", "16", "-b", "16", "-t"]
        + video_cli.ALL_VIZ_TYPES))
    video_counts = launches()
    add(video_counts)
    frames = {vt: len(os.listdir(os.path.join(video_dir, vt + "_frames"))) for vt in video_cli.ALL_VIZ_TYPES}
    mp4 = {vt: os.path.exists(os.path.join(video_dir, vt + ".mp4")) for vt in video_cli.ALL_VIZ_TYPES}
    int8_dir = os.path.join(tmp, "video_int8")
    reset_counts()
    int8_summary, _ = quiet(video_cli.visualize_network_inference, video_cli.make_parser().parse_args(
        ["-i", CHECKPOINT, "-d", hold, "-o", int8_dir, "-s", "0", "-e", "16", "-b", "16",
         "--int8-calibration-frames", "16"]))
    int8_counts = launches()
    add(int8_counts)
    progress("visualization_video_cli", frames=frames, mp4_written=mp4, ffmpeg=probe["ffmpeg"],
             frames_per_s={vt: summary["frames"] / s for vt, s in summary["seconds_by_type"].items()},
             launches=video_counts, int8={"frames": int8_summary["frames"], "launches": int8_counts})
    if (set(frames.values()) != {16} or video_counts["score_kernel"] != 1
            or any(v != bool(probe["ffmpeg"]) for v in mp4.values())
            or int8_counts["conv_int8_kernel"] != 19 or int8_counts["score_kernel"] != 1):
        raise AssertionError("phase 30 (d): see the line above")

    # (e) The server's debug streams, after phase 21's frames and one more.
    def post_frame(url, i):
        http_post(url, "/keypoint_positions", json.dumps(live["positions"][i].tolist()).encode())
        return http_post(url, "/image", live["pngs"][i])

    reset_counts()
    posted = post_frame(live["url"], live["first"])
    serve_counts = launches()
    add(serve_counts)
    want = {"net_input_image": (400, 400), "keypoint_overlay": (480, 640), "belief_maps": (100, 700),
            "keypoint_belief_overlay": (480, 640), "keypoint_frame_overlay": (480, 640)}
    streams = {}
    for stream, hw in want.items():
        status, kind, body = http_get_raw(live["url"], f"/debug/{stream}.png")
        shape = list(decode_png(body).shape) if status == 200 else None
        streams[stream] = {"status": status, "type": kind, "shape": shape}
        if status != 200 or kind != "image/png" or shape != list(hw) + [3]:
            failures.append(f"{stream}: {streams[stream]}")
    unknown = http_get_raw(live["url"], "/debug/nonsense.png")[0]
    post_frame(live["artifact_url"], live["first"])
    artifact_net_input = http_get_raw(live["artifact_url"], "/debug/net_input_image.png")[0]
    progress("visualization_debug_streams", posted=posted, launches=serve_counts, streams=streams,
             unknown_stream=unknown, artifact_net_input_image=artifact_net_input)
    for key in ("httpd", "artifact_httpd"):
        stop_http(live[key])
    if failures or unknown != 404 or artifact_net_input != 404 or serve_counts["score_kernel"] != 1 \
            or not posted["pnp"]:
        raise AssertionError("phase 30 (e): " + "; ".join(failures or ["see the line above"]))

    # (f) The dataset's HEAVY and INTERACTIVE dumps of 4 frames.
    names = [kp["name"] for kp in load_yaml(PANDA)["manipulator"]["keypoints"]]
    dumps = {}
    for level in (2, 3):
        dump_dir = os.path.join(tmp, f"dump_{level}")
        ds = ManipulatorNDDSDataset(hold, "panda", names, (400, 400), (100, 100), debug_mode=level,
                                    debug_dir=dump_dir, n_decode_threads=8)
        t0 = time.perf_counter()
        ds.host_batch([0, 1, 2, 3])
        dumps[level] = {"files": len(os.listdir(dump_dir)), "seconds": time.perf_counter() - t0,
                        "index_html": os.path.exists(os.path.join(dump_dir, "index.html"))}
    progress("visualization_dataset_dumps", heavy=dumps[2], interactive=dumps[3])
    if dumps[2]["files"] != 12 or dumps[2]["index_html"] or dumps[3]["files"] != 13 \
            or not dumps[3]["index_html"]:
        raise AssertionError("phase 30 (f): see the line above")

    # (g) Host timings of the drawing, on the card machine's CPU.
    raw = read_png(frame)
    maps = np.random.RandomState(30).uniform(0, 1, (7, 100, 100)).astype(np.float32)
    tiles = [raw] * 5
    timings = {
        "overlay_7_points_640x480_ms": ms_a_call(lambda: viz.overlay_points_on_image(raw, detected[0])),
        "overlay_7_points_with_names_ms": ms_a_call(
            lambda: viz.overlay_points_on_image(raw, detected[0], names)),
        "colormap_7x100x100_ms": ms_a_call(lambda: viz.images_from_belief_maps(maps)),
        "blend_100_to_640x480_ms": ms_a_call(lambda: viz.blend_belief_overlay(raw, maps[0])),
        "mosaic_5x640x480_ms": ms_a_call(lambda: viz.mosaic_images(tiles, rows=1, cols=5,
                                                                   inner_padding_px=4)),
        "host": "the card machine's CPU",
    }
    leaked = sorted({m for m in VIZ_LIBRARIES if m in sys.modules} - loaded_before)
    progress("visualization_timings", card=smi, **timings, libraries_imported_by_the_port=leaked)
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    return counts


def jpeg_and_tools_phase(kernels_of_port, reset_counts, smi, work, network):
    """Phase 31: the host image loader, JPEG frames through the evaluation
    CLI and the server, encoder pretraining, a training epoch from the
    pretrained encoder, ``resolve_pnp`` and ``compress_checkpoint``, at full
    width on the phase-17 sets.  ``network`` is phase 21's live vgg-Q r5
    bf16 network.  Returns the phase's kernel launches."""
    import shutil
    from pathlib import Path

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.cli import compress_checkpoint as compress_cli
    from dream_tpu_torch.cli import network_inference_dataset as eval_cli
    from dream_tpu_torch.cli import pretrain_encoder as pretrain_cli
    from dream_tpu_torch.cli import resolve_pnp as resolve_cli
    from dream_tpu_torch.cli import train_network as train_cli
    from dream_tpu_torch.data import native_loader
    from dream_tpu_torch.network import create_network_from_config_file
    from dream_tpu_torch.ops import cuda_build
    from dream_tpu_torch.serve import DreamInferenceServer
    from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, load_camera_intrinsics
    from dream_tpu_torch.utils.png import read_png

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    counts = {k: 0 for k in kernels_of_port}

    def timed(fn, *args):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, text = quiet(fn, *args)
        torch.cuda.synchronize()
        c = launches()
        for k, v in c.items():
            counts[k] += v
        return result, text, time.perf_counter() - t0, c

    def ms_a_frame(paths, n_threads, h=480, w=640, reps=3):
        native_loader.decode_batch(paths[:2], h, w, n_threads)
        best = []
        for _ in range(reps):
            t0 = time.perf_counter()
            native_loader.decode_batch(paths, h, w, n_threads)
            best.append((time.perf_counter() - t0) / len(paths) * 1e3)
        return min(best)

    hold, tmp, disk = work["hold"], work["tmp_dir"].name, work["disk"]
    keep = os.environ.get("DREAM_SMOKE_ARTIFACTS")

    # (a) The loader: what the machine offers it, its build, the 64 PNGs.
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    probe = {"headers": {h: os.path.exists(os.path.join("/usr/include", h))
                         for h in ("jpeglib.h", "png.h", "zlib.h")},
             "libraries": sorted(set(re.findall(r"\b(lib(?:jpeg|png\w*|z)\.so[.\d]*)", ldconfig))),
             "compilers": {c: shutil.which(c) for c in ("g++", "gcc")}}
    built_in = cuda_build.BUILD_DIR
    cuda_build.BUILD_DIR = Path(tmp) / "loader_build"
    try:
        t0 = time.perf_counter()
        cuda_build.build(native_loader.LIBRARY)
        build_s = time.perf_counter() - t0
    finally:
        cuda_build.BUILD_DIR = built_in
    found_data, found_configs = find_ndds_data_in_dir(hold)
    png_paths = [d["image_paths"]["rgb"] for d in found_data]
    frames = native_loader.decode_batch(png_paths, 480, 640, 8)
    png_equal = sum(np.array_equal(f, read_png(p)) for f, p in zip(frames, png_paths))
    t0 = time.perf_counter()
    for p in png_paths[:8]:
        read_png(p)
    numpy_ms = (time.perf_counter() - t0) / 8 * 1e3
    png_ms = {"1_thread": ms_a_frame(png_paths, 1), "8_threads": ms_a_frame(png_paths, 8)}
    progress("image_loader_png", probe=probe, build_s=build_s, frames_equal_to_decode_png=png_equal,
             ms_a_frame=png_ms, numpy_reader_ms_a_frame_1_thread=numpy_ms, card=smi,
             host="the card machine's CPU")
    if png_equal != HOLDOUT_FRAMES:
        raise AssertionError(f"the loader decoded {png_equal} of {HOLDOUT_FRAMES} PNGs as decode_png does")

    # (b) A JPEG copy of the holdout (quality 90, 4:2:0, written by PIL in a
    # process of its own), decoded as PIL decodes it, through the
    # evaluation CLI against phase 18's PNG run.
    jpeg_dir = os.path.join(tmp, "hold64_jpg")
    pil_npy = os.path.join(tmp, "pil_decoded.npy")
    made = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_jpeg_copy.py"), hold, jpeg_dir,
                           "--quality", "90", "--subsampling", "2", "--decoded", pil_npy],
                          capture_output=True, text=True, timeout=300)
    if made.returncode != 0:
        raise AssertionError(f"scripts/make_jpeg_copy.py (PIL) failed:\n{made.stderr[-2000:]}")
    jpeg_data, _ = find_ndds_data_in_dir(jpeg_dir)
    jpeg_paths = [d["image_paths"]["rgb"] for d in jpeg_data]
    pil = np.load(pil_npy)
    jpeg_frames = native_loader.decode_batch(jpeg_paths, 480, 640, 8)
    jpeg_equal = sum(np.array_equal(a, b) for a, b in zip(jpeg_frames, pil))
    jpeg_ms = {"1_thread": ms_a_frame(jpeg_paths, 1), "8_threads": ms_a_frame(jpeg_paths, 8)}
    jpeg_eval = os.path.join(tmp, "eval_vggq_jpeg")
    (kp, pnp), text, eval_s, eval_counts = timed(eval_cli.network_inference_dataset, eval_cli.make_parser()
                                                 .parse_args(["-i", CHECKPOINT, "-d", jpeg_dir, "-o", jpeg_eval,
                                                              "--no-visualization", "-b", "16", "-w", "8"]))
    result = {"keypoints": kp, "pnp": pnp, "pnp_transposed": {"add_auc": alternate_add_auc(text)}}
    png_run = reference_metrics(os.path.join(work["vggq_dir"], "analysis_results.txt"))
    # Quality-90 JPEG pixels are not the PNG run's, as vgg-F's are not its
    # report's: out-of-frame found within vgg-F's 2 (the JPEG copy found 1
    # where the PNG run found 0 on the H100).
    measured, failures = eval_bounds(result, png_run, outframe_tol=2, min_pnp=56)
    jpeg_vs_png = keypoint_agreement(os.path.join(jpeg_eval, "keypoints.csv"),
                                     os.path.join(work["vggq_dir"], "keypoints.csv"))
    progress("jpeg_evaluation_cli", written_by="PIL " + made.stdout.strip(), frames_equal_to_pil=jpeg_equal,
             ms_a_frame=jpeg_ms, seconds=eval_s, frames_per_s=HOLDOUT_FRAMES / eval_s, launches=eval_counts,
             measured=measured, png_run=png_run, keypoints_vs_png_run=jpeg_vs_png, card=smi)
    if jpeg_equal != HOLDOUT_FRAMES:
        failures.append(f"{jpeg_equal} of {HOLDOUT_FRAMES} JPEGs decoded as PIL decodes them")
    if eval_counts["score_kernel"] != HOLDOUT_FRAMES // 16:
        failures.append(f"the score kernel launched {eval_counts['score_kernel']} times, not once a batch")
    if failures:
        raise AssertionError("phase 31 (b): " + "; ".join(failures))
    if keep:
        os.makedirs(keep, exist_ok=True)
        shutil.copyfile(os.path.join(jpeg_eval, "keypoints.csv"), os.path.join(keep, "keypoints_jpeg.csv"))
        shutil.copyfile(os.path.join(work["vggq_dir"], "keypoints.csv"), os.path.join(keep, "keypoints_png.csv"))

    # (b') A progressive copy of the holdout (quality 90, 4:2:0, libjpeg's
    # 10-scan script, written by PIL in a process of its own): each frame as
    # PIL decodes it and equal to (b)'s baseline frame (PIL codes the same
    # quantized coefficients both ways, and a complete file is not
    # smoothed), and the evaluation CLI's keypoints.csv equal to (b)'s.
    prog_dir = os.path.join(tmp, "hold64_jpg_progressive")
    prog_npy = os.path.join(tmp, "pil_decoded_progressive.npy")
    made_prog = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_jpeg_copy.py"), hold, prog_dir,
                                "--quality", "90", "--subsampling", "2", "--progressive", "--decoded", prog_npy],
                               capture_output=True, text=True, timeout=300)
    if made_prog.returncode != 0:
        raise AssertionError(f"scripts/make_jpeg_copy.py --progressive (PIL) failed:\n{made_prog.stderr[-2000:]}")
    prog_data, _ = find_ndds_data_in_dir(prog_dir)
    prog_paths = [d["image_paths"]["rgb"] for d in prog_data]
    sof2 = 0
    for path in prog_paths:
        with open(path, "rb") as f:
            sof2 += b"\xff\xc2" in f.read()
    prog_frames = native_loader.decode_batch(prog_paths, 480, 640, 8)
    prog_equal_pil = sum(np.array_equal(a, b) for a, b in zip(prog_frames, np.load(prog_npy)))
    prog_equal_baseline = sum(np.array_equal(a, b) for a, b in zip(prog_frames, jpeg_frames))
    prog_ms = {"1_thread": ms_a_frame(prog_paths, 1), "8_threads": ms_a_frame(prog_paths, 8)}
    prog_bytes = sum(os.path.getsize(p) for p in prog_paths) / len(prog_paths)
    base_bytes = sum(os.path.getsize(p) for p in jpeg_paths) / len(jpeg_paths)
    prog_eval = os.path.join(tmp, "eval_vggq_jpeg_progressive")
    _, _, prog_s, prog_counts = timed(eval_cli.network_inference_dataset, eval_cli.make_parser().parse_args(
        ["-i", CHECKPOINT, "-d", prog_dir, "-o", prog_eval, "--no-visualization", "-b", "16", "-w", "8"]))
    with open(os.path.join(prog_eval, "keypoints.csv")) as a, open(os.path.join(jpeg_eval, "keypoints.csv")) as b:
        prog_lines, base_lines = a.read().splitlines(), b.read().splitlines()
    same_lines = sum(x == y for x, y in zip(prog_lines, base_lines))
    progress("progressive_jpeg_evaluation_cli", written_by="PIL " + made_prog.stdout.strip(),
             progressive_files=sof2, frames_equal_to_pil=prog_equal_pil,
             frames_equal_to_baseline_copy=prog_equal_baseline, ms_a_frame=prog_ms, baseline_ms_a_frame=jpeg_ms,
             bytes_a_frame=prog_bytes, baseline_bytes_a_frame=base_bytes, seconds=prog_s,
             frames_per_s=HOLDOUT_FRAMES / prog_s, launches=prog_counts,
             keypoints_csv_lines_equal_to_baseline_run=[same_lines, len(base_lines)], card=smi)
    if (sof2 != HOLDOUT_FRAMES or prog_equal_pil != HOLDOUT_FRAMES or prog_equal_baseline != HOLDOUT_FRAMES
            or prog_counts["score_kernel"] != HOLDOUT_FRAMES // 16
            or len(prog_lines) != len(base_lines) or same_lines != len(base_lines)):
        raise AssertionError("phase 31 (b'): see the line above")

    # (c) The JPEG frames served live in bf16 at batch 1, through the client.
    K = load_camera_intrinsics(found_configs["camera"])
    server = DreamInferenceServer(network, base_frame="panda_link0")
    httpd, url = start_http(server)
    try:
        http_post(url, "/camera_info", json.dumps(
            {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}).encode())
        for i in range(3):
            http_post(url, "/keypoint_positions", json.dumps(disk.kp_positions[i].tolist()).encode())
            with open(jpeg_paths[i], "rb") as f:
                http_post(url, "/image", f.read())
        records = record_frames(server)
        reset_counts()
        lines, client = run_client(url, jpeg_dir)
        serve_counts = launches()
    finally:
        stop_http(httpd)
    for k, v in serve_counts.items():
        counts[k] += v
    detected = np.stack([r["detected"] for r in records])
    vs_cli = detection_agreement(detected, csv_detections(os.path.join(jpeg_eval, "keypoints.csv")))
    published = sum(bool(r["status"]["pnp"]) for r in records)
    progress("jpeg_serving", requests=len(records), launches=serve_counts, detections_vs_evaluation_cli=vs_cli,
             poses_published=published, evaluation_cli_pnp=[pnp["num_pnp_found"], pnp["num_pnp_possible"]],
             client=client, request_ms_p50=client["image_ms_p50"], card=smi)
    if (len(records) != HOLDOUT_FRAMES or len(lines) != HOLDOUT_FRAMES
            or serve_counts["score_kernel"] != HOLDOUT_FRAMES
            or vs_cli["same_found_state"] < vs_cli["keypoints"] - 3 or vs_cli["median_px"] > 0.05 or abs(published - pnp["num_pnp_found"]) > 1):
        raise AssertionError("phase 31 (c): see the line above")

    # (b') served: 8 progressive bodies posted to the same network's server,
    # one score launch each; each request's detections equal (c)'s of the
    # same frame (the same pixels at batch 1), and hold to the progressive
    # CLI run's rows under (c)'s bounds.
    server = DreamInferenceServer(network, base_frame="panda_link0")
    httpd, url = start_http(server)
    try:
        prog_records = record_frames(server)
        reset_counts()
        for path in prog_paths[:8]:
            with open(path, "rb") as f:
                http_post(url, "/image", f.read())
        prog_serve_counts = launches()
    finally:
        stop_http(httpd)
    for k, v in prog_serve_counts.items():
        counts[k] += v
    prog_detected = np.stack([r["detected"] for r in prog_records])
    equal_to_c = sum(np.array_equal(a, b["detected"]) for a, b in zip(prog_detected, records[:8]))
    prog_vs_cli = detection_agreement(prog_detected, csv_detections(os.path.join(prog_eval, "keypoints.csv"))[:8])
    progress("progressive_jpeg_serving", requests=len(prog_records), launches=prog_serve_counts,
             detections_equal_to_baseline_requests=[equal_to_c, 8], detections_vs_evaluation_cli=prog_vs_cli,
             card=smi)
    if (len(prog_records) != 8 or prog_serve_counts["score_kernel"] != 8 or equal_to_c != 8
            or prog_vs_cli["same_found_state"] < prog_vs_cli["keypoints"] - 3 or prog_vs_cli["median_px"] > 0.05):
        raise AssertionError("phase 31 (b'), served: see the line above")

    # (d) Encoder pretraining at the CLI's defaults (256x256, batch 32,
    # bf16): 200 steps on a 64-scene device pool, then 20 streamed.
    encoder = os.path.join(tmp, "encoder_ae.msgpack")
    pretrained = {}
    for route, argv in (("pool", ["-o", encoder, "--pool", "64", "--steps", "200"]),
                        ("streamed", ["-o", os.path.join(tmp, "encoder_streamed.msgpack"), "--steps", "20",
                                      "--log-every", "10"])):
        res, _, seconds, c = timed(pretrain_cli.pretrain_encoder, pretrain_cli.make_parser().parse_args(argv))
        losses = res["losses"]
        pretrained[route] = {"seconds": seconds, "images_per_s": res["images_per_s"], "launches": c,
                             "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
                             "n_params": res["n_params"]}
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"pretraining ({route}): losses not finite")
        if route == "pool":
            first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
            pretrained[route].update(mean_first_50=first, mean_last_50=last)
            if not last < first:
                raise AssertionError(f"pretraining: the last 50 losses' mean {last} is not below the first's {first}")
    progress("pretrain_encoder", card=smi, **pretrained)

    # (e) One training-CLI epoch of vgg-Q from the pretrained encoder.
    train_out = os.path.join(tmp, "train_from_encoder")
    steps_per_epoch = int(round(TRAIN_SET_FRAMES * 0.8)) // TRAIN_BATCH
    _, text, train_s, train_counts = timed(train_cli.train_network, train_cli.make_parser().parse_args(
        ["-i", os.path.join(tmp, "train128"), "-m", PANDA, "-ar", VGGQ_ARCH, "-o", train_out, "-e", "1",
         "--loss-pos-weight", "50", "--init-encoder", encoder] + R5_TRAIN_FLAGS))
    grafted = re.search(r"\((\d+) leaves grafted, (\d+) shape-skipped\)", text)
    progress("training_from_encoder", grafted=grafted and grafted.group(0), seconds=train_s,
             launches=train_counts)
    if (grafted is None or (int(grafted.group(1)), int(grafted.group(2))) != (32, 0)
            or train_counts["warp_kernel"] != steps_per_epoch):
        raise AssertionError("phase 31 (e): see the line above")

    # (f) resolve_pnp on (b)'s keypoints.csv: plain reproduces (b)'s
    # pnp_results.csv; --ransac timed.
    resolved = {}
    for mode, flags in (("plain", []), ("ransac", ["--ransac"])):
        out_dir = os.path.join(tmp, f"resolved_{mode}")
        metrics, _, seconds, _ = timed(resolve_cli.resolve_pnp, resolve_cli.make_parser().parse_args(
            ["-k", os.path.join(jpeg_eval, "keypoints.csv"), "-d", jpeg_dir, "-m", PANDA, "-o", out_dir] + flags))
        resolved[mode] = {"seconds": seconds, "pnp_success": [metrics["num_pnp_found"], metrics["num_pnp_possible"]],
                          "add_auc": metrics["add_auc"], "add_mean": metrics["add_mean"]}
    with open(os.path.join(tmp, "resolved_plain", "pnp_results.csv")) as a, \
            open(os.path.join(jpeg_eval, "pnp_results.csv")) as b:
        rows_a, rows_b = list(csv.reader(a)), list(csv.reader(b))
    same_rows = sum(x == y for x, y in zip(rows_a, rows_b))
    pose_delta = max(float(np.max(np.abs(np.float64(x[2:10]) - np.float64(y[2:10]))))
                     for x, y in zip(rows_a[1:], rows_b[1:]))
    progress("resolve_pnp", **resolved, rows_equal=[same_rows, len(rows_b)], largest_pose_or_add_delta=pose_delta,
             evaluation_cli={"pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
                             "add_auc": pnp["add_auc"]})
    if (len(rows_a) != len(rows_b) or any(x[:2] != y[:2] or x[-1] != y[-1] for x, y in zip(rows_a, rows_b))
            or pose_delta > 1e-4 or abs(resolved["plain"]["add_auc"] - pnp["add_auc"]) > 1e-6):
        raise AssertionError("phase 31 (f): see the line above")
    if keep:
        shutil.copyfile(os.path.join(tmp, "resolved_ransac", "pnp_results.csv"),
                        os.path.join(keep, "pnp_results_ransac_card.csv"))

    # (g) compress_checkpoint of (e)'s best network and of phase 19's
    # vgg-Q, then 16 holdout frames through each file and its float16 copy:
    # the belief maps correlate at >= 0.999 and PCK AUC stays within 0.005.
    # Found states are printed, not held: these networks are a few steps
    # old, their maps hover near the threshold, and bf16 convs of
    # float16-rounded weights flipped 5 of 112 on each on the H100.
    frames16 = frames[:16]
    gt16 = {"projections": disk.kp_projs_raw[:16], "positions": disk.kp_positions[:16]}
    compressed = {}
    for label, best in (("from_encoder", os.path.join(train_out, "best_network.msgpack")),
                        ("phase_19_vgg-Q", os.path.join(tmp, "train_vggq", "best_network.msgpack"))):
        best16 = os.path.join(tmp, f"{label}_f16.msgpack")
        quiet(compress_cli.compress_checkpoint, best, best16)
        evaluated, maps = [], []
        for params in (best, best16):
            net = create_network_from_config_file(os.path.splitext(params)[0] + ".yaml", params, device="cuda")
            evaluated.append(timed(evaluate_frames, net, frames16, gt16, K, 16)[0])
            with torch.no_grad():
                maps.append(net._belief_maps(net.preprocess(torch.from_numpy(frames16))))
            del net
        a, b = evaluated
        found_a, found_b = a["detected_raw"][..., 0] > -999.0, b["detected_raw"][..., 0] > -999.0
        same = int(np.sum(found_a == found_b))
        pck = [a["keypoints"]["l2_error_auc"], b["keypoints"]["l2_error_auc"]]
        corr = map_correlation(maps[0], maps[1])
        compressed[label] = {"bytes": [os.path.getsize(best), os.path.getsize(best16)],
                             "same_found_state": [same, int(found_a.size)],
                             "found": [int(found_a.sum()), int(found_b.sum())], "pck_auc": pck,
                             "map_correlation": corr}
        if corr < 0.999 or ((pck[0] is None) != (pck[1] is None)
                            or (pck[0] is not None and abs(pck[0] - pck[1]) > 0.005)):
            progress("compressed_checkpoint", **compressed)
            raise AssertionError(f"phase 31 (g): {label}")
    progress("compressed_checkpoint", **compressed)
    torch.cuda.empty_cache()
    return counts



def update_mismatch(start, a, b):
    """How far two runs' parameter updates from ``start`` differ: the mean
    absolute difference of the updates over the mean absolute update, over
    every float parameter."""
    diff = total = 0.0
    for k, v in start.items():
        if not v.is_floating_point() or "running_" in k:
            continue
        da, db = a[k].double() - v.double(), b[k].double() - v.double()
        diff += float((da - db).abs().sum())
        total += float(db.abs().sum())
    return diff / total


def running_mismatch(a, b):
    """Largest difference of the BatchNorm running statistics over their
    largest magnitude."""
    keys = [k for k in a if "running_" in k]
    return max(float((a[k] - b[k]).abs().max()) for k in keys) / max(
        float(b[k].abs().max()) for k in keys)


def mesh_steps_phase(kernels_of_port, reset_counts, smi, frames):
    """Phase 32 (a)-(b): train steps on meshes of ranks on the one card
    against the unsharded runs, each held to ``MESH_GATES``.  ``frames`` is
    phase 6's 32 rendered frames (``images``, ``projections``).  Returns
    the kernel launches of this process and of every rank it spawned."""
    import torch.distributed as dist

    from dream_tpu_torch.parallel import mesh as mesh_ops
    from dream_tpu_torch.parallel.dryrun import (mesh_train_run, split_gradient_reading, train_network_for_run,
                                                 train_steps, whole_gap)

    counts, add, own = launch_counter(kernels_of_port)
    raw, kps = frames["images"], frames["projections"].astype(np.float32)
    dtypes = ("bfloat16", "float32")

    def runs_of(config_path, dtype, **run):
        return {"config": config_in(config_path, dtype), "steps": MESH_STEPS, "augment": True, **run}

    # vgg-Q's float32 runs (and the float64 ones made from them) record
    # their forward's decisions on 2 frames for the split-gradient reading.
    nets = {"vgg-Q": {d: runs_of(CONFIG, d, params_path=CHECKPOINT, aug_seed=32, batch={"raw": raw, "kp": kps},
                                 **({"record_decisions": 2} if d == "float32" else {})) for d in dtypes},
            "resnet-H": {d: runs_of(RESNETS["resnet-H"][0], d, seed=0, aug_seed=33,
                                    batch={"raw": raw[:8], "kp": kps[:8]}) for d in dtypes}}

    # (a) The unsharded runs, each also with cuDNN choosing its algorithms
    # by timing them (the same arithmetic in another order: rounding's own
    # spread; a plain repeat is bit-identical), then one NCCL rank through
    # shard_for_mesh in bf16.
    reset_counts()

    def benchmarked(run):
        torch.backends.cudnn.benchmark = True
        try:
            return train_steps(train_network_for_run(run, "cuda"), run)
        finally:
            torch.backends.cudnn.benchmark = False

    reference = {(name, d): [train_steps(train_network_for_run(runs[d], "cuda"), runs[d]),
                             benchmarked(runs[d])] for name, runs in nets.items() for d in dtypes}
    # The float64 witness of the split path: one step of vgg-Q in float64.
    nets["vgg-Q"]["float64"] = dict(nets["vgg-Q"]["float32"], steps=1, float64=True)
    reference[("vgg-Q", "float64")] = [train_steps(train_network_for_run(nets["vgg-Q"]["float64"], "cuda"),
                                                   nets["vgg-Q"]["float64"])]
    start = {name: {k: v.cpu() for k, v in
                    train_network_for_run(runs["float32"], "cuda").model.state_dict().items()}
             for name, runs in nets.items()}

    def local_batchnorm_reading(dtype):
        """The planted fault of BatchNorm on one rank's rows: the unsharded
        network's first step on rank 0's rows of the first augmented global
        batch, its running statistics against the reference's."""
        run = nets["resnet-H"][dtype]
        net = train_network_for_run(run, "cuda")
        half = len(run["batch"]["raw"]) // 2
        generator = torch.Generator(device="cuda").manual_seed(run["aug_seed"])
        rows = net._batch_processor(generator, torch.as_tensor(run["batch"]["raw"][:half]).cuda(),
                                    torch.as_tensor(run["batch"]["kp"][:half]).cuda(), shard=(0, 2))
        local = train_steps(net, {"steps": 1, "batch": {"x": rows["image_rgb_input"],
                                                        "target": rows["belief_maps"]}})
        return running_mismatch(local["running_after_first_step"],
                                reference[("resnet-H", dtype)][0]["running_after_first_step"])

    local_bn = {d: local_batchnorm_reading(d) for d in dtypes}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{mesh_ops.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_ops.make_mesh(1, 1, ["cuda:0"])
        run = nets["vgg-Q"]["bfloat16"]
        nccl = train_steps(train_network_for_run(run, mesh.device, mesh), run)
    finally:
        dist.destroy_process_group()
    add(own())
    torch.cuda.empty_cache()

    # (b) Two ranks sharing the card under gloo: vgg-Q (data 2) and (data 1,
    # model 2), (b') ResNet-H (data 2) at batch 8, each in bf16 and float32.
    layouts = [(f"b_{name}_{'data2' if nd == 2 else 'model2'}_{'bf16' if d == 'bfloat16' else d}",
                name, d, nd, nm)
               for d in dtypes for name, nd, nm in (("vgg-Q", 2, 1), ("vgg-Q", 1, 2), ("resnet-H", 2, 1))]
    layouts.append(("b_vgg-Q_model2_float64", "vgg-Q", "float64", 1, 2))
    t0 = time.perf_counter()
    ranks = mesh_ops.spawn_local_ranks(
        mesh_train_run, 2, "gloo", ["cuda:0", "cuda:0"],
        [dict(nets[name][d], n_data=nd, n_model=nm) for _, name, d, nd, nm in layouts],
        ["cuda:0", "cuda:0"])
    spawn_s = time.perf_counter() - t0
    for rank in ranks:
        for run in rank:
            add(run["launches"])

    def differences(name, run, ref):
        """``run`` against ``ref``: the first step's loss (relative),
        gradients (relative L2, also over the split parameters alone where
        there are any) and, for a ResNet, running statistics; and
        after the last step its loss, the parameter updates and running
        statistics."""
        out = {"loss_1": abs(run["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
               "grads_1": whole_gap(run["grads"], ref["grads"]),
               "loss_last": abs(run["losses"][-1] - ref["losses"][-1]) / abs(ref["losses"][-1]),
               "update_last": update_mismatch(start[name], run["state"], ref["state"])}
        if run["split"]:
            out["grads_split_1"] = whole_gap(run["grads"], {k: ref["grads"][k] for k in run["split"]})
        if name == "resnet-H":
            out["running_1"] = running_mismatch(run["running_after_first_step"], ref["running_after_first_step"])
            out["running_last"] = running_mismatch(run["state"], ref["state"])
        return out

    def fault_readings(name, dtype, n_data, n_model):
        """What each planted fault reads, by the difference it shows in."""
        out = {"update_last": {"state left unchanged": 1.0}}
        if n_data > 1:
            out["grads_1"] = {"gradients summed, not averaged": float(n_data - 1)}
        if n_model > 1:
            out["grads_split_1"] = {"split gradients scaled by M": float(n_model - 1)}
        if name == "resnet-H" and n_data > 1:
            out["running_1"] = {"BatchNorm on one rank's rows": local_bn[dtype]}
        return out

    rows = {}
    for label, name, dtype, nd, nm, run in [("a_vgg-Q_nccl_1_rank_bf16", "vgg-Q", "bfloat16", 1, 1, nccl)] + [
            layout + (result,) for layout, result in zip(layouts, ranks[0])]:
        diff = differences(name, run, reference[(name, dtype)][0])
        gate = MESH_GATES.get((name, dtype, "model2" if nm > 1 else "data"), MESH_GATES.get((name, dtype)))
        faults = fault_readings(name, dtype, nd, nm)
        gated = [k for k in diff if gate[k] is not None]
        rows[label] = {"losses": run["losses"], "step_ms": run["step_ms"], "differences": diff, "gate": gate,
                       "fault_readings": faults,
                       "held": all(diff[k] <= gate[k] for k in gated),
                       "gates_below_faults": all(r > gate[k] for k in gated for r in faults.get(k, {}).values())}
        if nm > 1:
            rows[label]["split_parameters"] = len(run["split"])
    for name, runs in nets.items():
        for d in dtypes:
            refs = reference[(name, d)]
            rows[f"unsharded {name} {d}"] = {
                "losses": refs[0]["losses"], "step_ms": refs[0]["step_ms"],
                "other_algorithms": differences(name, refs[1], refs[0]),
                "bf16_vs_float32": differences(name, reference[(name, "bfloat16")][0],
                                               reference[(name, "float32")][0])}
    exact = reference[("vgg-Q", "float64")][0]
    rows["unsharded vgg-Q float64"] = {
        "losses": exact["losses"], "step_ms": exact["step_ms"],
        "float32_vs_float64": {k: v for k, v in differences("vgg-Q", reference[("vgg-Q", "float32")][0],
                                                               exact).items() if k.endswith("_1")}}
    progress("mesh_training", card=smi, steps=MESH_STEPS, spawn_s=spawn_s,
             gates="fixed (MESH_GATES), each below every planted fault's reading; None: printed, not "
                   "gated (ResNet-H's bf16 gradients and updates are held in float32)", **rows)
    # Where vgg-Q's float32 (data 1, model 2) gradients part from the
    # unsharded step's: each leaf against the unsharded float64 step, head
    # first, and the forward's decisions that part (MESH_GATES says why).
    split = {label: run for (label, *_), run in zip(layouts, ranks[0])}
    reading = split_gradient_reading(reference[("vgg-Q", "float32")][0], reference[("vgg-Q", "float64")][0],
                                     split["b_vgg-Q_model2_float32"], split["b_vgg-Q_model2_float64"])
    progress("split_gradient_reading", card=smi, whole=reading["whole"], entry=reading["entry"],
             leaves_unsharded_and_split=[[k, float(f"{u:.3g}"), float(f"{v:.3g}")] for k, u, v in reading["leaves"]],
             decisions_apart={pair: [sum(reading["decisions"][layer][pair][i] for layer in reading["decisions"])
                                     for i in (0, 1)] for pair in next(iter(reading["decisions"].values()))})
    if not all(r.get("held", True) and r.get("gates_below_faults", True) for r in rows.values()):
        raise AssertionError("phase 32 (a)/(b): see the line above")
    if not all(run["split"] for (_, _, _, _, nm), run in zip(layouts, ranks[0]) if nm > 1):
        raise AssertionError("phase 32 (b): no parameter was split over the model axis")
    if any(run["launches"]["warp_kernel"] != len(run["losses"]) for rank in ranks for run in rank):
        raise AssertionError("phase 32 (b): a rank's augmented steps did not each launch the warp kernel")

    return counts


def launch_counter(kernels_of_port):
    """``(counts, add, own)``: launch counts a phase sums, ``add(launches)``
    adds a dict of them, ``own()`` reads this process's counters."""
    counts = {k: 0 for k in kernels_of_port}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    def own():
        return {k: v.launches for k, v in kernels_of_port.items()}

    return counts, add, own


def mesh_cli_pipeline_plots_phase(kernels_of_port, reset_counts, smi, work, frames):
    """Phase 32 (c)-(f): the training CLI on a mesh, the pipelined cascade,
    analyze_training and the plot tools, the dry run.  Returns the kernel
    launches of this process and of the CLI's and the dry run's ranks."""
    from dream_tpu_torch import add_plots, oks_plots
    from dream_tpu_torch.checkpoint import load_flax_checkpoint
    from dream_tpu_torch.cli import analyze_training as analyze_cli
    from dream_tpu_torch.cli import train_network as train_cli
    from dream_tpu_torch.network import DreamNetwork
    from dream_tpu_torch.parallel.dryrun import dryrun_multichip
    from dream_tpu_torch.parallel.pipeline import make_pipeline_mesh, pipeline_multistage_train_step
    from dream_tpu_torch.utils.config import load_yaml
    from dream_tpu_torch.utils.plot import Plot

    counts, add, own = launch_counter(kernels_of_port)
    tmp = work["tmp_dir"].name
    raw, kps = frames["images"], frames["projections"].astype(np.float32)

    # (c) The training CLI on a (data 2) mesh of two gloo ranks on the card,
    # one epoch on the 128-frame set.
    mesh_out = os.path.join(tmp, "train_mesh")
    argv = (["-i", os.path.join(tmp, "train128"), "-m", PANDA, "-ar", VGGQ_ARCH, "-o", mesh_out, "-e", "1",
             "--loss-pos-weight", "50"] + R5_TRAIN_FLAGS + ["--mesh-data", "2", "--dist-backend", "gloo"])
    t0 = time.perf_counter()
    cli_ranks, _ = quiet(train_cli.train_network, train_cli.make_parser().parse_args(argv))
    cli_s = time.perf_counter() - t0
    for rank in cli_ranks:
        add(rank["launches"])
    with open(os.path.join(mesh_out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    n_steps = len(log["batch_training_losses"][0])
    one_rank = os.path.join(tmp, "train_vggq", "best_network.msgpack")

    def layout(path):
        tree = load_flax_checkpoint(path)

        def walk(node, prefix=""):
            for k, v in node.items():
                if isinstance(v, dict):
                    yield from walk(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", tuple(np.shape(v))
        return dict(walk(tree))

    same_layout = layout(os.path.join(mesh_out, "best_network.msgpack")) == layout(one_rank)
    files = sorted(os.listdir(mesh_out))
    progress("training_cli_mesh", seconds=cli_s, files=files, batch_losses=log["batch_training_losses"][0],
             validation_losses=log["batch_validation_losses"][0], same_checkpoint_layout_as_1_rank=same_layout,
             mesh=load_yaml(os.path.join(mesh_out, "epoch_1.yaml"))["training"]["platform"]["mesh"],
             frames_a_rank_a_step=len(log["batch_training_sample_names"][0][0]),
             rank_launches=[r["launches"] for r in cli_ranks])
    if (not same_layout or not np.all(np.isfinite(log["batch_training_losses"][0]))
            or "epoch_1.opt.msgpack" not in files or n_steps == 0
            or len(log["batch_training_sample_names"][0][0]) != 16):
        raise AssertionError("phase 32 (c): see the line above")
    if any(r["launches"]["warp_kernel"] != n_steps for r in cli_ranks):
        raise AssertionError("phase 32 (c): a rank's augmented steps did not each launch the warp kernel")

    # (d) A 2-stage vgg-Q cascade at 400x400 (initial parameters, float32),
    # batch 16 in 4 microbatches on [cuda:0, cuda:0]: pipelined maps and
    # keypoints against the sequential forward's, then one pipelined train
    # step's loss against the sequential criterion.
    cfg = config_in(CONFIG, "float32")
    cfg["architecture"]["n_stages"] = 2
    cascade = DreamNetwork(cfg, device="cuda", seed=0)
    x16 = cascade.preprocess(torch.from_numpy(frames["images"][:16]))
    batch16 = processor_for(cascade, augment=False)(None, torch.from_numpy(raw[:16]).cuda(),
                                                     torch.from_numpy(kps[:16]).cuda())
    reset_counts()
    belief_seq, kp_seq = cascade.inference(x16)
    seq_loss = float(cascade.loss([batch16["image_rgb_input"]], batch16["belief_maps"]))
    stages = cascade.enable_pipeline_inference(4, make_pipeline_mesh(2, ["cuda:0", "cuda:0"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    belief_pipe, kp_pipe = cascade.inference(x16)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    pipe_launches = own()
    add(pipe_launches)
    step, state = pipeline_multistage_train_step(
        cascade.model, None, lambda p: torch.optim.Adam(p, 1e-4), stages, 4,
        cfg["architecture"]["loss"], remat=True)
    state, pipe_loss = step(state, batch16["image_rgb_input"], batch16["belief_maps"])
    pipe_loss = float(pipe_loss)
    map_diff = float((belief_pipe - belief_seq).abs().max())
    same_kp = bool(torch.equal(kp_pipe, kp_seq))
    progress("pipeline", card=smi, stages=[str(d) for d in stages], microbatches=4, batch=16,
             max_abs_map_diff=map_diff, keypoints_equal=same_kp, pipelined_loss=pipe_loss,
             sequential_loss=seq_loss, inference_ms=pipe_ms, launches=pipe_launches)
    if map_diff > 1e-5 or not same_kp or abs(pipe_loss - seq_loss) > 1e-5 * abs(seq_loss) \
            or pipe_launches["score_kernel"] < 2:
        raise AssertionError("phase 32 (d): see the line above")
    del cascade, state, step
    torch.cuda.empty_cache()

    # (e) analyze_training on (c)'s run (loss plot, evaluation through the
    # score kernel), then add_plots and oks_plots on phase 18's CSVs.
    reset_counts()
    analysis_dir = os.path.join(tmp, "analysis_mesh")
    t0 = time.perf_counter()
    quiet(analyze_cli.analyze_training, analyze_cli.make_parser().parse_args(
        ["-i", os.path.join(mesh_out, "best_network.msgpack"), "-o", analysis_dir]))
    analyze_s = time.perf_counter() - t0
    analyze_launches = own()
    add(analyze_launches)
    report = reference_metrics(os.path.join(work["vggq_dir"], "analysis_results.txt"))
    pdf, png = os.path.join(tmp, "pck.pdf"), os.path.join(tmp, "add.png")
    oks_fig, oks_text = quiet(oks_plots.main, ["--data", os.path.join(work["vggq_dir"], "keypoints.csv"),
                                               "--labels", "vgg-Q_r5", "--output", pdf])
    add_fig, add_text = quiet(add_plots.main, ["--data", os.path.join(work["vggq_dir"], "pnp_results.csv"),
                                               "--labels", "vgg-Q_r5", "--output", png])
    pck_auc = float(re.search(r"^auc (\S+)$", oks_text, re.M).group(1))
    add_auc = float(re.search(r"^auc (\S+)$", add_text, re.M).group(1))
    plot_ms = ms_a_call(lambda: Plot.render(add_fig), reps=3)
    with open(pdf, "rb") as f:
        pdf_ok = f.read(8) == b"%PDF-1.4"
    with open(png, "rb") as f:
        png_ok = f.read(8) == b"\x89PNG\r\n\x1a\n"
    progress("plots", analyze_training_s=analyze_s, analyze_files=sorted(os.listdir(analysis_dir)),
             analyze_launches=analyze_launches, pck_auc=pck_auc, report_pck_auc=report["pck_auc"],
             add_auc=add_auc, report_add_auc=report["add_auc"], pdf_written=pdf_ok, png_written=png_ok,
             render_add_plot_host_ms=plot_ms)
    if (abs(pck_auc - report["pck_auc"]) > 5e-6 or abs(add_auc - report["add_auc"]) > 5e-6 or not pdf_ok
            or not png_ok or "train_valid_loss.png" not in os.listdir(analysis_dir)
            or analyze_launches["score_kernel"] < 1):
        raise AssertionError("phase 32 (e): see the line above")

    # (f) dryrun_multichip(2) on the card under gloo.
    t0 = time.perf_counter()
    dry, dry_text = quiet(dryrun_multichip, 2, "cuda", "gloo")
    dry_s = time.perf_counter() - t0
    for rank in dry["ranks"]:
        add(rank["launches"])
    progress("dryrun_multichip", seconds=dry_s, line=dry_text.strip().splitlines()[-1],
             ranks=dry["ranks"], pipeline_loss=dry["pipeline_loss"])
    if not all(np.isfinite(r["loss"]) for r in dry["ranks"]) or not np.isfinite(dry["pipeline_loss"]):
        raise AssertionError("phase 32 (f): see the line above")
    return counts


def multigpu_and_plots_phase(kernels_of_port, reset_counts, smi, work, frames):
    """Phase 32: the multi-GPU layer and the plots on the one card.  Returns
    the kernel launches of this process and of every rank it spawned."""
    steps = mesh_steps_phase(kernels_of_port, reset_counts, smi, frames)
    rest = mesh_cli_pipeline_plots_phase(kernels_of_port, reset_counts, smi, work, frames)
    return {k: steps[k] + rest[k] for k in steps}


def scanned_epochs_phase(kernels_of_port, reset_counts, smi, frames):
    """Phase 33: scanned epochs (one CUDA graph of the fused step, replayed
    for each step) against eager epochs of the same step, for vgg-Q in bf16
    on the r5 recipe's optimizer, ResNet-H in bf16 (its sidecar's optimizer
    and cosine schedule; BatchNorm's running statistics move in the graph)
    and the QAT checkpoint (its sidecar's optimizer), each from one start
    and one seed on phase 6's rendered frames held on the card; then, for
    vgg-Q and ResNet-H, ms a step, the host's launch calls, the device's
    busy share and the peak memory, both ways.  Returns the scanned runs'
    kernel launches."""
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file, dtype_name

    images = torch.from_numpy(frames["images"]).cuda()
    kps = torch.from_numpy(frames["projections"]).float().cuda()
    rng = np.random.RandomState(33)
    matrices = [torch.from_numpy(np.stack([rng.permutation(len(images)) for _ in range(SCAN_STEPS)]))
                .cuda() for _ in range(2)]

    def vggq():
        cfg = config_in(CONFIG)
        cfg["training"]["config"]["optimizer"] = dict(R5_OPTIMIZER)
        return DreamNetwork(cfg, device="cuda", seed=0)

    # (label, build, timed)
    cases = [("vgg-Q bf16 r5 optimizer", vggq, True),
             ("resnet-H bf16", lambda: load_network(RESNETS["resnet-H"][0], seed=0), True),
             ("vgg-Q QAT bf16", lambda: create_network_from_config_file(QAT_CONFIG, QAT_CHECKPOINT,
                                                                        device="cuda"), False)]

    def held(net):
        """Every tensor the steps move: parameters and running statistics,
        the EMA, Adam's moments and per-parameter counts."""
        out = {f"model.{k}": v for k, v in net.model.state_dict().items()}
        out.update({f"ema.{k}": v for k, v in net.ema_params.items()})
        for name, p in net.model.named_parameters():
            out.update({f"adam.{name}.{k}": v for k, v in net.optimizer.state[p].items()})
        return out

    def epoch_ms(run, generator, matrix):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(generator, images, kps, matrix)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / SCAN_STEPS

    launched = {k: 0 for k in kernels_of_port}
    report = {}
    for seed, (label, build, timed) in enumerate(cases, start=33):
        # Bit-equality: two scanned and two eager epochs from one start.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        t0 = time.perf_counter()
        nets = {"scanned": build()}
        nets["eager"] = copy.deepcopy(nets["scanned"])
        build_s = time.perf_counter() - t0
        runs = {}
        for way, net in nets.items():
            net.enable_ema(0.999)
            net.enable_scanned_training(processor_for(net, augment=True))
            run = net.train_epoch_raw if way == "scanned" else net.train_epoch_raw_plain
            g = torch.Generator(device="cuda").manual_seed(seed)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = torch.stack([run(g, images, kps, m) for m in matrices])
            torch.cuda.synchronize()
            runs[way] = {"losses": losses, "seconds": time.perf_counter() - t0,
                         "launches": {k: v.launches for k, v in kernels_of_port.items()},
                         "steps": net.steps, "held": held(net), "generator": g}
        scanned, eager = nets["scanned"], nets["eager"]
        a, b = runs["scanned"], runs["eager"]
        differ = sorted(k for k in a["held"] if not torch.equal(a["held"][k], b["held"][k]))
        failures = []
        if set(a["held"]) != set(b["held"]) or differ:
            failures.append(f"{len(differ)} tensors differ, e.g. {differ[:5]}")
        if not torch.equal(a["losses"], b["losses"]) or not torch.isfinite(a["losses"]).all():
            failures.append(f"losses {a['losses'].tolist()} against {b['losses'].tolist()}")
        counts = {way: sorted({int(v) for k, v in r["held"].items() if k.endswith(".step")})
                  for way, r in runs.items()}
        if not (a["steps"] == b["steps"] == 2 * SCAN_STEPS
                and counts["scanned"] == counts["eager"] == [2 * SCAN_STEPS]):
            failures.append(f"steps {a['steps']}/{b['steps']}, Adam's counts {counts}")
        for way, r in runs.items():
            if r["launches"]["warp_kernel"] != 2 * SCAN_STEPS:
                failures.append(f"{way}: the warp kernel launched {r['launches']['warp_kernel']} times "
                                f"in {2 * SCAN_STEPS} steps")
        if failures:
            raise AssertionError(f"phase 33, {label}: " + "; ".join(failures))
        for k, v in a["launches"].items():
            launched[k] += v
        equality = {"seconds": {way: r["seconds"] for way, r in runs.items()},
                    "launches": {way: r["launches"] for way, r in runs.items()},
                    "losses": a["losses"].tolist(), "tensors": len(a["held"]), "steps": a["steps"]}

        report[label] = {
            "compute_dtype": dtype_name(scanned.compute_dtype),
            "optimizer": scanned.network_config["training"]["config"]["optimizer"],
            "bit_equal": "losses, parameters, running statistics, EMA, Adam's moments and counts",
            "build_s": build_s, "equality_runs": equality}
        torch.backends.cudnn.deterministic = False
        g = a["generator"]
        del nets, eager, runs, a, b
        torch.cuda.empty_cache()
        if not timed:
            del scanned
            torch.cuda.empty_cache()
            continue
        # Times under cuDNN's default choices: the scanned epochs (a warm-up
        # epoch captures anew), then the same network's eager epochs.
        torch.cuda.reset_peak_memory_stats()
        scanned.train_epoch_raw(g, images, kps, matrices[0])
        scanned_ms = [epoch_ms(scanned.train_epoch_raw, g, matrices[i % 2]) for i in range(3)]
        counted = kernels_of_port["warp_kernel"].launches
        scanned_profile = profile_busy(lambda: scanned.train_epoch_raw(g, images, kps, matrices[1]), top=3,
                                       kernels=("warp_kernel",))
        counted = kernels_of_port["warp_kernel"].launches - counted
        scanned_peak = torch.cuda.max_memory_allocated() / 2**30
        scanned.release_scanned_graph()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scanned.train_epoch_raw_plain(g, images, kps, matrices[0])
        eager_ms = [epoch_ms(scanned.train_epoch_raw_plain, g, matrices[i % 2]) for i in range(3)]
        eager_profile = profile_busy(lambda: scanned.train_epoch_raw_plain(g, images, kps, matrices[1]),
                                     top=3, kernels=("warp_kernel",))
        eager_peak = torch.cuda.max_memory_allocated() / 2**30
        # The counter's replays against the device's own count: profile_busy
        # runs the epoch twice, the second under the profiler, whose trace
        # sees each kernel a replay runs.
        warp_runs = {"counted_in_two_scanned_epochs": counted,
                     "scanned_device": scanned_profile["kernel_runs"]["warp_kernel"],
                     "eager_device": eager_profile["kernel_runs"]["warp_kernel"]}
        if not (counted == 2 * SCAN_STEPS and warp_runs["scanned_device"] == warp_runs["eager_device"]
                == SCAN_STEPS):
            raise AssertionError(f"phase 33, {label}: warp kernel runs {warp_runs}, not one a step "
                                 f"({SCAN_STEPS} an epoch)")
        report[label].update({
            "ms_a_step": {"scanned": scanned_ms, "eager": eager_ms,
                          "scanned_median": float(np.median(scanned_ms)),
                          "eager_median": float(np.median(eager_ms))},
            "host_launch_calls_an_epoch": {"scanned": scanned_profile["host_launch_calls"],
                                           "eager": eager_profile["host_launch_calls"]},
            "host_calls_an_epoch": {"scanned": scanned_profile["host_calls"],
                                    "eager": eager_profile["host_calls"]},
            "device_busy_share_profiled": {"scanned": 1 - scanned_profile["device_idle_share_profiled"],
                                           "eager": 1 - eager_profile["device_idle_share_profiled"]},
            "device_launches_an_epoch": {"scanned": scanned_profile["device_launches"],
                                         "eager": eager_profile["device_launches"]},
            "wall_ms_an_epoch_profiled": {"scanned": scanned_profile["wall_ms_profiled"],
                                          "eager": eager_profile["wall_ms_profiled"]},
            "peak_gib": {"scanned": scanned_peak, "eager": eager_peak},
            "warp_kernel_runs": warp_runs,
        })
        del scanned
        torch.cuda.empty_cache()
    progress("scanned_epochs", card=smi, steps_an_epoch=SCAN_STEPS, batch=TRAIN_BATCH,
             frames=len(images), cases=report)
    return launched


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file, dtype_name
    from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes, run_int8_chain
    from dream_tpu_torch.ops import cuda_build
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel, conv3x3_int8_plain, conv3x3_int32_plain
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain
    from dream_tpu_torch.ops.warp import inverse_affines, warp_batch_kernel, warp_batch_plain

    kernels_of_port = {"score_kernel": score_maps_kernel, "warp_kernel": warp_batch_kernel,
                       "conv_int8_kernel": conv3x3_int8_kernel}

    def reset_counts():
        for kernel in kernels_of_port.values():
            kernel.launches = 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    progress("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0))

    # 2. Build the kernels, one nvcc each, in parallel.
    t0 = time.perf_counter()
    libs = cuda_build.build_all(list(kernels_of_port), verbose=True)
    build_s = time.perf_counter() - t0
    for kernel in kernels_of_port.values():
        kernel.load()
    progress("build", seconds=round(build_s, 3),
             libraries={k: os.path.relpath(str(v), ROOT) for k, v in libs.items()},
             ptxas={k: list(cuda_build.ptxas_report(k).values()) for k in libs})

    # 3. Score kernel vs plain on the card.
    rng = np.random.RandomState(0)
    errors = {}
    for n, h, w in ((448, 100, 100), (112, 100, 100), (14, 400, 400), (21, 37, 53)):
        err, peaks = compare_kernel(random_maps(rng, n, h, w))
        errors[f"{n}x{h}x{w}"] = {"max_abs_err": err, "peaks": peaks}
    score_err = max(e["max_abs_err"] for e in errors.values())
    progress("score_kernel_vs_plain", shapes=errors)

    # 4. Warp kernel vs plain on the card.
    warp_errors = {}
    for (n, h, w), kind in [((TRAIN_BATCH, 400, 400), "random"), ((TRAIN_BATCH, 400, 400), "extreme"),
                            ((TRAIN_BATCH, 400, 400), "multifold"), ((TRAIN_BATCH, 400, 400), "identity"),
                            ((3, 37, 53), "random"), ((3, 37, 53), "multifold")]:
        images, affines = warp_inputs(n, h, w, kind, seed=len(warp_errors))
        warp_errors[f"{n}x{h}x{w}x3 {kind}"] = compare_warp(images, affines, kind == "identity")
    warp_err = max(warp_errors.values())
    progress("warp_kernel_vs_plain", max_abs_err=warp_errors, bound=WARP_ATOL)

    # 5. The evaluation path.
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    network = load_network(CONFIG, CHECKPOINT, "float32")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    holdout = generate_synthetic_frames(64, (640, 480), network.keypoint_names, seed=99)
    render_s = time.perf_counter() - t0
    gt = {"projections": holdout["projections"], "positions": holdout["positions"]}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if eval_launches["score_kernel"] <= 0:
        raise AssertionError("the evaluation path did not launch the score kernel")

    ref = reference_metrics(REFERENCE)
    measured, failures = eval_bounds(result, ref)
    progress("evaluation_path", seconds=round(eval_s, 3), load_s=round(load_s, 3),
             render_s=round(render_s, 3), launches=eval_launches, measured=measured,
             reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
    if failures:
        raise AssertionError("evaluation path misses its bounds: " + "; ".join(failures))

    # 6. The training path, at full width and batch 32.
    t0 = time.perf_counter()
    frames = generate_synthetic_frames(TRAIN_BATCH, (640, 480), network.keypoint_names, seed=0)
    train_render_s = time.perf_counter() - t0
    raw = torch.from_numpy(frames["images"]).cuda()
    kp_raw = torch.from_numpy(frames["projections"]).float().cuda()
    trainer = DreamNetwork(config_in(CONFIG, "float32"), device="cuda", seed=0)
    tcfg = trainer.network_config["training"]["config"]
    processor_args = (tuple(tcfg["image_raw_resolution"]), trainer.trained_net_input_resolution(),
                      trainer.trained_net_output_resolution(), trainer.image_preprocessing(),
                      trainer.image_normalization)
    augmenting = make_batch_processor(*processor_args, augment=True)
    trainer.enable_ema(0.999)
    trainer.enable_fused_training(augmenting)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generator = torch.Generator(device="cuda").manual_seed(0)
    losses = [trainer.train_raw(generator, raw, kp_raw) for _ in range(AUGMENTED_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {k: v.launches for k, v in kernels_of_port.items()}
    losses = [float(x) for x in losses]
    if train_launches["warp_kernel"] != AUGMENTED_STEPS:
        raise AssertionError(f"the warp kernel launched {train_launches['warp_kernel']} times "
                             f"in {AUGMENTED_STEPS} augmented steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")

    fixed = make_batch_processor(*processor_args, augment=False)
    trainer.enable_fused_training(fixed)
    fixed_losses = [float(trainer.train_raw(None, raw, kp_raw)) for _ in range(FIXED_BATCH_STEPS)]
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"the fixed-batch run did not lower the loss: {fixed_losses}")

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    snap = snapshot(trainer)
    step_results = {}
    for backend in ("auto", "plain"):
        restore(trainer, snap)
        trainer.enable_fused_training(make_batch_processor(*processor_args, augment=True,
                                                           warp_backend=backend))
        g = torch.Generator(device="cuda").manual_seed(7)
        step_results[backend] = (float(trainer.train_raw(g, raw, kp_raw)),
                                 copy.deepcopy(trainer.model.state_dict()))
    (loss_k, state_k), (loss_p, state_p) = step_results["auto"], step_results["plain"]
    step_param_diff = max(float((state_k[n] - state_p[n]).abs().max()) for n in state_k)
    if not abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"kernel step loss {loss_k} vs plain step loss {loss_p}")

    with tempfile.TemporaryDirectory() as tmp:
        trainer.save_network(tmp, "smoke")
        reloaded = create_network_from_config_file(
            os.path.join(tmp, "smoke.yaml"), os.path.join(tmp, "smoke.msgpack"), device="cuda")
    saved_state, reloaded_state = trainer.model.state_dict(), reloaded.model.state_dict()
    if set(saved_state) != set(reloaded_state) or not all(
            torch.equal(saved_state[k], reloaded_state[k]) for k in saved_state):
        raise AssertionError("the reloaded checkpoint's parameters differ from the saved ones")
    x = trainer.preprocess(raw[:4])
    if not torch.equal(trainer.inference(x)[0], reloaded.inference(x)[0]):
        raise AssertionError("the reloaded network's belief maps differ")
    torch.backends.cudnn.deterministic = False
    progress("training_path", seconds=round(train_s, 3), render_s=round(train_render_s, 3),
             launches=train_launches, augmented_losses=losses, fixed_batch_losses=fixed_losses,
             kernel_vs_plain_step={"loss_kernel": loss_k, "loss_plain": loss_p,
                                   "max_param_diff": step_param_diff},
             checkpoint_round_trip="bit-equal")

    # 7. Timings.
    maps = random_maps(rng, 112, 100, 100)
    maps_f = random_maps(rng, 14, 400, 400)
    score_ms = [cuda_ms(lambda: score_maps_kernel(maps), 50) for _ in range(2)]
    score_plain_ms = [cuda_ms(lambda: score_maps_plain(maps), 50) for _ in range(2)]
    score_device_ms = [graph_ms(lambda: score_maps_kernel(maps)) for _ in range(2)]
    score_f_device_ms = [graph_ms(lambda: score_maps_kernel(maps_f)) for _ in range(2)]
    score_bound, score_bound_by = kernel_bound_ms(112, 100, 100)
    score_f_bound, _ = kernel_bound_ms(14, 400, 400)
    x = network.preprocess(torch.from_numpy(holdout["images"][:16]))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: network.model(x), 5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    images, affines = warp_inputs(TRAIN_BATCH, 400, 400, "random", seed=99)
    inverse = inverse_affines(affines)
    nchw = images.permute(0, 3, 1, 2).contiguous()
    grid_sample = grid_sample_warp(nchw, inverse)
    grid_diff = float((grid_sample().permute(0, 2, 3, 1) - warp_batch_kernel(images, affines)).abs().max())
    # The kernel on a given inverse is what F.grid_sample is timed on (and
    # what the TPU kernel is handed); the wrapper adds the batched inverse.
    warp_ms, warp_launch_ms, warp_plain_ms, grid_ms = [], [], [], []
    warp_device_ms, grid_device_ms = [], []
    for _ in range(2):  # wrapper, kernel, plain, library, in turns
        warp_ms.append(cuda_ms(lambda: warp_batch_kernel(images, affines), 20))
        warp_launch_ms.append(cuda_ms(lambda: warp_batch_kernel.launch(images, inverse), 20))
        warp_device_ms.append(graph_ms(lambda: warp_batch_kernel.launch(images, inverse), 20))
        warp_plain_ms.append(cuda_ms(lambda: warp_batch_plain(images, affines), 10))
        grid_ms.append(cuda_ms(grid_sample, 20))
        grid_device_ms.append(graph_ms(grid_sample, 20))
    warp_bound, warp_bound_by = warp_bound_ms(TRAIN_BATCH, 400, 400, 3)

    trainer.enable_fused_training(augmenting)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_raw(generator, raw, kp_raw), 3, warmup=1)
    peak_bytes = torch.cuda.max_memory_allocated()
    processor_ms = cuda_ms(lambda: augmenting(generator, raw, kp_raw), 5, warmup=1)
    batch = augmenting(generator, raw, kp_raw)
    update_ms = cuda_ms(lambda: trainer.train([batch["image_rgb_input"]], batch["belief_maps"]),
                        3, warmup=1)
    x32, target = batch["image_rgb_input"].permute(0, 3, 1, 2), batch["belief_maps"]
    with torch.no_grad():
        forward_b32_ms = cuda_ms(lambda: trainer.model(x32), 3, warmup=1)

    def forward_backward():
        trainer.model.zero_grad(set_to_none=True)
        trainer.criterion(trainer.model(x32), target).backward()

    forward_backward_ms = cuda_ms(forward_backward, 3, warmup=1)
    step_profile = profile_busy(lambda: trainer.train_raw(generator, raw, kp_raw))
    timings = {
        "card": smi,
        "score_kernel_device_ms": score_device_ms,
        "score_kernel_ms": score_ms,
        "score_plain_ms": score_plain_ms,
        "score_bound_ms": score_bound,
        "score_share_of_bound": score_bound / min(score_device_ms),
        "score_kernel_14x400x400_device_ms": score_f_device_ms,
        "score_14x400x400_bound_ms": score_f_bound,
        "score_14x400x400_share_of_bound": score_f_bound / min(score_f_device_ms),
        "model_forward_b16_ms": forward_ms,
        "eval_loop_frames_per_s": 64 / loop_s,
        "eval_loop_s": loop_s,
        "warp_wrapper_with_inverse_ms": warp_ms,
        "warp_kernel_device_ms": warp_device_ms,
        "warp_kernel_launch_only_ms": warp_launch_ms,
        "warp_plain_ms": warp_plain_ms,
        "warp_grid_sample_ms": grid_ms,
        "warp_grid_sample_device_ms": grid_device_ms,
        "warp_grid_sample_max_abs_diff": grid_diff,
        "warp_bound_ms": warp_bound,
        "warp_share_of_bound": warp_bound / min(warp_device_ms),
        "train_step_ms": step_ms,
        "train_images_per_s": TRAIN_BATCH / step_ms * 1e3,
        "train_batch_processor_ms": processor_ms,
        "train_forward_backward_optimizer_ms": update_ms,
        "train_forward_b32_no_grad_ms": forward_b32_ms,
        "train_forward_backward_ms": forward_backward_ms,
        "train_peak_memory_gib": peak_bytes / 2**30,
        "train_step_profile": step_profile,
    }
    progress("timings", **timings)

    # 8. int8 conv kernel vs plain on the card, bit for bit.
    gen = torch.Generator(device="cuda").manual_seed(8)
    conv_cases = {}
    for b, h, w, ci, co, relu in chain_shapes(2):
        for r in sorted({relu, False}, reverse=True):
            conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={r}"] = compare_conv_int8(
                *int8_case(gen, b, h, w, ci, co), r)[1]
    for b, h, w, ci, co, relu in [(1, 25, 50, 64, 64, True), (3, 7, 9, 32, 8, False),
                                  (2, 33, 17, 96, 200, True), (1, 1, 1, 32, 8, False),
                                  (1, 26, 51, 64, 264, True), (4, 50, 50, 64, 200, False)]:
        conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={relu}"] = compare_conv_int8(
            *int8_case(gen, b, h, w, ci, co), relu)[1]
    x_q, w1, k1, b1 = int8_case(gen, 2, 50, 50, 256, 512)
    _, w2, k2, b2 = int8_case(gen, 2, 50, 50, 512, 256)
    mid = compare_conv_int8(x_q, w1, k1, b1, True)[0]
    out = compare_conv_int8(mid, w2, k2, b2, False)[0]
    want = conv3x3_int8_plain(conv3x3_int8_plain(x_q, w1, k1, b1), w2, k2, b2, False)
    chain_diff = int((out.to(torch.int32) - want.to(torch.int32)).abs().max())
    if chain_diff != 0:
        raise AssertionError("the two-link int8 chain differs from two plain convs")
    conv_cases["two-link chain 2x50x50x256->512->256"] = chain_diff
    progress("conv_int8_kernel_vs_plain", max_abs_err=conv_cases)

    # 9. The int8 evaluation path on the phase-5 holdout, in the sidecars'
    # bf16 (the int8 chain's head and down1 prologue).
    def evaluate(net, name, calibration_frames, reference=None, phase="int8_evaluation",
                 outframe_tol=0, min_pnp=56):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_frames(net, holdout["images"], gt, holdout["camera_K"], batch_size=16,
                              int8_calibration_frames=calibration_frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels_of_port.items()}
        ref = reference_metrics(os.path.join(ROOT, reference or INT8_REFERENCES[name]))
        measured, failures = eval_bounds(res, ref, outframe_tol, min_pnp)
        progress(phase, run=name, compute_dtype=dtype_name(net.compute_dtype),
                 seconds=round(seconds, 3), launches=launches, measured=measured,
                 reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
        n_batches = -(-len(holdout["images"]) // 16)
        if calibration_frames and launches["conv_int8_kernel"] != 19 * n_batches:
            failures.append(f"the conv kernel launched {launches['conv_int8_kernel']} times, "
                            f"not 19 for each of {n_batches} batches")
        if not calibration_frames and launches["conv_int8_kernel"] != 0:
            failures.append("the float evaluation launched the int8 conv kernel")
        if launches["score_kernel"] != n_batches:
            failures.append(f"the score kernel launched {launches['score_kernel']} times, "
                            f"not once for each of {n_batches} batches")
        if failures:
            raise AssertionError(f"{name} evaluation misses its bounds: " + "; ".join(failures))
        return launches

    r4 = create_network_from_config_file(R4_CONFIG, R4_CHECKPOINT, device="cuda")
    if r4.compute_dtype != torch.bfloat16:
        raise AssertionError("the r4 sidecar's bfloat16 did not reach the network")
    evaluate(r4, "float_r4", 0)
    evaluate(r4, "ptq_r4", CALIBRATION_FRAMES)
    x16 = r4.preprocess(torch.from_numpy(holdout["images"][:16]))
    with torch.no_grad():
        float_maps = r4.model(x16.permute(0, 3, 1, 2))
    int8_maps = r4.inference(x16)[0]
    corr = map_correlation(int8_maps, float_maps)
    if not corr >= 0.99:
        raise AssertionError(f"PTQ belief maps correlate with the float maps at {corr} (< 0.99)")
    progress("int8_fidelity", belief_map_correlation=corr)
    qat = create_network_from_config_file(QAT_CONFIG, QAT_CHECKPOINT, device="cuda")
    if qat.quant_mode != "qat":
        raise AssertionError("the QAT sidecar did not build a QAT network")
    evaluate(qat, "ptq_qat", CALIBRATION_FRAMES)

    # 10. QAT training steps from the QAT checkpoint.
    qat.enable_fused_training(augmenting)
    reset_counts()
    qat_generator = torch.Generator(device="cuda").manual_seed(10)
    qat_losses = [float(qat.train_raw(qat_generator, raw, kp_raw)) for _ in range(QAT_STEPS)]
    qat_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if not all(np.isfinite(qat_losses)):
        raise AssertionError(f"non-finite QAT loss: {qat_losses}")
    if qat_launches["warp_kernel"] != QAT_STEPS:
        raise AssertionError(f"the warp kernel launched {qat_launches['warp_kernel']} times "
                             f"in {QAT_STEPS} QAT steps")
    progress("qat_training", losses=qat_losses, launches=qat_launches)

    # 11. The kernel at the main path's shapes (B=16), bit for bit, and
    # int8 timings there.
    shapes16 = chain_shapes(16)
    link_ms, link_plain_ms, link_library_ms, link_library_im2col_ms = [], [], [], []
    library_note = ("torch._int_mm on [B*H*W, 9*Ci] x [9*Ci, Co]; link_library_ms: im2col built "
                    "beforehand, not timed; link_library_im2col_ms: im2col built in the timing")
    for b, h, w, ci, co, relu in shapes16:
        x_q, w_q, k, bias = int8_case(gen, b, h, w, ci, co)
        conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={relu}"] = compare_conv_int8(x_q, w_q, k, bias, relu)[1]
        link_ms.append(min(cuda_ms(lambda: conv3x3_int8_kernel(x_q, w_q, k, bias, relu), 10)
                           for _ in range(2)))
        link_plain_ms.append(cuda_ms(lambda: conv3x3_int8_plain(x_q, w_q, k, bias, relu), 2, warmup=1))
        # The yardstick, which the port never calls: one int8 GEMM.
        cols = im2col_int8(x_q)
        w_kn = w_q.reshape(co, 9 * ci).t()  # column-major [9*Ci, Co]
        if not torch.equal(torch._int_mm(cols, w_kn), conv3x3_int32_plain(x_q, w_q).reshape(-1, co)):
            raise AssertionError(f"torch._int_mm differs from the exact accumulator at {b}x{h}x{w}x{ci}->{co}")
        link_library_ms.append(cuda_ms(lambda: torch._int_mm(cols, w_kn), 10))
        del cols
        link_library_im2col_ms.append(cuda_ms(lambda: torch._int_mm(im2col_int8(x_q), w_kn), 10))
    progress("conv_int8_kernel_vs_plain_b16", max_abs_err={k: v for k, v in conv_cases.items()
                                                           if k.startswith("16x")})
    conv_bound, conv_bound_by, chain_ops = conv_int8_bound_ms(shapes16)
    chain_ms, chain_plain_ms, chain_library_ms = sum(link_ms), sum(link_plain_ms), sum(link_library_ms)
    chain_library_im2col_ms = sum(link_library_im2col_ms)
    with torch.no_grad():
        int8_forward_ms = [cuda_ms(lambda: run_int8_chain(r4.int8_chain, x16), 5, warmup=2)
                           for _ in range(2)]
        # The float model, in the sidecar's compute dtype.
        float_forward_ms = [cuda_ms(lambda: r4.model(x16.permute(0, 3, 1, 2)), 5, warmup=2)
                            for _ in range(2)]
        int8_forward_profile = profile_busy(lambda: run_int8_chain(r4.int8_chain, x16), top=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(r4, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    int8_loop_s = time.perf_counter() - t0
    progress("int8_timings", link_ms=link_ms, link_plain_ms=link_plain_ms,
             link_library_ms=link_library_ms, link_library_im2col_ms=link_library_im2col_ms,
             library=library_note, chain_ms=chain_ms, chain_plain_ms=chain_plain_ms,
             chain_library_ms=chain_library_ms, chain_library_im2col_ms=chain_library_im2col_ms,
             chain_bound_ms=conv_bound, chain_bound_by=conv_bound_by, chain_gop=chain_ops / 1e9,
             chain_tops=chain_ops / chain_ms / 1e9,
             link_shapes=[list(shape) for shape in shapes16],
             link_tops=[2 * 9 * b * h * w * ci * co / ms / 1e9
                        for (b, h, w, ci, co, _), ms in zip(shapes16, link_ms)],
             int8_forward_b16_ms=int8_forward_ms, float_forward_b16_ms=float_forward_ms,
             float_forward_dtype=dtype_name(r4.compute_dtype),
             int8_forward_b16_profile=int8_forward_profile,
             int8_eval_loop_s=int8_loop_s, int8_eval_loop_frames_per_s=64 / int8_loop_s)

    # The conv kernel's limits at the main path's shapes.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = cuda_build.ptxas_report("conv_int8_kernel")
    link_limits, by_map = [], {}
    for (b, h, w, ci, co, relu), ms in zip(shapes16, link_ms):
        plan = conv3x3_int8_kernel.plan(b, h, w, ci, co, sms)
        built = next(v for k, v in ptxas.items() if f"wgmmaILi{plan.bn}ELi{plan.bk}EE" in k)
        link_bound = conv_int8_bound_ms([(b, h, w, ci, co, relu)])[0]
        link_limits.append({"link": [b, h, w, ci, co], "tile_th_tw_bn_bk": [plan.th, plan.tw, plan.bn, plan.bk],
                            "stages": plan.stages, "tiles": plan.tiles, "blocks": plan.blocks,
                            "dynamic_smem": plan.smem, **built, "ms": ms, "bound_ms": link_bound,
                            "share_of_bound": link_bound / ms})
        ops, t = by_map.get(h, (0, 0.0))
        by_map[h] = (ops + 2 * 9 * b * h * w * ci * co, t + ms)
    progress("conv_int8_limits", card=smi, sms=sms, links=link_limits,
             chain_share_of_bound=conv_bound / chain_ms,
             tops_by_map={f"{h}x{h}": ops / t / 1e9 for h, (ops, t) in sorted(by_map.items())},
             ms_by_map={f"{h}x{h}": t for h, (_, t) in sorted(by_map.items())})

    # 12. vgg-Q r5 in its sidecar's bf16 on the phase-5 holdout.
    vggq16 = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    if vggq16.compute_dtype != torch.bfloat16:
        raise AssertionError("the r5 sidecar's bfloat16 did not reach the network")
    evaluate(vggq16, "vgg-Q r5", 0, REFERENCE, phase="bf16_evaluation")
    del vggq16

    # 13. vgg-F r5 in bf16 and float32 against its report, then augmented
    # train steps from its sidecar with the port's initial parameters.
    vggf_loop_s = {}
    for dtype in ("bfloat16", "float32"):
        vggf = load_network(VGGF_CONFIG, VGGF_CHECKPOINT, dtype)
        evaluate(vggf, f"vgg-F r5 {dtype}", 0, VGGF_REFERENCE, phase="vggf_evaluation",
                 outframe_tol=2, min_pnp=57)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_frames(vggf, holdout["images"], gt, holdout["camera_K"], batch_size=16)
        torch.cuda.synchronize()
        vggf_loop_s[dtype] = time.perf_counter() - t0
        del vggf
    vggf_trainer = load_network(VGGF_CONFIG, seed=0)
    vggf_trainer.enable_fused_training(processor_for(vggf_trainer, augment=True))
    reset_counts()
    g = torch.Generator(device="cuda").manual_seed(13)
    vggf_losses = [float(vggf_trainer.train_raw(g, raw, kp_raw)) for _ in range(AUGMENTED_STEPS)]
    vggf_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if not all(np.isfinite(vggf_losses)):
        raise AssertionError(f"non-finite vgg-F training loss: {vggf_losses}")
    if vggf_launches["warp_kernel"] != AUGMENTED_STEPS:
        raise AssertionError(f"the warp kernel launched {vggf_launches['warp_kernel']} times in "
                             f"{AUGMENTED_STEPS} vgg-F steps")
    progress("vggf_training", compute_dtype=dtype_name(vggf_trainer.compute_dtype),
             losses=vggf_losses, launches=vggf_launches,
             eval_loop_frames_per_s={k: 64 / v for k, v in vggf_loop_s.items()})
    del vggf_trainer

    # 14. ResNet-H and ResNet-F at full width from their sidecars (bf16),
    # with the port's initial parameters.
    x16_raw = torch.from_numpy(holdout["images"][:16])
    for arch, (config, side) in RESNETS.items():
        net = load_network(config, seed=0)
        if net.compute_dtype != torch.bfloat16 or net.trained_net_output_resolution() != (side, side):
            raise AssertionError(f"{arch}: {net.compute_dtype}, {net.trained_net_output_resolution()}")

        def running():
            return {k: v.clone() for k, v in net.model.state_dict().items() if "running_" in k}

        # The fixed-batch run starts from the initial parameters: after a few
        # augmented steps, the r5 recipe (Adam at 2e-4, no warmup) lifts
        # ResNet-F's loss on a fixed batch for several steps before it
        # falls, in float32 as in bf16, and in dream_tpu as in the port
        # (tests/test_torch_arch_network.py, slow).
        fixed = processor_for(net, augment=False)
        net.enable_fused_training(fixed)
        fixed_losses = [float(net.train_raw(None, raw, kp_raw)) for _ in range(FIXED_BATCH_STEPS)]
        if not fixed_losses[-1] < fixed_losses[0]:
            raise AssertionError(f"{arch}: the fixed-batch run did not lower the loss: {fixed_losses}")
        net.enable_fused_training(processor_for(net, augment=True))
        start = running()
        reset_counts()
        g = torch.Generator(device="cuda").manual_seed(14)
        losses = [float(net.train_raw(g, raw, kp_raw)) for _ in range(AUGMENTED_STEPS)]
        launches = {k: v.launches for k, v in kernels_of_port.items()}
        if not all(np.isfinite(losses)) or launches["warp_kernel"] != AUGMENTED_STEPS:
            raise AssertionError(f"{arch}: losses {losses}, launches {launches}")
        trained = running()
        unmoved = [k for k in start if torch.equal(start[k], trained[k])]
        if unmoved:
            raise AssertionError(f"{arch}: train steps left {len(unmoved)} running statistics as they were")
        batch = fixed(None, raw[:16], kp_raw[:16])
        eval_loss = float(net.loss([batch["image_rgb_input"]], batch["belief_maps"]))
        x16 = net.preprocess(x16_raw)
        net.inference(x16)
        if any(not torch.equal(v, trained[k]) for k, v in running().items()):
            raise AssertionError(f"{arch}: loss or inference moved the running statistics")

        torch.backends.cudnn.deterministic = True
        with tempfile.TemporaryDirectory() as tmp:
            net.save_network(tmp, "smoke")
            reloaded = create_network_from_config_file(
                os.path.join(tmp, "smoke.yaml"), os.path.join(tmp, "smoke.msgpack"), device="cuda")
        saved, back = net.model.state_dict(), reloaded.model.state_dict()
        if set(saved) != set(back) or not all(torch.equal(saved[k], back[k]) for k in saved):
            raise AssertionError(f"{arch}: the reloaded parameters or buffers differ")
        if reloaded.compute_dtype != torch.bfloat16:
            raise AssertionError(f"{arch}: the saved sidecar lost the compute dtype")
        reset_counts()
        belief, keypoints = net.inference(x16)
        infer_launches = {k: v.launches for k, v in kernels_of_port.items()}
        if not torch.equal(belief, reloaded.inference(x16)[0]):
            raise AssertionError(f"{arch}: the reloaded network's belief maps differ")
        torch.backends.cudnn.deterministic = False
        del reloaded
        if tuple(belief.shape) != (16, 7, side, side) or infer_launches["score_kernel"] != 1:
            raise AssertionError(f"{arch}: maps {tuple(belief.shape)}, launches {infer_launches}")
        net32 = DreamNetwork(config_in(config, "float32"), device="cuda")
        net32.model.load_state_dict(saved, strict=True)
        belief32, _ = net32.inference(x16)
        corr = map_correlation(belief32, belief)
        if not corr >= 0.99:
            raise AssertionError(f"{arch}: float32 and bf16 maps correlate at {corr} (< 0.99)")
        progress("resnet", arch=arch, compute_dtype=dtype_name(net.compute_dtype),
                 augmented_losses=losses, launches=launches, eval_loss=eval_loss,
                 running_statistics=len(start), fixed_batch_losses=fixed_losses,
                 checkpoint_round_trip="bit-equal, parameters and buffers",
                 inference_maps=list(belief.shape), inference_launches=infer_launches,
                 keypoints_found=int((keypoints[..., 0] > -999).sum()),
                 float32_vs_bf16_map_correlation=corr)
        del net, net32, belief, belief32
        torch.cuda.empty_cache()

    # 15. The score kernel at this slice's map sizes: held against its plain
    # version, and its device time against its bound.
    score_shapes = {}
    for n, h, w in ((112, 400, 400), (112, 208, 208), (112, 416, 416)):
        shape_maps = random_maps(rng, n, h, w)
        err, peaks = compare_kernel(shape_maps)
        device_ms = [graph_ms(lambda: score_maps_kernel(shape_maps), 20) for _ in range(2)]
        bound, bound_by = kernel_bound_ms(n, h, w)
        score_shapes[f"{n}x{h}x{w}"] = {"max_abs_err": err, "peaks": peaks, "device_ms": device_ms,
                                        "bound_ms": bound, "bound_by": bound_by,
                                        "share_of_bound": bound / min(device_ms)}
        score_err = max(score_err, err)
        del shape_maps
    progress("score_kernel_new_shapes", card=smi, shapes=score_shapes)

    # 16. Forward and train-step times of the four networks in float32 and
    # bf16 (port initial parameters), peak memory, and one bf16 step under
    # torch.profiler.
    arch_timings = {}
    for arch, config in (("vgg-Q", CONFIG), ("vgg-F", VGGF_CONFIG), ("resnet-H", RESNETS["resnet-H"][0]),
                         ("resnet-F", RESNETS["resnet-F"][0])):
        for dtype in ("float32", "bfloat16"):
            net = load_network(config, compute_dtype=dtype, seed=0)
            x = net.preprocess(x16_raw).permute(0, 3, 1, 2)
            with torch.no_grad():
                forward_ms = cuda_ms(lambda: net.model(x), 3, warmup=2)
            net.enable_fused_training(processor_for(net, augment=True))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_ms(lambda: net.train_raw(generator, raw, kp_raw), 3, warmup=1)
            row = {"forward_b16_ms": forward_ms, "train_step_b32_ms": step_ms,
                   "train_images_per_s": TRAIN_BATCH / step_ms * 1e3,
                   "train_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
            if dtype == "bfloat16":
                row["train_step_profile"] = profile_busy(
                    lambda: net.train_raw(generator, raw, kp_raw), top=6)
            arch_timings[f"{arch} {dtype}"] = row
            del net, x
            torch.cuda.empty_cache()
    progress("architecture_timings", card=smi, batch_forward=16, batch_train=TRAIN_BATCH,
             timings=arch_timings)

    # 17-20. The command-line workflow on disk.
    workflow = workflow_phases(kernels_of_port, reset_counts, smi, holdout)
    progress("workflow_vs_in_memory", card=smi,
             train_cli_steady_images_per_s=workflow["timings"]["train_cli_images_per_s"][1],
             train_raw_bf16_images_per_s=arch_timings["vgg-Q bfloat16"]["train_images_per_s"],
             train_raw_f32_images_per_s=TRAIN_BATCH / step_ms * 1e3,
             eval_cli_frames_per_s=workflow["timings"]["eval_cli_frames_per_s"],
             eval_in_memory_frames_per_s=workflow["timings"]["eval_in_memory_frames_per_s"])

    # 21-24. The pose server and the torch.export artifacts.
    serving = serving_phases(kernels_of_port, reset_counts, smi, workflow["work"])

    # 25-29. The int8 graphs of vgg-F and the ResNets, the soft-argmax head
    # and DOPE.
    zoo_score_launches = zoo_phases(kernels_of_port, reset_counts, smi, workflow["work"],
                                    torch.Generator(device="cuda").manual_seed(25))

    # 30. The visualization layer and what waits on it.
    viz_launches = visualization_phase(kernels_of_port, reset_counts, smi, workflow["work"],
                                       serving["live"])

    # 31. The image loader, JPEG frames, encoder pretraining and the
    # workflow's remaining tools.
    tools_launches = jpeg_and_tools_phase(kernels_of_port, reset_counts, smi, workflow["work"],
                                          serving["live"]["server"].network)

    # 32. The multi-GPU layer and the plots.
    mesh_launches = multigpu_and_plots_phase(kernels_of_port, reset_counts, smi, workflow["work"], frames)
    workflow["work"]["tmp_dir"].cleanup()

    # 33. Scanned epochs: the fused step as one CUDA graph, replayed.
    scan_launches = scanned_epochs_phase(kernels_of_port, reset_counts, smi, frames)
    launched = {k: workflow["launches"][k] + serving["launches"].get(k, 0) + viz_launches[k]
                + tools_launches[k] + mesh_launches[k] + scan_launches[k] for k in workflow["launches"]}
    launched["score_kernel"] += zoo_score_launches
    score_err = max(score_err, serving["max_abs_err"]["score_kernel"])
    conv_cases["serving chain links at B=1"] = serving["max_abs_err"]["conv_int8_kernel"]

    kernels = [{
        "name": "score_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/score_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_kernels.py:40",
        "launches": launched["score_kernel"],
        "max_abs_err": score_err,
        "ms": min(score_device_ms),
        "plain_ms": min(score_plain_ms),
        "bound_ms": score_bound,
        "bound_by": score_bound_by,
        "library_ms": None,
        "device_ms_by_shape": {k: min(v["device_ms"]) for k, v in score_shapes.items()},
        "redesigned_in": "second design: banded blur in registers fused with the peak test",
    }, {
        "name": "warp_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/warp_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_warp.py:74",
        "launches": launched["warp_kernel"],
        "max_abs_err": warp_err,
        "ms": min(warp_device_ms),
        "plain_ms": min(warp_plain_ms),
        "bound_ms": warp_bound,
        "bound_by": warp_bound_by,
        "library_ms": min(grid_device_ms),
        "redesigned_in": "second design: 32x32-pixel tiles, fmodf only beyond the range",
    }, {
        "name": "conv_int8_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/conv_int8_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_conv.py:98",
        "launches": launched["conv_int8_kernel"],
        "max_abs_err": max(conv_cases.values()),
        "ms": chain_ms,
        "plain_ms": chain_plain_ms,
        "bound_ms": conv_bound,
        "bound_by": conv_bound_by,
        "library_ms": chain_library_ms,
        "library_ms_with_im2col": chain_library_im2col_ms,
        "redesigned_in": "second design: wgmma on TMA-fed tiles",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
