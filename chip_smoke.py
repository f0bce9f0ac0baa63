#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one nvcc per source, all started together), holds each against its plain
PyTorch version on the card (f32 within 2e-4, bf16 within
``precision.BF16_KERNEL_REL_TOL``; the attention kernels element by
element) at the shapes of every cell below and of reduced cells, with its
time, its bound and the time of ``torch.sparse.mm`` on the
CSR system matrix wherever its nonzeros fit int32 indices (but on the
cells that vary another cell's geometry: ``Cell.library``), then drives each
path through the public API at the paper's sizes:

* main cell (parallel) — the limited-angle training shape,
  ``configs/leap_ct.py`` ``limited_angle_geometry(512, 720)``:
  a 512x512x1 volume, 720 views over 180 degrees, a 1x768 detector, at
  batch 8 (random ellipse phantoms, seeds 0-7, f32).  Dot tests (f32,
  bf16), the autograd gradient against A^T(Ax - y), Shepp-Logan against its
  analytic projection, FBP of a uniform disk, and 50 SIRT iterations.
* 3D cell (parallel) — ``configs/leap_ct.py``
  ``table1_geometries()["parallel_512_180"]``: a 512^3 volume, 180 views, a
  512x768 detector.  One FP, one BP and the dot test.
* fan cell — the sparse-view fan class of the reference's
  ``launch/ct_train.py:189-192`` at n = 512: a 512x512x1 volume, 768 views
  over 360 degrees, a 1x1126 detector, sod 1024, sdd 1536, at batch 8, on a
  flat and on a curved detector.  Dot tests (f32, bf16), the gradient, FBP
  of a uniform disk, a Parker short scan against naive weighting, SIRT-50.
  Its kernels are also held on fan_rows (kernel phase): the flat fan cell
  as a multi-slice scan, 16 detector rows over 512x512x16 at batch 4, 64
  lanes whose threads share each weight.
* cone cell — ``configs/leap_ct.py``
  ``table1_geometries()["cone_512_180"]``: a 512^3 volume, 180 views, a
  512x768 detector of 2 mm pixels, sod 1024, sdd 2048.  One FP, one BP, the
  dot test and FDK of a uniform cylinder.  Its kernels are held against the
  plain versions on two of its views (one per view group; with the library
  time) and on seven views at the axes and at both sides of the 45 and 135
  degree view-group edges, where the FP's voxel window is tightest.
* helical cell (modular) — the helical class of the reference's
  ``launch/ct_train.py:193-199`` at n = 512: a 512x512x8 volume, 2 turns of
  4 mm pitch in 768 views, a 6x1126 detector (2 mm rows, 1 mm columns), sod
  1024, sdd 1536, at batch 8 (ellipse keyframes blended along z, seeds
  0-7, f32).  Dot tests (f32, bf16), the autograd gradient bit-equal to
  A^T(Ax - y), double backward, SIRT-30, CGLS-20 (non-increasing residual)
  and FISTA-TV-30 with their PSNRs, and data-consistency refinement on a
  few-view mask of half the views.  Its kernels are held against the plain
  versions on the whole cell at batch 8 in f32 (the plain versions on its
  first sample; 6.2e9 nonzeros: no library matrix), and on 90 of its
  views at batch 8 in f32 and bf16 (the first and last, both sides of each
  turn's 45 and 135 degree view-group edges, and evenly spaced others; all
  8 samples, with the library time).  Batch 1 is timed on both
  kernel instances (one and eight samples per thread).
* modular_wobbly (kernel phase) — the irregular trajectory of the
  reference's ``tests/test_modular.py:38-57`` scaled x8: 128x128x64, 90
  views, per-view sod/sdd/source height and detector shifts, e_v flipped on
  odd views, a 128x192 detector of 2 mm.
* cone_packed — a micro-CT slab scan, 512x512x8 voxels of 50 um (a 25.6
  mm field), 720 views, 8x768 pixels of 75 um, sod 1024, sdd 1536, at
  batch 8 (ellipse slabs, seeds 0-7, f32), ``mode="auto"``: it resolves the
  packed cone pair (row shift 0.072 rows under the 0.25 gate), which runs
  the fan kernels on 64 lanes and no cone kernel; against its plain
  composition, dot test, gradient, relative L2 error against the exact
  cone pair on the same batch within ``cone_packed_error_bound``, and both
  pairs' times.  Its kernel-phase cell holds rows 3-4 on its 64 lanes with
  the library time on the packed transaxial CSR.  The Table-1 cone cell
  resolves the exact pair.
* lane_caps_fan, lane_caps_par_bp, lane_caps_par_fp (kernel phase) — a fan
  voxel meeting 314 columns, a parallel voxel meeting 455, a parallel
  column and line meeting 421 voxels, past the 254 the lane-packed kernels
  once counted in 8 bits; f32 and bf16 against the plain versions.
* joseph — the Joseph projectors (no kernel: plain torch) on card tensors
  through ``backend="auto"``: parallel, cone on a flat and a curved
  detector, and tilted modular frames under ``model="sf"``; dot test,
  gradient, the card against the host, and no kernel counter moves.
* iterative_recon — ``examples/iterative_recon_torch.py`` on the card
  (CGLS-25 and FISTA-TV-40 on the exact cone kernels, CGLS-25 on Joseph for
  tilted arcs; PSNRs printed), then at 3 iterations on the card and on the
  host with the same inputs: images within 5e-4 (relative L2).
* cone_as_modular — the cone cell re-expressed as modular frames: one FP
  and one BP against the cone kernels on the same inputs (relative norm
  < 1e-4); its kernels are held against the plain versions on views 7, 31.
* cone128_dv1.5 and modular_wobbly_dv1.5 (kernel phase) — cone128 and
  modular_wobbly with 1.5 mm detector rows: a row pitch that is not a power
  of two, whose division the cone-family FP must round as the plain
  version does.  Before the cells, the FP's division (``sf_div_rn``) is
  held bit for bit against ``__fdiv_rn`` over every float overlap with a
  normal quotient, at the cells' pitches and at published detector pitches.

* train — the CT training subsystem (``launch/ct_train.py``), one path
  per geometry of the reference's ``launch/ct_train.py:182-199``, each
  launching its kernels: limited_angle (rows 1-2; the hybrid CT-Net +
  U-Net), sparse_fan (rows 3-4) and helical (rows 7-8; nz = 8, the helical
  cell's geometry).  Per geometry: the training-smoke gate of
  docs/TRAINING.md at ``smoke_config`` (40 steps on the card: the loss
  falls, data-consistency refinement raises held-out PSNR) and its first 3
  losses against the host's (rtol 1e-4); one step's loss and gradients
  with the kernels against ``backend="ref"`` on the card (rel 1e-5 and
  relative L2 1e-4; at n = 512, helical at the smoke size); a fit at
  n = 512 with the TrainConfig defaults (base 16, levels 2, depth 3, batch
  4; 20 steps, helical 8) with its median step (CUDA events), peak memory
  and ``evaluate(n_test=2)``, beside a category breakdown of one step
  (projector kernels, convolution, the FBP's gather and scatter, matmul,
  other; busy share) taken by a process of its own, whose first profiler
  sessions these are.  limited_angle
  adds 3 steps in bf16 (first loss within ``BF16_FP_REL_BOUND`` of f32),
  sparse_fan a checkpoint resume under deterministic cuDNN (losses within
  1e-6 of the uninterrupted run's).  TF32 stays off, so card and host
  compare in f32.

* sharded — sharded recon on torch.distributed (``core/distributed.py``,
  ``launch/mesh.py``), in worlds of spawned ranks that load the kernels
  built here and check their own launches: sharded_main_11, the main cell
  at batch 8 on a (1, 1) mesh of one NCCL rank with one all-reduce (FP,
  BP, SIRT-50, FISTA-TV-30 with its power iteration, refinement-20 on
  half of the views and the projection residual bit-equal to the
  single-device Projector); in one gloo world of 4 ranks sharing the
  card, sharded_3d (the 3D cell on a (2, 2)
  mesh: 90 views, 256 slices and 256 rows a rank, halo 0), sharded_cone
  (the cone cell on (2, 2), halo 1 from ``suggest_halo``, 256-row blocks;
  halo 0 refused) and helical_long (512x512x64, 8 turns of 8 mm pitch in
  3072 views, the helical cell's detector, on (1, 4): the sliding-z
  pipeline, halo 7, a 30-slice slab a rank), each with FP and BP against
  the single-device kernel pair (2e-5; BP atol 2e-5 max|BP|), the dot
  test (< 1e-6), the overlap schedule against one all-reduce (1e-5, atol
  scaled by max|BP|), per-rank times and peak memory, on sharded_3d the
  power iteration (3), FISTA-TV-3 (1e-4) and refinement-3 (relative L2
  1e-4) against one device, and on helical_long SIRT-12 (within 1e-4 of
  one device, residual below 0.25
  of its first) and CGLS-10 (relative L2 1e-4); dp_train, a gloo world of
  2 ranks: ``CTTrainer(data_parallel=True)`` at n = 512 (TrainConfig
  defaults, batch 4) for 3 steps against one device (DP_HALVES_TOL,
  DP_BATCH_TOL) and ``make_ct_dp_train_step``'s loss falling over 5 steps
  against one device.  Ranks sharing one card over gloo show each rank's
  kernel work and host-staged collectives, not multi-card speed.
* serve — CT serving (``launch/ct_serve.py``): a scanner-farm burst of
  176 requests in five buckets at full width, submitted interleaved to one
  ``CTServer(max_batch=16)`` warmed at every size class, then drained:
  serve_main_fbp (the main cell, FBP, interactive, 64), serve_main_sirt
  (SIRT-50, quality, 32), serve_main_fista (FISTA-TV-30, its Lipschitz
  constant computed at warm(), 16), serve_fan_cgls (the flat fan cell,
  CGLS-20, 32) and serve_cone_packed_fdk (the cone_packed slab, FDK,
  interactive, 32); sinograms are the card's projections of the cells'
  phantoms.  Every 4th answer of a bucket (``SERVE_ALONE_EVERY``) is held
  against its solver on that request alone through ``Projector`` on the
  card (relative L2 within 2e-4), and every answer bit for bit against
  its solver on its own packed batch; for one batch
  of each bucket, the kernel pair at that batch's lane count (16 lanes,
  128 on cone_packed) is held against the plain pair (2e-4: the FP of
  the batch's answers, the BP of its sinograms); every interactive dispatch comes before any quality one and no dispatch
  holds two buckets; the burst leaves ``tune.sweep_count()``, the op
  cache's size and misses, the server's executors and
  ``build.loaded()`` as warm() left them; rows 1-4 are launched by the
  burst.  Per bucket: wall time, us a recon batched (and serial,
  ``max_batch=1``, for the two interactive buckets), p50/p99 latency, the
  size-class histogram.  Then a batch executor that raises leaves its
  batch mates answered.
* autotune — ``kernels/tune.py`` on the card: sweeps of the main and the
  flat fan cells at batch 8 in f32 (each candidate's FP and BP ms, the
  heuristic's pair against the tuned pair), the tuned pair against the
  plain pair (2e-4) and the dot test (< 1e-4), the winner read back from
  the run's cache file with no new sweep; and a SIRT bucket's server
  warmed with ``REPRO_TORCH_AUTOTUNE=1`` sweeps inside warm() and not in
  its burst.  The run keeps its tune cache in a temporary directory and
  runs with ``REPRO_TORCH_AUTOTUNE=0``; these two phases come after every
  other and ``tune.clear()`` follows them, so that no measured
  configuration reaches another phase or run.

* flash attention (kernel phase) — the four kernels of
  ``csrc/flash.cu`` against the plain chunked attention and the plain
  backward, and beside ``scaled_dot_product_attention``: cell
  qwen3_attn (B 2, 16 query heads, 8 kv heads, S 4096, hd 128; bf16 and
  f32), qwen3_attn_window (the same with a 2048 window, Hymba's
  ``sliding_window``; bf16), tinyllama_attn (B 1, 32 heads, 4 kv heads,
  S 3072, hd 64; bf16), window_edges (qwen3_attn's heads at batch 1
  with a 100-key window, which ends inside a tile on both sides; bf16 and
  f32) and nemotron_attn (Nemotron-4 340B's attention: B 1, 96 heads, 8 kv
  heads, S 4096, hd 192; bf16 and f32).  Every output is held element by
  element (``flash.KERNEL_TOL``) against the plain forward at the kernels'
  kv tile and the plain backward (``flash_bwd_plain``) on the kernels' lse
  and delta, and each cell shows that this check fails the plain output
  with one key fewer at each row's window edge.
* nemotron_attn_layer — one attention layer of Nemotron-4 340B at its
  published widths (``configs/nemotron_4_340b.py``: d_model 18432, 96/8
  heads of 192), random weights from seed 0, x of (1, 4096, 18432) in
  bf16: ``layers.attention_train``'s forward and its gradient with respect
  to x and the four weights on the kernels against the plain attention; one
  forward launch without grad, one of each gradient kernel with it.
* LM paths — Qwen3-0.6B at its published widths (``configs/qwen3_0_6b.py``:
  28 layers, d_model 1024, 16/8 heads of 128, d_ff 3072, vocab 151936,
  bf16), random weights from seed 0, tokens from ``TokenPipeline(seed 0)``:
  lm_prefill (2 prompts of 4096 tokens through ``make_prefill_step``; the
  forward kernel 28 times; against the plain attention), lm_grad (the
  loss gradient at 1 x 4096 under the config's remat "full": the forward
  with statistics 56 times, the two backward kernels 28 times each; a
  4-layer cut of the same widths against plain autograd), lm_serve (the
  continuous-batching ``Server``, 4 slots, 8 requests of 3-9 prompt tokens
  and 16 new ones, against offline greedy decoding; and a 3072-token prompt
  decoded token by token against the forward's logits at its last 8
  positions, on the first layer: decoding is launch-bound, ~70 ms a step
  at 28 layers).
* lm_train — ``launch/train.train_loop`` trains Qwen3-0.6B at its
  published widths and depth (remat "full", f32 master parameters, bf16
  compute) for 8 steps of 4 x 4096 tokens in 2 microbatches on
  ``build``'s AdamW: the median step (CUDA events between steps, after the
  first), tokens/s, peak memory and the losses (the last below the
  first); the forward with statistics 8 x 2 x 28 x 2 times, the backward
  kernels 8 x 2 x 28.  On a 2-layer cut of the same widths: one step
  against ``backend="ref"`` (5e-2), remat none / full / dots bit-equal
  with each one's peak memory, a ``Supervisor`` resume from a failure at
  step 3 (checkpoints every 2 steps; losses within 1e-6 of the
  uninterrupted run), and 3 steps with 1-bit compression.
* lm_families — the other LM families at their published widths
  (``configs/*.py``), random weights from seed 0, each model freed before
  the next: hymba_train (Hymba-1.5B, 32 layers, 1.662e9 parameters,
  windows of 2048 on 29 layers: ``train_loop`` for 4 steps of 2 x 4096
  tokens in 2 microbatches, the published grad_accum being 4; the
  forward with statistics 512 times, the backward kernels 256; the
  median step, tokens/s, peak memory, the losses falling, and the time
  of one layer's Mamba block and plain scan), hymba_cut (its first 3
  layers' widths: one step against ``backend="ref"``), hymba_serve (a
  4-slot ``Server`` round of 4 requests against offline greedy decoding;
  a 128-token prompt decoded against the forward on the 3-layer cut),
  olmoe (OLMoE-1B-7B, 6.92e9 parameters: prefill 2 x 4096 under impl
  dense, ragged and gather, ragged against dense, gather's dropped slots;
  a serving round), falcon_mamba (Falcon-Mamba-7B, no attention: prefill
  1 x 4096, a serving round, decode against the forward on a 4-layer
  cut), qwen2_vl (Qwen2-VL-72B's widths at 2 layers: prefill of 1024 vision
  embeddings and 3072 tokens with M-RoPE positions against
  ``backend="ref"``) and musicgen (MusicGen-large, 4 codebooks: prefill 2
  x 4096, a serving round).  The flash phase's hymba_attn cell holds the
  four kernels at Hymba's 25/5 heads of 64 with its window.
* lm_tp — tensor parallelism (``launch/sharding.py``) on a (1, 2) world
  of two gloo ranks sharing the card (NCCL refuses two ranks on one
  card), at Qwen3-0.6B's published widths and depth (8/4 heads of 128 a
  rank, half the MLP and the vocabulary): ``make_prefill_step`` on 2 x
  4096 tokens against one device (5e-2; flash_fwd 28 launches a rank);
  one training step of 2 x 4096 against one device's (the loss within
  1e-3, the update within 0.15 / 0.3); ``train_loop`` for 3 steps (each
  rank's step ms and each step's peak memory beside the dry run's
  prediction for the same layout, made on ``meta`` in this process
  meanwhile; the losses within 2e-2 of one device's train_loop; the
  forward with statistics 168 launches a rank, the backward kernels 84);
  a TP ``Server`` answering 4 requests, whose every token is one
  device's argmax wherever one device's top-2 gap exceeds twice the
  logits' difference; and Hymba-1.5B's widths at 3 layers, one step
  against one device, its 25 heads and vocabulary of 32001 replicated
  while its Mamba branch and MLP split.

After the build it prints ptxas's registers and spills of every flash
kernel instance (four kernels, f32 and bf16, hd 64, 128 and 192), of
the eight cone-family FP and eight BP instances, of the 8 parallel and
the 16 fan instances (nvcc runs with ``-Xptxas=-v``) and, from the card,
their shared memory a block (the FP's and flash's own count, held against
the host's) and resident blocks per SM (the FP's with its tile at the cone
and helical cells, the parallel pair's at the main and 512^3 cells, the
fan pair's at the fan cells), and holds the fan kernels' division
(``fan_div_rn``) against ``__fdiv_rn``.  Each cone-family FP row carries
the thread-per-output FP's time of run 15I (``FP_15I_MS``) beside its
own, each cone-family BP row the time of the BP before its redesign
(``BP_PARENT_MS``), each parallel and fan row the pair's time before its
redesign (``PAR_PARENT_MS``, ``FAN_PARENT_MS``), and the bf16 flash
rows at nemotron_attn the hd-192 kernels' time before theirs
(``FLASH_HD192_PARENT_MS``); any coded ptxas note on a bf16 flash
instance (a serialized wgmma, an ignored setmaxnreg) fails the run.
After the kernel phase it builds the FP and BP with their phase profiles
compiled in (``-DSF_FP_PHASES -DSF_BP_PHASES``) and prints, per cell,
each phase's share of the cycles
and the FP's passes, survivors and (survivor, slice) pairs and the BP's
dropped thread-views, columns and terms.

    python3 chip_smoke.py --cells cone128,cone128_dv1.5

runs only the build and the named cells of the projector kernel phase,
for comparing kernel sources on one card, and prints no ok line;
``--phases serve,autotune`` (or ``sharded``, ``lm_train``, ``flash``,
``lm_families``, ``lm_tp``) runs only the build and those phases.
``--train-breakdown FILE`` is the child process the full run starts for
the training step's breakdown.

Each path runs with every kernel launch count set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.
Last, a torch.profiler breakdown of one projector pair of the main, fan,
helical and cone_packed cells and of the 3D and cone cells' FP and BP, and of one LM
prefill and one LM gradient step (attention kernels, matrix products,
everything else), says where the device time goes.  Each breakdown
checks the profiler's kernel events against the launches the wrappers
counted in its window and logs ``INCOMPLETE`` where they differ.

Any failed check raises and the script exits non-zero.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits non-zero
and prints no result.  Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every ported kernel with its launches on its path,
its error against its plain version, and its times (the flash kernels at
qwen3_attn, and their hd-192 instances, ``_hd192``, at nemotron_attn with
their launches in nemotron_attn_layer).  Details go to
``chiprun_out/chip_smoke.json``.
"""
import atexit
import dataclasses
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"



def peak_rates():
    """The card's HBM rate (B/s) and peak operation rates by dtype (op/s),
    NVIDIA's published H100 SXM peaks, from ``repro_torch.launch.roofline``
    (the bounds' one source)."""
    from repro_torch.launch.roofline import HBM_BYTES_PER_S, PEAK_OPS
    return HBM_BYTES_PER_S, PEAK_OPS


F32_TOL = 2e-4          # kernel vs plain, as tests/test_kernels.py:33-46

# The LM paths against their plain attention, max |kernel - plain| over max
# |plain|, in the model's bf16 (see PERF.md for the measured values): the
# attention kernels round differently from the plain version (within
# flash.KERNEL_TOL), and 28 bf16 layers carry that to the logits.
LM_PREFILL_REL_TOL = 5e-2
LM_GRAD_REL_TOL = 5e-2
# Decode (plain attention over the cache, bf16 scores) against the forward
# (flash kernel) at the same positions, on the first DECODE_LAYERS layers
# (2 until the lm_families phase: its 3072 steps took 14.5 s on an NVIDIA
# H100 80GB HBM3 at 700.00 W, run 29B in PERF.md).
LM_DECODE_REL_TOL = 5e-2
DECODE_LAYERS = 1

# The cone-family FP before its redesign (one thread per column and 4 rows),
# as this script measured it on an NVIDIA H100 80GB HBM3 at 700.00 W (run
# 15I in PERF.md): ms by (cell, dtype), and on the paths, printed beside
# this run's.
FP_15I_MS = {
    ("cone", "float32"): 87.08367919921875,
    ("cone", "bfloat16"): 90.89785766601562,
    ("cone_edges", "float32"): 210.8814697265625,
    ("cone128", "float32"): 27.001248359680176,
    ("cone128", "bfloat16"): 27.714431762695312,
    ("helical", "float32"): 553.864990234375,
    ("helical_cut", "float32"): 94.18750381469727,
    ("helical_cut", "bfloat16"): 97.48515319824219,
    ("modular_wobbly", "float32"): 42.25998306274414,
    ("modular_wobbly", "bfloat16"): 43.2545280456543,
    ("cone_as_modular", "float32"): 87.79004669189453,
    ("cone_as_modular", "bfloat16"): 91.12630081176758,
}
FP_15I_PATH_MS = {"cone_fp": 4311.29296875, "helical_fp": 554.047119140625,
                  "fp_modular_sf_spt1": 363.3875732421875,
                  "fp_modular_sf_spt8": 516.4280395507812}

# The cone-family BP before its redesign (one thread per gi and 8 or 4 z
# slices, a warp along z), as this script measured it on an NVIDIA H100
# 80GB HBM3 at 700.00 W (PERF.md: the kernel-phase cells in run 18A, the
# whole helical cell, cone_edges and the paths in run 17N, whose BP was
# the same): ms by (cell, dtype), and on the paths, printed beside this
# run's.
BP_PARENT_MS = {
    ("cone128", "float32"): 13.259007930755615,
    ("cone128", "bfloat16"): 7.483328104019165,
    ("cone128_dv1.5", "float32"): 12.16974401473999,
    ("cone128_dv1.5", "bfloat16"): 8.049647808074951,
    ("cone", "float32"): 32.24126434326172,
    ("cone", "bfloat16"): 21.97065544128418,
    ("cone_edges", "float32"): 127.2787857055664,
    ("helical", "float32"): 290.52020263671875,
    ("helical_cut", "float32"): 33.73012733459473,
    ("helical_cut", "bfloat16"): 34.91734313964844,
    ("modular_wobbly", "float32"): 11.42083215713501,
    ("modular_wobbly", "bfloat16"): 6.9897119998931885,
    ("modular_wobbly_dv1.5", "float32"): 10.89799976348877,
    ("modular_wobbly_dv1.5", "bfloat16"): 8.004816055297852,
    ("cone_as_modular", "float32"): 32.275630950927734,
    ("cone_as_modular", "bfloat16"): 21.905375480651855,
}
BP_PARENT_PATH_MS = {"cone_bp": 4063.33642578125, "helical_bp": 290.77862548828125,
                     "bp_modular_sf_spt1": 120.34630584716797,
                     "bp_modular_sf_spt8": 252.33856201171875}

# The parallel pair before its redesign (a thread per output and 8 lanes,
# each weight evaluated by every thread that needed it), as this script
# measured it on an NVIDIA H100 80GB HBM3 at 700.00 W (run 19A in PERF.md:
# ``--cells main,3d128,3d`` from a checkout of the parent): ms by (kernel,
# cell, dtype), printed beside this run's.
PAR_PARENT_MS = {
    ("fp_par_sf", "main", "float32"): 27.51255989074707,
    ("bp_par_sf", "main", "float32"): 7.029151916503906,
    ("fp_par_sf", "main", "bfloat16"): 27.307392120361328,
    ("bp_par_sf", "main", "bfloat16"): 6.239920139312744,
    ("fp_par_sf", "3d128", "float32"): 1.4528799653053284,
    ("bp_par_sf", "3d128", "float32"): 0.4615039974451065,
    ("fp_par_sf", "3d128", "bfloat16"): 1.561456024646759,
    ("bp_par_sf", "3d128", "bfloat16"): 0.4935680031776428,
    ("fp_par_sf", "3d", "float32"): 140.11097717285156,
    ("bp_par_sf", "3d", "float32"): 95.00109100341797,
    ("fp_par_sf", "3d", "bfloat16"): 141.2855682373047,
    ("bp_par_sf", "3d", "bfloat16"): 95.8796157836914,
}

# The fan pair before its redesign (a thread per output and 8 lanes, each
# trapezoid re-formed in every column that might see it, margin taps), as
# this script measured it on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md:
# fan and fan_curved in run 20A, ``--cells fan,fan_curved`` from a checkout
# of the parent; fan_rows in run 20F, the parent with this script):
# ms by (kernel, cell, dtype), printed beside this run's.
FAN_PARENT_MS = {
    ("fp_fan_sf", "fan", "float32"): 48.59382247924805,
    ("bp_fan_sf", "fan", "float32"): 11.324496269226074,
    ("fp_fan_sf", "fan", "bfloat16"): 49.76591873168945,
    ("bp_fan_sf", "fan", "bfloat16"): 9.763487815856934,
    ("fp_fan_sf", "fan_curved", "float32"): 57.69776153564453,
    ("bp_fan_sf", "fan_curved", "float32"): 11.528096199035645,
    ("fp_fan_sf", "fan_curved", "bfloat16"): 59.20700645446777,
    ("bp_fan_sf", "fan_curved", "bfloat16"): 10.65444803237915,
    ("fp_fan_sf", "fan_rows", "float32"): 195.79244995117188,
    ("bp_fan_sf", "fan_rows", "float32"): 68.3743667602539,
    ("fp_fan_sf", "fan_rows", "bfloat16"): 200.88652801513672,
    ("bp_fan_sf", "fan_rows", "bfloat16"): 69.66128158569336,
}

# The hd-192 bf16 kernels before their redesigns (the forward: two
# warpgroups in lock step, copying their own tiles by cp.async; dQ in three
# column parts, each recomputing S and dP; dK/dV with both warpgroups
# forming S^T and dP^T on 32-query halves), as this script measured them on
# an NVIDIA H100 80GB HBM3 at 700.00 W (run 17N in PERF.md): ms by kernel
# at nemotron_attn in bf16, printed beside this run's.
FLASH_HD192_PARENT_MS = {"flash_fwd": 1.7385, "flash_fwd_stats": 1.7352,
                         "flash_bwd_dq": 8.7824, "flash_bwd_dkv": 9.4892}

FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash.cu"
FLASH_REPLACES = {"flash_fwd": "src/repro/kernels/flash.py:55",
                  "flash_fwd_stats": "src/repro/kernels/flash.py:150",
                  "flash_bwd_dq": "src/repro/kernels/flash.py:196",
                  "flash_bwd_dkv": "src/repro/kernels/flash.py:239"}
# name: (B, H, KV, S, hd, window, dtypes)
FLASH_CELLS = {
    "qwen3_attn": (2, 16, 8, 4096, 128, None, ("bfloat16", "float32")),
    "qwen3_attn_window": (2, 16, 8, 4096, 128, 2048, ("bfloat16",)),
    "tinyllama_attn": (1, 32, 4, 3072, 64, None, ("bfloat16",)),
    # a window that ends inside a 64-key tile on both sides, in both bodies
    "window_edges": (1, 16, 8, 4096, 128, 100, ("bfloat16", "float32")),
    # Nemotron-4 340B's attention (96 query heads, 8 kv heads of 192)
    "nemotron_attn": (1, 96, 8, 4096, 192, None, ("bfloat16", "float32")),
    # Hymba-1.5B's attention (25 query heads over 5 kv heads of 64, window 2048)
    "hymba_attn": (1, 25, 5, 4096, 64, 2048, ("bfloat16", "float32")),
}
# The cell whose bf16 rows stand for the flash kernels in the kernels line,
# by name suffix: the LM path's (hd 128), and the hd-192 instances'.
FLASH_LINE_CELLS = {"": "qwen3_attn", "_hd192": "nemotron_attn"}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call (CUDA events; warm unless warmup=0)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def event_ms(torch, fn):
    """``fn()`` and its device time in ms (CUDA events, one call)."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def host_s(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def vdot64(a, b) -> float:
    return float((a.double() * b.double()).sum())


def lane_entries(torch, plan):
    """The nonzeros of a lane-packed pair's (parallel, fan) transaxial
    system matrix (rows: view x column, columns: x x y), chunk by chunk,
    from the plain version's weights: yields (row, column, value)."""
    nu, ny = plan.geom.n_cols, plan.geom.vol.ny
    dt = plan.on(torch.device("cuda"))
    for grp in (0, 1):
        ng, nl, _, _ = plan.group(grp, 1)
        table, rows = dt.tables[grp], dt.rows[grp].long()
        gi = torch.arange(ng, device="cuda")[:, None]
        li = torch.arange(nl, device="cuda")[None, :]
        vox = (gi * ny + li if grp == 0 else li * ny + gi).reshape(1, -1)
        for a0 in range(0, table.shape[0], 64):
            a1 = min(table.shape[0], a0 + 64)
            base = (rows[a0:a1] * nu)[:, None]
            for u, w in plan.weights(table[a0:a1], ng, nl):
                keep = w != 0
                yield (base + u)[keep], vox.expand_as(u)[keep], w[keep]


def cone_entries(torch, plan):
    """The nonzeros of the exact cone (or modular) pair's system matrix
    (rows: view x detector row x column, columns: x x y x z), chunk by
    chunk, from the plain version's weights: yields (row, column, value)."""
    from repro_torch.kernels.fp_cone import _chunks, chunk_taps
    geom = plan.geom
    ny, nz = geom.vol.ny, geom.vol.nz
    npix = geom.n_rows * geom.n_cols
    dt = plan.on(torch.device("cuda"))
    tile = torch.empty(0, device="cuda")
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table, rows = dt.tables[grp], dt.rows[grp].long()
        gi = torch.arange(ng, device="cuda")[:, None]
        li = torch.arange(nl, device="cuda")[None, :]
        vox = (gi * ny + li if grp == 0 else li * ny + gi).reshape(1, -1, 1)
        for a0, a1, z0, z1 in _chunks(plan, 1, table.shape[0], ng * nl):
            col = vox * nz + torch.arange(z0, z1, device="cuda").reshape(1, 1, -1)
            base = (rows[a0:a1] * npix).reshape(-1, 1, 1)
            for pix, wu, wz in chunk_taps(plan, table[a0:a1], ng, nl, z0,
                                          z1 - z0, tile):
                w = wu * wz
                keep = w != 0
                yield (base + pix)[keep], col.expand_as(pix)[keep], w[keep]


def cone_nnz(torch, plan) -> int:
    """The exact cone (or modular) pair's nonzero weights, counted one view
    at a time (cheaper than counting cone_entries: no indices are made)."""
    from repro_torch.kernels.fp_cone import chunk_taps
    dt = plan.on(torch.device("cuda"))
    tile = torch.empty(0, device="cuda")
    nnz = 0
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table = dt.tables[grp]
        for a in range(table.shape[0]):
            for _, wu, wz in chunk_taps(plan, table[a:a + 1], ng, nl, 0,
                                        plan.geom.vol.nz, tile):
                nnz += int(torch.count_nonzero(wu * wz))
    return nnz


# Nonzeros of the library matrix built per pass (see csr_matrix): a pass
# holds ~60 bytes of device memory per nonzero at its peak (indices, sort
# keys, permutation, values), the finished matrix 8.
PASS_NNZ = 3e8
# CSR with int32 indices holds fewer nonzeros than this.
LIB_NNZ_MAX = 2 ** 31 - 1


def csr_matrix(torch, entries, shape, nnz: int, transpose: bool = False):
    """The matrix of ``shape`` whose nonzeros ``entries()`` yields as (row,
    column, value) chunks — or its transpose — as CSR with int32 indices,
    columns sorted within each row.  Used only as the library yardstick
    (torch.sparse.mm); the port never calls it.  Built in blocks of rows of
    about PASS_NNZ nonzeros: each pass runs ``entries()`` again and keeps
    its block's, so that device memory holds one block's sort at a time."""
    n_rows, n_cols = shape[::-1] if transpose else shape
    check(nnz <= LIB_NNZ_MAX and n_cols <= LIB_NNZ_MAX,
          f"{nnz} nonzeros do not fit int32 CSR indices")
    passes = max(1, -(-nnz // int(PASS_NNZ)))
    bounds = [n_rows * i // passes for i in range(passes + 1)]
    counts, cols, vals = [], [], []
    for r0, r1 in zip(bounds, bounds[1:]):
        keys, vs = [], []
        for r, c, v in entries():
            if transpose:
                r, c = c, r
            m = (r >= r0) & (r < r1)
            keys.append((r[m] - r0) * n_cols + c[m])
            vs.append(v[m])
        keys, order = torch.sort(torch.cat(keys))
        vals.append(torch.cat(vs)[order])
        del vs, order
        counts.append(torch.bincount(keys // n_cols, minlength=r1 - r0))
        cols.append((keys % n_cols).to(torch.int32))
        del keys
    crow = torch.cumsum(torch.cat([counts[0].new_zeros(1)] + counts), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)      # CSR is "beta"
        return torch.sparse_csr_tensor(
            crow.to(torch.int32), torch.cat(cols), torch.cat(vals),
            (n_rows, n_cols), check_invariants=False)


@dataclasses.dataclass
class Cell:
    """A kernel-phase cell: the kernel family, the geometry, the batch, a
    maker of the FP's f32 input at the kernel's interface, the plain
    version's timing repeats (0: time its comparison call alone, where it is
    slow), a note, the tile dtypes to hold, the samples the plain
    version runs on (0: all; n: the first n of a cone-family batch, whose
    kernel outputs of those samples it is held against), and whether the
    library's sparse matrix is built and timed (off for the cells that
    vary another cell's geometry: the lane caps, the 1.5 mm rows, the cone
    cell as modular frames, whose time went to the lm_tp phase)."""
    family: str
    geom: object
    batch: int
    make_x: object
    plain_reps: int = 3
    note: str = ""
    dtypes: tuple = ("float32", "bfloat16")
    plain_samples: int = 0
    library: bool = True


def families():
    """Per kernel family: its plan, its two kernel wrappers and their plain
    versions, its kernel names and source, and the TPU kernels it replaces."""
    from repro_torch.kernels import fp_cone, fp_fan, fp_modular, fp_par
    return {
        "par": dict(plan=fp_par.ParallelPlan, fp=fp_par.fp_lanes,
                    bp=fp_par.bp_lanes, fp_plain=fp_par.fp_lanes_plain,
                    bp_plain=fp_par.bp_lanes_plain, names=("fp_par_sf", "bp_par_sf"),
                    source="src/repro_torch/kernels/csrc/fp_par.cu",
                    replaces=("src/repro/kernels/fp_par.py:122",
                              "src/repro/kernels/fp_par.py:264")),
        "fan": dict(plan=fp_fan.FanPlan, fp=fp_fan.fp_lanes,
                    bp=fp_fan.bp_lanes, fp_plain=fp_fan.fp_lanes_plain,
                    bp_plain=fp_fan.bp_lanes_plain, names=("fp_fan_sf", "bp_fan_sf"),
                    source="src/repro_torch/kernels/csrc/fp_fan.cu",
                    replaces=("src/repro/kernels/fp_fan.py:94",
                              "src/repro/kernels/fp_fan.py:247")),
        # the packed cone pair: the fan kernels on a cone geometry's lanes
        "cone_packed": dict(plan=fp_fan.ConePackedPlan, fp=fp_fan.fp_lanes,
                            bp=fp_fan.bp_lanes, fp_plain=fp_fan.fp_lanes_plain,
                            bp_plain=fp_fan.bp_lanes_plain,
                            names=("fp_fan_sf", "bp_fan_sf"),
                            source="src/repro_torch/kernels/csrc/fp_fan.cu",
                            replaces=("src/repro/kernels/fp_fan.py:94",
                                      "src/repro/kernels/fp_fan.py:247")),
        "cone": dict(plan=fp_cone.ConePlan, fp=fp_cone.fp_batch,
                     bp=fp_cone.bp_batch, fp_plain=fp_cone.fp_batch_plain,
                     bp_plain=fp_cone.bp_batch_plain,
                     names=("fp_cone_sf", "bp_cone_sf"),
                     source="src/repro_torch/kernels/csrc/fp_cone.cu",
                     replaces=("src/repro/kernels/fp_cone.py:183",
                               "src/repro/kernels/fp_cone.py:346")),
        "modular": dict(plan=fp_modular.ModularPlan, fp=fp_modular.fp_batch,
                        bp=fp_modular.bp_batch, fp_plain=fp_modular.fp_batch_plain,
                        bp_plain=fp_modular.bp_batch_plain,
                        names=("fp_modular_sf", "bp_modular_sf"),
                        source="src/repro_torch/kernels/csrc/fp_modular.cu",
                        replaces=("src/repro/kernels/fp_modular.py:223",
                                  "src/repro/kernels/fp_modular.py:407")),
    }


def kernel_phase(torch, cells, results):
    """Each kernel against its plain version on the card, with times.
    ``cells``: name -> Cell."""
    from repro_torch.kernels import precision, tune
    fams = families()
    for cell, c in cells.items():
        t_cell = time.perf_counter()
        fam, geom, batch, plain_reps = c.family, c.geom, c.batch, c.plain_reps
        F = fams[fam]
        plan = F["plan"](geom)
        lane = fam in ("par", "fan", "cone_packed")
        n_plain = c.plain_samples or batch       # batch-major: the first n
        check(not lane or n_plain == batch, f"{cell}: a lane family's plain "
                                            f"version runs on the whole batch")
        # the parallel pair's or the fan pair's heuristic, as their paths use
        # them; the cone and modular launches derive their block from the
        # shapes
        cfg = (tune.parallel_config(geom, batch) if fam == "par" else
               tune.heuristic_config(geom, batch) if lane else None)
        args = (plan, cfg) if lane else (plan,)
        mult = batch * geom.n_rows if lane else batch   # outputs per weight

        def entries(plan=plan, lane=lane):
            return lane_entries(torch, plan) if lane else cone_entries(torch, plan)

        if lane:
            shape = (geom.n_angles * geom.n_cols, geom.vol.nx * geom.vol.ny)
            nnz = sum(int(v.numel()) for *_, v in entries())
        else:
            shape = (geom.n_angles * geom.n_rows * geom.n_cols,
                     geom.vol.nx * geom.vol.ny * geom.vol.nz)
            nnz = cone_nnz(torch, plan)
        library = c.library and nnz <= LIB_NNZ_MAX
        x_f32 = c.make_x()
        log(f"cell {cell}: nnz {nnz}, batch {batch}" + (f" ({c.note})" if c.note else ""))
        for name in c.dtypes:
            dtype = getattr(torch, name)
            tol = F32_TOL if dtype == torch.float32 else precision.BF16_KERNEL_REL_TOL
            x = x_f32.to(dtype)
            q = F["fp"](x_f32, *args).to(dtype)
            in_tables = sum(t.nbytes for t in plan.tables)
            for kname, run, plain, inp in (
                    (F["names"][0], F["fp"], F["fp_plain"], x),
                    (F["names"][1], F["bp"], F["bp_plain"], q)):
                k_out, first_ms = event_ms(torch, lambda: run(inp, *args))
                p_in, k_cmp = ((inp, k_out) if n_plain == batch
                               else (inp[:n_plain], k_out[:n_plain]))
                if plain_reps:
                    p_out = plain(p_in, plan)
                    plain_ms = cuda_ms(torch, lambda: plain(p_in, plan),
                                       reps=plain_reps, warmup=1)
                else:                      # time the comparison call itself
                    p_out, plain_ms = event_ms(torch, lambda: plain(p_in, plan))
                err = rel_err(k_cmp, p_out)
                abs_err = float((k_cmp - p_out).abs().max())
                del p_in, k_cmp
                check(bool(torch.isfinite(k_out).all()), f"{kname} {cell} {name}: non-finite")
                check(err <= tol, f"{kname} {cell} {name}: |kernel-plain|/|plain| "
                                  f"= {err:.3g} > {tol:.3g}")
                del p_out
                # about a second of repeats, at least 3
                reps = max(3, min(20, int(1000.0 / max(first_ms, 1e-3))))
                ms = cuda_ms(torch, lambda: run(inp, *args), reps=reps)
                lib_ms = None
                if dtype == torch.float32 and library:
                    fwd = kname == F["names"][0]
                    mat = csr_matrix(torch, entries, shape, nnz, transpose=not fwd)
                    dense = (inp.reshape(-1, mult) if lane
                             else inp.reshape(batch, -1).T.contiguous())
                    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(mat, dense))
                    lib = torch.sparse.mm(mat, dense)
                    lib = lib.reshape(k_out.shape) if lane else lib.T.reshape(k_out.shape)
                    del mat, dense
                    lib_err = rel_err(k_out, lib)
                    check(lib_err <= tol, f"{kname} {cell}: kernel vs sparse "
                                          f"matrix {lib_err:.3g}")
                    del lib
                    torch.cuda.empty_cache()
                nbytes = (inp.numel() * inp.element_size() + in_tables
                          + k_out.numel() * 4)
                del k_out
                ops = 2.0 * nnz * mult
                hbm, peak = peak_rates()
                t_bytes = nbytes / hbm * 1e3
                t_ops = ops / peak[name] * 1e3
                row = {"kernel": kname, "cell": cell, "dtype": name,
                       "shape": {"vol": list(geom.vol.shape), "sino": list(geom.sino_shape),
                                 "batch": batch, "detector": geom.detector_type},
                       "config": dataclasses.asdict(cfg) if lane else None,
                       "rel_err": err, "max_abs_err": abs_err, "tol": tol,
                       "ms": ms, "reps": reps, "plain_ms": plain_ms,
                       "plain_samples": n_plain, "library_ms": lib_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "bytes": nbytes, "ops": ops, "nnz": nnz,
                       "library_note": None if library else
                       "not built for this cell" if not c.library else
                       f"not built: {nnz} nonzeros > {LIB_NNZ_MAX} (int32 CSR)"}
                if kname in ("fp_cone_sf", "fp_modular_sf"):
                    row["ms_15I"] = FP_15I_MS.get((cell, name))
                if kname in ("bp_cone_sf", "bp_modular_sf"):
                    row["ms_parent"] = BP_PARENT_MS.get((cell, name))
                if fam == "par":
                    row["ms_parent"] = PAR_PARENT_MS.get((kname, cell, name))
                if fam == "fan":
                    row["ms_parent"] = FAN_PARENT_MS.get((kname, cell, name))
                results["kernels"].append(row)
                log(f"kernel {kname:10s} {cell:10s} {name:8s} rel_err {err:.3g} "
                    f"ms {ms:.4f} plain_ms {plain_ms:.4f}"
                    + (f" ({n_plain} of {batch} samples)" if n_plain < batch else "")
                    + f" library_ms {lib_ms} "
                    f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']})"
                    + (f" 15I_ms {row['ms_15I']}" if row.get("ms_15I") else "")
                    + (f" parent_ms {row['ms_parent']}" if row.get("ms_parent") else ""))
        del x_f32, x, q
        torch.cuda.empty_cache()
        results["phase_s"][f"kernels {cell}"] = time.perf_counter() - t_cell


def main_geometry():
    """configs/leap_ct.py ``limited_angle_geometry(512, 720)``."""
    from repro_torch.configs.leap_ct import limited_angle_geometry
    return limited_angle_geometry(512, 720)


def table1(name: str):
    """configs/leap_ct.py ``table1_geometries()[name]``."""
    from repro_torch.configs.leap_ct import table1_geometries
    return table1_geometries()[name]


def main_cell(torch, results):
    """The main path, through the public API."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.data.metrics import psnr
    from repro_torch.data.phantoms import (SHEPP_LOGAN, analytic_parallel_projection,
                                           random_ellipse_phantom, shepp_logan_2d)
    from repro_torch.kernels import precision
    from repro_torch.recon import sirt

    geom = main_geometry()
    vol = geom.vol
    dev = torch.device("cuda")
    out = {}
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, vol)[0]
                                   for s in range(8)])[..., None]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((8,) + geom.sino_shape, generator=gen, device=dev)

    t_start = time.perf_counter()
    proj = Projector(ProjectorSpec(geom))
    for cdt, tol in ((None, 1e-4), ("bfloat16", precision.BF16_DOT_TOL)):
        p = proj if cdt is None else Projector(ProjectorSpec(geom, compute_dtype=cdt))
        lhs, rhs = vdot64(p(x), y), vdot64(x, p.T(y))
        rel = abs(lhs - rhs) / abs(lhs)
        out[f"dot_{cdt or 'float32'}"] = rel
        log(f"main dot test {cdt or 'float32'}: {rel:.3g} (tol {tol:.3g})")
        check(rel < tol, f"main-cell dot test {cdt}: {rel:.3g} >= {tol:.3g}")

    sino, t_fp = host_s(torch, lambda: proj(x))
    _, t_bp = host_s(torch, lambda: proj.T(sino))
    out["fp_s"], out["bp_s"] = t_fp, t_bp
    check(tuple(sino.shape) == (8,) + geom.sino_shape and bool(torch.isfinite(sino).all()),
          "main-cell sinogram shape/finite")

    xg = (0.5 * x).requires_grad_()
    loss = 0.5 * torch.sum((proj(xg) - sino) ** 2)
    (grad,) = torch.autograd.grad(loss, xg)
    expected = proj.T(proj(xg.detach()) - sino)
    gerr = float((grad - expected).abs().max() / expected.abs().max())
    out["grad_rel_err"] = gerr
    check(torch.allclose(grad, expected, rtol=1e-4,
                         atol=1e-5 * float(expected.abs().max())),
          f"autograd gradient != A^T(Ax - y) (rel {gerr:.3g})")
    log(f"main gradient == A^T(Ax-y): rel {gerr:.3g}")

    s = 0.48 * min(vol.nx * vol.dx, vol.ny * vol.dy)
    ells = [dataclasses.replace(e, cx=e.cx * s, cy=e.cy * s, a=e.a * s, b=e.b * s)
            for e in SHEPP_LOGAN]
    f_sl = torch.from_numpy(shepp_logan_2d(vol)[:, :, None]).to(dev)
    p_sl = proj(f_sl)[:, 0, :].cpu().numpy()
    ana = analytic_parallel_projection(ells, np.asarray(geom.angles), geom.u_coords())
    err = np.abs(p_sl - ana)
    out["analytic_sup"] = float(err.max() / ana.max())
    out["analytic_mean"] = float(err.mean() / ana.mean())
    log(f"main Shepp-Logan vs analytic: sup {out['analytic_sup']:.4f} "
        f"mean {out['analytic_mean']:.4f}")
    check(out["analytic_sup"] < 0.12 and out["analytic_mean"] < 0.02,
          "Shepp-Logan projection vs analytic line integrals")

    X, Y = np.meshgrid(vol.x_coords(), vol.y_coords(), indexing="ij")
    disk = torch.from_numpy((0.02 * ((X ** 2 + Y ** 2) <= 80.0 ** 2))
                            .astype(np.float32)[:, :, None]).to(dev)
    rec = proj.fbp(proj(disk))
    centre = float(rec[224:288, 224:288, 0].mean())
    out["fbp_disk_centre_rel"] = centre / 0.02 - 1.0
    log(f"main FBP disk centre {centre:.6f} (1/mm), rel {out['fbp_disk_centre_rel']:.4f}")
    check(abs(out["fbp_disk_centre_rel"]) < 0.02, "FBP disk centre off by >= 2 %")

    rec_b, t_fbp = host_s(torch, lambda: proj.fbp(sino))
    res, t_sirt = host_s(torch, lambda: sirt(proj, sino, n_iters=50))
    hist = res.residual_history
    check(tuple(hist.shape) == (8, 50), f"residual history shape {tuple(hist.shape)}")
    check(bool((hist[:, -1] < 0.5 * hist[:, 0]).all()), "SIRT residual did not halve")
    out["fbp_s"], out["sirt50_s"] = t_fbp, t_sirt
    out["fbp_psnr"] = float(np.mean([psnr(rec_b[i], x[i]) for i in range(8)]))
    out["sirt_psnr"] = float(np.mean([psnr(res.image[i], x[i]) for i in range(8)]))
    out["sirt_residual_ratio"] = float((hist[:, -1] / hist[:, 0]).max())
    out["main_path_s"] = time.perf_counter() - t_start
    log(f"main FBP PSNR {out['fbp_psnr']:.2f} dB ({t_fbp:.3f} s), SIRT-50 PSNR "
        f"{out['sirt_psnr']:.2f} dB ({t_sirt:.3f} s), residual ratio "
        f"{out['sirt_residual_ratio']:.3g}")
    results["main_cell"] = out


def cell_3d(torch, results):
    from repro_torch import Projector, ProjectorSpec
    geom = table1("parallel_512_180")
    vol = geom.vol
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(vol.shape, generator=gen, device="cuda")
    y = torch.randn(geom.sino_shape, generator=gen, device="cuda")
    proj = Projector(ProjectorSpec(geom))
    ax, t_fp = host_s(torch, lambda: proj(x))
    aty, t_bp = host_s(torch, lambda: proj.T(y))
    check(bool(torch.isfinite(ax).all() and torch.isfinite(aty).all()), "3D non-finite")
    lhs, rhs = vdot64(ax, y), vdot64(x, aty)
    rel = abs(lhs - rhs) / abs(lhs)
    check(rel < 1e-4, f"3D dot test {rel:.3g}")
    fp_ms = cuda_ms(torch, lambda: proj(x), reps=3, warmup=1)
    bp_ms = cuda_ms(torch, lambda: proj.T(y), reps=3, warmup=1)
    results["cell_3d"] = {"dot": rel, "fp_first_s": t_fp, "bp_first_s": t_bp,
                          "fp_ms": fp_ms, "bp_ms": bp_ms}
    log(f"3D cell 512^3/180 views: dot {rel:.3g}, FP {fp_ms:.1f} ms, BP {bp_ms:.1f} ms "
        f"(first calls {t_fp:.3f} s / {t_bp:.3f} s)")


def fan_geometry(det: str, n_angles: int = 768, angular_range: float = 360.0):
    """The sparse-view fan class of the reference's launch/ct_train.py:189-192
    at n = 512: fan_beam(1.5n, 1, 2.2n, n x n x 1, sod=2n, sdd=3n)."""
    from repro_torch import VolumeGeometry, fan_beam
    return fan_beam(n_angles, 1, 1126, VolumeGeometry(512, 512, 1), sod=1024.0,
                    sdd=1536.0, angular_range=angular_range, detector_type=det)


def fan_rows_geometry():
    """The fan cell as a multi-slice scan: 16 detector rows of 1 mm over a
    512x512x16 volume (each row an independent fan of its slice)."""
    from repro_torch import VolumeGeometry, fan_beam
    return fan_beam(768, 16, 1126, VolumeGeometry(512, 512, 16), sod=1024.0,
                    sdd=1536.0)


def lane_cells() -> dict:
    """name -> (family, geometry, batch) of the lane-packed pairs' cells
    (``scripts/lane_bits.py`` compares two trees' kernels on them)."""
    from repro_torch import VolumeGeometry, parallel_beam
    return {
        "main": ("par", main_geometry(), 8),
        "3d128": ("par", parallel_beam(45, 128, 192, VolumeGeometry(128, 128, 128),
                                       angular_range=180.0), 1),
        "3d": ("par", table1("parallel_512_180"), 1),
        "fan": ("fan", fan_geometry("flat"), 8),
        "fan_curved": ("fan", fan_geometry("curved"), 8),
        "fan_rows": ("fan", fan_rows_geometry(), 4),
    }


def cone_geometry():
    """configs/leap_ct.py ``table1_geometries()["cone_512_180"]``."""
    return table1("cone_512_180")


def cone_packed_geometry():
    """A micro-CT slab scan: 512 x 512 x 8 voxels of 50 um (a 25.6 mm
    field), 720 views, 8 x 768 pixels of 75 um, sod 1024, sdd 1536; its
    packed row shift is 0.072 rows, under the packed gate's 0.25."""
    from repro_torch import VolumeGeometry, cone_beam
    return cone_beam(720, 8, 768, VolumeGeometry(512, 512, 8, dx=0.05, dy=0.05,
                                                 dz=0.05),
                     sod=1024.0, sdd=1536.0, pixel_width=0.075,
                     pixel_height=0.075)


def lane_caps_geometries():
    """Geometries past the 254 columns or voxels that the lane-packed kernels
    once counted in 8 bits: a fan BP of 314 columns a voxel, a parallel BP
    of 455, a parallel FP of 421 voxels a column and line."""
    from repro_torch import VolumeGeometry, fan_beam, parallel_beam
    return {
        "lane_caps_fan": ("fan", fan_beam(
            720, 1, 2048, VolumeGeometry(16, 16, 1, dx=6.25, dy=6.25), sod=200.0,
            sdd=400.0, pixel_width=0.1)),
        "lane_caps_par_bp": ("par", parallel_beam(
            90, 1, 512, VolumeGeometry(64, 64, 1, dx=16.0, dy=16.0),
            pixel_width=0.05)),
        "lane_caps_par_fp": ("par", parallel_beam(
            90, 1, 16, VolumeGeometry(512, 512, 1, dx=0.02, dy=0.02),
            pixel_width=6.0)),
    }


def helical_geometry():
    """The helical class of the reference's launch/ct_train.py:193-199 at
    n = 512 (nz = 8): helical_beam(2 turns, pitch nz/2, 1.5n views,
    max(6, nz/2 + 2) rows of 2 mm, 2.2n columns, n x n x nz, sod=2n,
    sdd=3n)."""
    from repro_torch import VolumeGeometry, helical_beam
    return helical_beam(n_turns=2.0, pitch=4.0, n_angles=768, n_rows=6,
                        n_cols=1126, vol=VolumeGeometry(512, 512, 8), sod=1024.0,
                        sdd=1536.0, pixel_width=1.0, pixel_height=2.0)


def helical_views() -> list:
    """90 of the helical cell's 768 views (0.9375 degrees apart): the first
    and last, where the source sits at the volume's ends; both sides of the
    45 and 135 degree view-group edges (views 48 and 144) in each turn; and
    evenly spaced others."""
    edges = [v + t for t in (0, 384) for e in (48, 144) for v in (e - 1, e, e + 1)]
    keep = sorted(set([0, 767] + edges))
    others = [v for v in np.linspace(0, 767, 100).round().astype(int).tolist()
              if v not in keep]
    step = len(others) / (90 - len(keep))
    return sorted(keep + [others[int(i * step)] for i in range(90 - len(keep))])


def cone128_geometry(pixel_height: float = 2.0):
    """The cone cell cut to 128^3 and 45 views (2 mm columns)."""
    from repro_torch import VolumeGeometry, cone_beam
    return cone_beam(45, 128, 192, VolumeGeometry(128, 128, 128), sod=256.0,
                     sdd=512.0, pixel_width=2.0, pixel_height=pixel_height,
                     angular_range=360.0)


def wobbly_geometry(pixel_height: float = 2.0):
    """The irregular trajectory of the reference's tests/test_modular.py:38-57
    scaled x8: non-uniform angles, per-view sod/sdd/source-height wobble,
    per-view in-plane and axial detector shifts, e_v flipped on odd views."""
    from repro_torch import VolumeGeometry, modular_beam
    na = 90
    rng = np.random.default_rng(3)
    ang = np.sort(rng.uniform(0, 2 * np.pi, na))
    sod = 640.0 + rng.uniform(-40, 40, na)
    sdd = 1280.0 + rng.uniform(-80, 80, na)
    zsrc = rng.uniform(-32, 32, na)
    c, s = np.cos(ang), np.sin(ang)
    src = np.stack([sod * c, sod * s, zsrc], -1)
    eu = np.stack([-s, c, np.zeros(na)], -1)
    ev = np.stack([np.zeros(na), np.zeros(na),
                   np.where(np.arange(na) % 2 == 0, 1.0, -1.0)], -1)
    ctr = (np.stack([(sod - sdd) * c, (sod - sdd) * s, zsrc], -1)
           + rng.uniform(-24, 24, na)[:, None] * eu
           + rng.uniform(-24, 24, na)[:, None] * ev)
    return modular_beam(src, ctr, eu, ev, n_rows=128, n_cols=192,
                        vol=VolumeGeometry(128, 128, 64), pixel_width=2.0,
                        pixel_height=pixel_height)


def helical_phantoms(torch, vol, seeds=range(8)):
    """(len(seeds), nx, ny, nz) volumes filling the z extent: per seed s two
    random ellipse keyframes (seeds s and s + 8) blended linearly along z, at
    0.02 /mm, as the reference's data/pipeline.py:104-111 builds them."""
    from repro_torch.data.phantoms import random_ellipse_phantom
    t = np.arange(vol.nz, dtype=np.float32) / max(vol.nz - 1, 1)
    out = [random_ellipse_phantom(s, vol)[0][..., None] * (1.0 - t)
           + random_ellipse_phantom(s + 8, vol)[0][..., None] * t for s in seeds]
    return torch.from_numpy((0.02 * np.stack(out)).astype(np.float32)).cuda()


def disk_volume(torch, vol, radius: float = 80.0, value: float = 0.02):
    X, Y = np.meshgrid(vol.x_coords(), vol.y_coords(), indexing="ij")
    d = (value * ((X ** 2 + Y ** 2) <= radius ** 2)).astype(np.float32)
    return torch.from_numpy(d).cuda()[:, :, None].expand(vol.shape).contiguous()


def fan_path(torch, results, det: str):
    """The fan path through the public API, on one detector type."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.core.fbp import _fan_gamma
    from repro_torch.data.metrics import psnr
    from repro_torch.data.phantoms import random_ellipse_phantom, shepp_logan_2d
    from repro_torch.kernels import precision
    from repro_torch.recon import sirt

    geom = fan_geometry(det)
    vol = geom.vol
    dev = torch.device("cuda")
    out = {}
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, vol)[0]
                                   for s in range(8)])[..., None]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    y = torch.randn((8,) + geom.sino_shape, generator=gen, device=dev)
    t_start = time.perf_counter()
    proj = Projector(ProjectorSpec(geom))
    for cdt, tol in ((None, 1e-4), ("bfloat16", precision.BF16_DOT_TOL)):
        p = proj if cdt is None else Projector(ProjectorSpec(geom, compute_dtype=cdt))
        lhs, rhs = vdot64(p(x), y), vdot64(x, p.T(y))
        rel = abs(lhs - rhs) / abs(lhs)
        out[f"dot_{cdt or 'float32'}"] = rel
        log(f"fan {det} dot test {cdt or 'float32'}: {rel:.3g} (tol {tol:.3g})")
        check(rel < tol, f"fan {det} dot test {cdt}: {rel:.3g} >= {tol:.3g}")

    sino, t_fp = host_s(torch, lambda: proj(x))
    _, t_bp = host_s(torch, lambda: proj.T(sino))
    out["fp_s"], out["bp_s"] = t_fp, t_bp
    check(tuple(sino.shape) == (8,) + geom.sino_shape and bool(torch.isfinite(sino).all()),
          f"fan {det} sinogram shape/finite")
    xg = (0.5 * x).requires_grad_()
    loss = 0.5 * torch.sum((proj(xg) - sino) ** 2)
    (grad,) = torch.autograd.grad(loss, xg)
    expected = proj.T(proj(xg.detach()) - sino)
    gerr = float((grad - expected).abs().max() / expected.abs().max())
    out["grad_rel_err"] = gerr
    check(torch.allclose(grad, expected, rtol=1e-4,
                         atol=1e-5 * float(expected.abs().max())),
          f"fan {det}: autograd gradient != A^T(Ax - y) (rel {gerr:.3g})")
    log(f"fan {det} gradient == A^T(Ax-y): rel {gerr:.3g}")

    rec = proj.fbp(proj(disk_volume(torch, vol)))
    centre = float(rec[224:288, 224:288, 0].mean())
    out["fbp_disk_centre_rel"] = centre / 0.02 - 1.0
    log(f"fan {det} FBP disk centre {centre:.6f} (1/mm), rel "
        f"{out['fbp_disk_centre_rel']:.4f}")
    check(abs(out["fbp_disk_centre_rel"]) < 0.02, f"fan {det} FBP disk centre off by >= 2 %")

    # Parker short scan: pi + 2 x the half fan angle, the full scan's step
    delta = float(np.abs(_fan_gamma(geom)).max())
    short = fan_geometry(det, 470, float(np.degrees(np.pi + 2.0 * delta)))
    ps = Projector(ProjectorSpec(short))
    f_sl = torch.from_numpy(shepp_logan_2d(vol)[:, :, None]).to(dev) * 0.02
    s_sl = ps(f_sl)
    out["short_scan_deg"] = float(np.degrees(np.pi + 2.0 * delta))
    out["parker_psnr"] = psnr(ps.fbp(s_sl), f_sl)
    out["naive_psnr"] = psnr(ps.fbp(s_sl, short_scan=False), f_sl)
    log(f"fan {det} short scan {out['short_scan_deg']:.2f} deg / 470 views: Parker "
        f"{out['parker_psnr']:.2f} dB, naive {out['naive_psnr']:.2f} dB")
    check(out["parker_psnr"] > out["naive_psnr"] + 4.0,
          f"fan {det}: Parker does not beat naive weighting by 4 dB")

    if det == "flat":
        res, t_sirt = host_s(torch, lambda: sirt(proj, sino, n_iters=50))
        hist = res.residual_history
        check(tuple(hist.shape) == (8, 50), f"residual history shape {tuple(hist.shape)}")
        check(bool((hist[:, -1] < 0.5 * hist[:, 0]).all()), "fan SIRT residual did not halve")
        out["sirt50_s"] = t_sirt
        out["sirt_psnr"] = float(np.mean([psnr(res.image[i], x[i]) for i in range(8)]))
        out["sirt_residual_ratio"] = float((hist[:, -1] / hist[:, 0]).max())
        log(f"fan {det} SIRT-50 PSNR {out['sirt_psnr']:.2f} dB ({t_sirt:.3f} s), "
            f"residual ratio {out['sirt_residual_ratio']:.3g}")
    out["path_s"] = time.perf_counter() - t_start
    results[f"fan_{det}"] = out


def cone_path(torch, results):
    """The cone path through the public API at the 512^3 Table-1 cell."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.kernels.fp_cone import ConePlan
    geom = cone_geometry()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(geom.vol.shape, generator=gen, device="cuda")
    y = torch.randn(geom.sino_shape, generator=gen, device="cuda")
    proj = Projector(ProjectorSpec(geom))
    ax, t_fp = host_s(torch, lambda: proj(x))
    aty, t_bp = host_s(torch, lambda: proj.T(y))
    check(tuple(ax.shape) == geom.sino_shape and tuple(aty.shape) == geom.vol.shape,
          "cone shapes")
    check(bool(torch.isfinite(ax).all() and torch.isfinite(aty).all()), "cone non-finite")
    lhs, rhs = vdot64(ax, y), vdot64(x, aty)
    rel = abs(lhs - rhs) / abs(lhs)
    log(f"cone dot test {rel:.3g} (first calls FP {t_fp:.3f} s, BP {t_bp:.3f} s)")
    check(rel < 1e-4, f"cone dot test {rel:.3g}")
    del ax, aty
    # the first calls warmed the kernels; a call takes ~4 s
    fp_ms = cuda_ms(torch, lambda: proj(x), reps=2, warmup=0)
    bp_ms = cuda_ms(torch, lambda: proj.T(y), reps=2, warmup=0)
    del x, y
    cyl = disk_volume(torch, geom.vol)
    sino = proj(cyl)
    del cyl
    rec, t_fdk = host_s(torch, lambda: proj.fbp(sino))
    centre = float(rec[224:288, 224:288, 256].mean())
    del rec, sino
    torch.cuda.empty_cache()
    # the cell's bound, as the kernel phase computes it for its cells
    plan = ConePlan(geom)
    nnz = cone_nnz(torch, plan)
    nbytes = 4 * (geom.vol.nx * geom.vol.ny * geom.vol.nz + int(np.prod(geom.sino_shape)))
    nbytes += sum(t.nbytes for t in plan.tables)
    hbm, peak = peak_rates()
    t_bytes = nbytes / hbm * 1e3
    t_ops = 2.0 * nnz / peak["float32"] * 1e3
    results["cone"] = {"dot": rel, "fp_first_s": t_fp, "bp_first_s": t_bp,
                       "fp_ms": fp_ms, "fp_ms_15I": FP_15I_PATH_MS["cone_fp"],
                       "bp_ms": bp_ms, "bp_ms_parent": BP_PARENT_PATH_MS["cone_bp"],
                       "fdk_s": t_fdk,
                       "fdk_centre_rel": centre / 0.02 - 1.0, "nnz": nnz,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"cone 512^3/180 views: FP {fp_ms:.1f} ms (15I: "
        f"{FP_15I_PATH_MS['cone_fp']:.1f}), BP {bp_ms:.1f} ms (parent: "
        f"{BP_PARENT_PATH_MS['cone_bp']:.1f}), nnz {nnz}, "
        f"bound {max(t_bytes, t_ops):.4f} ms; FDK {t_fdk:.2f} s, cylinder centre "
        f"{centre:.6f} (rel {centre / 0.02 - 1.0:.4f})")
    check(abs(centre / 0.02 - 1.0) < 0.05, "FDK cylinder centre off by >= 5 %")


def helical_path(torch, results):
    """The helical path through the public API at full width, batch 8."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.data.metrics import psnr
    from repro_torch.kernels import precision
    from repro_torch.recon import (cgls, complete_and_refine, fista_tv,
                                   projection_residual, sirt)
    geom = helical_geometry()
    vol = geom.vol
    out = {}
    x = helical_phantoms(torch, vol)
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn((8,) + geom.sino_shape, generator=gen, device="cuda")
    t_start = time.perf_counter()
    proj = Projector(ProjectorSpec(geom))
    for cdt, tol in ((None, 1e-4), ("bfloat16", precision.BF16_DOT_TOL)):
        p = proj if cdt is None else Projector(ProjectorSpec(geom, compute_dtype=cdt))
        lhs, rhs = vdot64(p(x), y), vdot64(x, p.T(y))
        rel = abs(lhs - rhs) / abs(lhs)
        out[f"dot_{cdt or 'float32'}"] = rel
        log(f"helical dot test {cdt or 'float32'}: {rel:.3g} (tol {tol:.3g})")
        check(rel < tol, f"helical dot test {cdt}: {rel:.3g} >= {tol:.3g}")
    del y
    sino, t_fp = host_s(torch, lambda: proj(x))
    _, t_bp = host_s(torch, lambda: proj.T(sino))
    out["fp_s"], out["bp_s"] = t_fp, t_bp
    check(tuple(sino.shape) == (8,) + geom.sino_shape and bool(torch.isfinite(sino).all()),
          "helical sinogram shape/finite")
    out["fp_ms"] = cuda_ms(torch, lambda: proj(x), reps=3, warmup=0)
    out["fp_ms_15I"] = FP_15I_PATH_MS["helical_fp"]
    out["bp_ms"] = cuda_ms(torch, lambda: proj.T(sino), reps=3, warmup=0)
    out["bp_ms_parent"] = BP_PARENT_PATH_MS["helical_bp"]

    xg = (0.5 * x).requires_grad_()
    loss = 0.5 * torch.sum((proj(xg) - sino) ** 2)
    (grad,) = torch.autograd.grad(loss, xg, create_graph=True)
    expected = proj.T(proj(xg.detach()) - sino)
    out["grad_bit_equal"] = bool(torch.equal(grad, expected))
    check(out["grad_bit_equal"], "helical: autograd gradient is not bit-equal to "
          "A^T(Ax - y)")
    v = torch.randn(x.shape, generator=gen, device="cuda")
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    want = proj.T(proj(v))
    herr = float((hv - want).abs().max() / want.abs().max())
    out["double_backward_rel_err"] = herr
    check(torch.allclose(hv, want, rtol=1e-4, atol=1e-5 * float(want.abs().max())),
          f"helical: double backward != A^T A v (rel {herr:.3g})")
    log(f"helical gradient bit-equal to A^T(Ax-y); double backward rel {herr:.3g}")
    del xg, loss, grad, expected, v, hv, want

    def mean_psnr(img):
        return float(np.mean([psnr(img[i], x[i]) for i in range(8)]))

    res, out["sirt30_s"] = host_s(torch, lambda: sirt(proj, sino, n_iters=30))
    hist = res.residual_history
    check(tuple(hist.shape) == (8, 30), f"SIRT history shape {tuple(hist.shape)}")
    check(bool((hist[:, -1] < hist[:, 0]).all()), "helical SIRT residual did not fall")
    out["sirt_psnr"] = mean_psnr(res.image)
    x_sirt = res.image
    res, out["cgls20_s"] = host_s(torch, lambda: cgls(proj, sino, n_iters=20))
    hist = res.residual_history
    # CG's residual norm is non-increasing; 1e-6 relative is the f32
    # rounding of a norm over 3.3e7 rays
    out["cgls_residual_ratio"] = float((hist[:, -1] / hist[:, 0]).max())
    check(bool((hist[:, 1:] <= hist[:, :-1] * (1.0 + 1e-6)).all()),
          "helical CGLS residual increased")
    out["cgls_psnr"] = mean_psnr(res.image)
    res, out["fista_tv30_s"] = host_s(
        torch, lambda: fista_tv(proj, sino, n_iters=30, beta=2e-3))
    out["fista_tv_psnr"] = mean_psnr(res.image)
    check(bool(torch.isfinite(res.image).all()), "helical FISTA-TV non-finite")
    del res

    # few-view data consistency: half the views measured (ct_train.py:224)
    idx = np.sort(np.random.default_rng(0).choice(geom.n_angles, geom.n_angles // 2,
                                                  replace=False))
    mask = torch.zeros((geom.n_angles, 1, 1), device="cuda")
    mask[torch.from_numpy(idx).cuda()] = 1.0
    before = float(projection_residual(proj, x_sirt, sino, mask))
    (x_dc, completed), out["dc_refine10_s"] = host_s(
        torch, lambda: complete_and_refine(proj, x_sirt, sino, mask, n_iters=10))
    after = float(projection_residual(proj, x_dc, sino, mask))
    out["dc_residual_before"], out["dc_residual_after"] = before, after
    check(after < before, f"data-consistency refinement did not lower the "
                          f"projection residual ({before:.4g} -> {after:.4g})")
    check(torch.equal(completed[:, idx], sino[:, idx]), "completion changed a "
                                                         "measured view")
    del x_dc, completed, x_sirt
    out["path_s"] = time.perf_counter() - t_start
    log(f"helical FP {out['fp_ms']:.1f} ms (15I: {out['fp_ms_15I']:.1f}), BP "
        f"{out['bp_ms']:.1f} ms (parent: {out['bp_ms_parent']:.1f}) (batch 8); "
        f"SIRT-30 {out['sirt_psnr']:.2f} dB ({out['sirt30_s']:.2f} s), CGLS-20 "
        f"{out['cgls_psnr']:.2f} dB ({out['cgls20_s']:.2f} s, residual ratio "
        f"{out['cgls_residual_ratio']:.3g}), FISTA-TV-30 {out['fista_tv_psnr']:.2f} dB "
        f"({out['fista_tv30_s']:.2f} s); few-view DC residual {before:.4f} -> {after:.4f}")

    # the cell's bound is the kernel phase's (cell "helical", f32)
    del x, sino
    torch.cuda.empty_cache()
    results["helical"] = out


def cone_as_modular_path(torch, results):
    """The 512^3 cone cell as modular frames through the public API, against
    the cone kernels on the same inputs."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.core.geometry import cone_as_modular
    geom = cone_geometry()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand(geom.vol.shape, generator=gen, device="cuda")
    y = torch.randn(geom.sino_shape, generator=gen, device="cuda")
    pm = Projector(ProjectorSpec(cone_as_modular(geom)))
    pc = Projector(ProjectorSpec(geom))
    ax, t_fp = host_s(torch, lambda: pm(x))
    aty, t_bp = host_s(torch, lambda: pm.T(y))
    check(bool(torch.isfinite(ax).all() and torch.isfinite(aty).all()),
          "cone_as_modular non-finite")
    lhs, rhs = vdot64(ax, y), vdot64(x, aty)
    dot = abs(lhs - rhs) / abs(lhs)
    want = pc(x)
    fp_rel = float((ax - want).norm() / want.norm())
    del ax, want
    want = pc.T(y)
    bp_rel = float((aty - want).norm() / want.norm())
    del aty, want
    results["cone_as_modular"] = {"fp_s": t_fp, "bp_s": t_bp, "dot": dot,
                                  "fp_rel_vs_cone": fp_rel, "bp_rel_vs_cone": bp_rel}
    log(f"cone_as_modular 512^3/180 views: FP {t_fp:.3f} s, BP {t_bp:.3f} s, dot "
        f"{dot:.3g}; vs the cone kernels FP {fp_rel:.3g}, BP {bp_rel:.3g}")
    check(dot < 1e-4, f"cone_as_modular dot test {dot:.3g}")
    check(fp_rel < 1e-4 and bp_rel < 1e-4,
          f"cone_as_modular vs cone kernels: FP {fp_rel:.3g}, BP {bp_rel:.3g}")
    torch.cuda.empty_cache()


def cone_packed_path(torch, results):
    """The packed cone pair through the public API on the micro-CT slab at
    batch 8 (64 lanes), ``mode="auto"``: it resolves packed and runs the fan
    kernels only; element by element against its plain composition, dot
    test, gradient = A^T(Ax - y); the pair's times."""
    from repro_torch import Projector, ProjectorSpec, resolve_mode
    from repro_torch import kernels as K
    from repro_torch.kernels import fp_par
    from repro_torch.kernels.fp_fan import ConePackedPlan
    geom = cone_packed_geometry()
    proj = Projector(ProjectorSpec(geom))
    mode = resolve_mode(proj.spec)
    check(mode == "packed", f"cone_packed resolves {mode!r}, not 'packed'")
    t1 = resolve_mode(ProjectorSpec(cone_geometry()))
    check(t1 == "exact", f"the Table-1 cone cell resolves {t1!r}, not 'exact'")
    x = helical_phantoms(torch, geom.vol)
    gen = torch.Generator(device="cuda").manual_seed(7)
    y = torch.randn((8,) + geom.sino_shape, generator=gen, device="cuda")
    out = {"mode": mode, "table1_cone_mode": t1}
    ax, out["fp_first_s"] = host_s(torch, lambda: proj(x))
    aty, out["bp_first_s"] = host_s(torch, lambda: proj.T(y))
    check(tuple(ax.shape) == (8,) + geom.sino_shape and bool(torch.isfinite(ax).all())
          and bool(torch.isfinite(aty).all()), "cone_packed shape/finite")
    lhs, rhs = vdot64(ax, y), vdot64(x, aty)
    out["dot"] = abs(lhs - rhs) / abs(lhs)
    check(out["dot"] < 1e-4, f"cone_packed dot test {out['dot']:.3g}")
    # the plain composition around the pair's plan (no kernel)
    plan = ConePackedPlan(geom)
    plain_fp = fp_par.fp_packed(x, plan, torch.float32,
                                lambda g: fp_par.fp_lanes_plain(g, plan))
    plain_bp = fp_par.bp_packed(y, plan, torch.float32,
                                lambda q: fp_par.bp_lanes_plain(q, plan))
    out["fp_rel_err"], out["bp_rel_err"] = rel_err(ax, plain_fp), rel_err(aty, plain_bp)
    check(out["fp_rel_err"] <= F32_TOL and out["bp_rel_err"] <= F32_TOL,
          f"cone_packed kernel vs plain: FP {out['fp_rel_err']:.3g}, BP "
          f"{out['bp_rel_err']:.3g} > {F32_TOL}")
    del plain_fp, plain_bp, aty
    xg = (0.5 * x).requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - ax) ** 2), xg)
    expected = proj.T(proj(xg.detach()) - ax)
    out["grad_rel_err"] = rel_err(grad, expected)
    check(torch.allclose(grad, expected, rtol=1e-4,
                         atol=1e-5 * float(expected.abs().max())),
          f"cone_packed gradient != A^T(Ax - y) (rel {out['grad_rel_err']:.3g})")
    del grad, expected, xg
    out["fp_ms"] = cuda_ms(torch, lambda: proj(x), reps=5)
    out["bp_ms"] = cuda_ms(torch, lambda: proj.T(ax), reps=5)
    launches = K.launches()
    cone = {k: v for k, v in launches.items() if "cone" in k or "modular" in k}
    check(not any(cone.values()), f"cone_packed launched cone kernels: {cone}")
    out["launches"] = launches
    results["cone_packed"] = out
    log(f"cone_packed (512x512x8, 720 views, batch 8, 64 lanes): mode {mode}; "
        f"kernel vs plain FP {out['fp_rel_err']:.3g}, BP {out['bp_rel_err']:.3g}; "
        f"dot {out['dot']:.3g}; gradient rel {out['grad_rel_err']:.3g}; pair FP "
        f"{out['fp_ms']:.3f} ms, BP {out['bp_ms']:.3f} ms; Table-1 cone: {t1}")


def cone_packed_exact(torch, results, launches) -> None:
    """The packed pair against the exact cone pair on the same batch: its
    relative L2 error within ``cone_packed_error_bound``, and the exact
    pair's times beside the packed pair's."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.kernels.fp_cone import cone_packed_error_bound
    t = time.perf_counter()
    geom = cone_packed_geometry()
    out = results["cone_packed"]
    x = helical_phantoms(torch, geom.vol)
    packed = Projector(ProjectorSpec(geom))
    exact = Projector(ProjectorSpec(geom, mode="exact"))
    yp, ye = packed(x), exact(x)
    out["rel_l2_vs_exact"] = float((yp - ye).norm() / ye.norm())
    out["error_bound"] = cone_packed_error_bound(geom)
    del yp
    out["exact_fp_ms"] = cuda_ms(torch, lambda: exact(x), reps=3, warmup=1)
    out["exact_bp_ms"] = cuda_ms(torch, lambda: exact.T(ye), reps=3, warmup=1)
    out["path_launches"] = launches
    del ye, x
    torch.cuda.empty_cache()
    results["phase_s"]["cone_packed vs exact"] = time.perf_counter() - t
    log(f"cone_packed vs the exact cone pair: rel L2 {out['rel_l2_vs_exact']:.4g} "
        f"(bound {out['error_bound']:.4g}); exact FP {out['exact_fp_ms']:.3f} ms, "
        f"BP {out['exact_bp_ms']:.3f} ms; packed FP {out['fp_ms']:.3f} ms, BP "
        f"{out['bp_ms']:.3f} ms")
    check(out["rel_l2_vs_exact"] <= out["error_bound"],
          f"cone_packed vs exact {out['rel_l2_vs_exact']:.4g} > bound "
          f"{out['error_bound']:.4g}")


def joseph_geometries():
    """The Joseph projectors at test sizes: parallel, cone on a flat and a
    curved detector, and modular frames on two tilted arcs (which the SF
    kernels do not cover, so ``model="sf"`` runs them on Joseph too)."""
    from repro_torch import VolumeGeometry, cone_beam, modular_beam, parallel_beam
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    src = np.stack([60 * np.cos(ang), 60 * np.sin(ang), 12 * 0.15 * np.sin(2 * ang)], -1)
    eu = np.stack([-np.sin(ang), np.cos(ang), np.zeros_like(ang)], -1)
    ev = np.cross(src / np.linalg.norm(src, axis=1, keepdims=True), eu)
    cone = dict(sod=80.0, sdd=160.0, pixel_width=1.5, pixel_height=1.5)
    return {
        "parallel": ("joseph", parallel_beam(10, 5, 20, VolumeGeometry(12, 14, 4),
                                             pixel_width=1.3, pixel_height=1.1)),
        "cone_flat": ("joseph", cone_beam(10, 6, 24, VolumeGeometry(12, 14, 4), **cone)),
        "cone_curved": ("joseph", cone_beam(10, 6, 24, VolumeGeometry(12, 14, 4),
                                            detector_type="curved", **cone)),
        "modular_tilted": ("sf", modular_beam(src, -src, eu, ev, n_rows=8, n_cols=20,
                                              vol=VolumeGeometry(12, 12, 6),
                                              pixel_width=2.0, pixel_height=2.0)),
    }


def joseph_path(torch, results):
    """The Joseph projectors on card tensors through ``backend="auto"``: no
    kernel pair exists for them, so the plain pair runs on the card (and no
    kernel counter moves); dot test, gradient = backprojection, the result
    on the card and equal to the host's on the same inputs."""
    from repro_torch import Projector, ProjectorSpec
    out = {}
    for name, (model, geom) in joseph_geometries().items():
        gen = torch.Generator().manual_seed(8)
        x = torch.randn((2,) + geom.vol.shape, generator=gen)
        y = torch.randn((2,) + geom.sino_shape, generator=gen)
        proj = Projector(ProjectorSpec(geom, model=model))
        xc, yc = x.cuda(), y.cuda()
        ax, aty = proj(xc), proj.T(yc)
        check(ax.device.type == "cuda" and aty.device.type == "cuda",
              f"joseph {name}: left the card")
        lhs, rhs = vdot64(ax, yc), vdot64(xc, aty)
        dot = abs(lhs - rhs) / abs(lhs)
        xg = xc.clone().requires_grad_()
        (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - yc) ** 2), xg)
        gerr = rel_err(grad, proj.T(ax - yc))
        host = Projector(ProjectorSpec(geom, model=model), device="cpu")
        vs_host = max(rel_err(ax.cpu(), host(x)), rel_err(aty.cpu(), host.T(y)))
        out[name] = {"dot": dot, "grad_rel_err": gerr, "vs_host": vs_host}
        log(f"joseph {name} on the card: dot {dot:.3g}, gradient rel {gerr:.3g}, "
            f"vs the host {vs_host:.3g}")
        check(dot < 1e-4, f"joseph {name} dot test {dot:.3g}")
        check(gerr < 1e-4, f"joseph {name} gradient vs backprojection {gerr:.3g}")
        check(vs_host < 2e-4, f"joseph {name} card vs host {vs_host:.3g}")
    results["joseph"] = out


ITER_IMG_TOL = 5e-4      # card vs host images, as tests/test_torch_solvers.py
ITER_CUT = dict(n_cgls=3, n_fista=3, verbose=False)
# The host's run of the cut (~40 s of CPU work) runs in a process of its
# own beside the card's phases, on this many threads
ITER_HOST_THREADS = 4


def iterative_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "iterative_recon_torch", ROOT / "examples" / "iterative_recon_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def iterative_host_child(torch, out: pathlib.Path) -> int:
    """The process of ``start_iterative_host``: the example's cut on the
    host, its images, PSNRs and seconds written to ``out``."""
    torch.set_num_threads(ITER_HOST_THREADS)
    t = time.perf_counter()
    host = iterative_example().main("cpu", **ITER_CUT)
    host["host_cut_s"] = time.perf_counter() - t
    torch.save(host, out)
    return 0


def start_iterative_host():
    """Start the host's run of the iterative_recon cut in a process of its
    own (``chip_smoke.py --iterative-host FILE``), stopped at exit if still
    running; returns (process, FILE)."""
    out = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_iter_")) / "host.pt"
    atexit.register(shutil.rmtree, out.parent, True)
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--iterative-host", str(out)])
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def iterative_recon_path(torch, results, host_run):
    """examples/iterative_recon_torch.py on the card (CGLS-25, FISTA-TV-40 on
    the exact cone kernels; CGLS-25 on Joseph for the tilted arcs), then at
    3 iterations each on the card and on the host with the same inputs
    (``host_run``: start_iterative_host's process, which ran beside the
    card's phases): the images agree within ITER_IMG_TOL (relative L2)."""
    ex = iterative_example()
    full, t_full = host_s(torch, lambda: ex.main("cuda", verbose=False))
    out = {"psnr": full["psnr"], "card_s": t_full}
    log("iterative_recon on the card: " + ", ".join(
        f"{k} PSNR {v:.2f} dB" for k, v in full["psnr"].items())
        + f" ({t_full:.2f} s)")
    card = ex.main("cuda", **ITER_CUT)
    proc, path = host_run
    t = time.perf_counter()
    check(proc.wait(timeout=900) == 0, f"iterative_recon: the host's run exited "
                                       f"{proc.returncode}")
    out["host_wait_s"] = time.perf_counter() - t
    host = torch.load(path, weights_only=False)   # written by our own child
    out["host_cut_s"] = host["host_cut_s"]
    for k in ("cgls", "fista_tv", "modular_cgls"):
        a, b = card[k].double().cpu(), host[k].double()
        out[f"{k}_card_vs_host"] = float((a - b).norm() / b.norm())
    out["psnr_cut"] = {"card": card["psnr"], "host": host["psnr"]}
    results["iterative_recon"] = out
    log("iterative_recon at 3 iterations, card vs host: " + ", ".join(
        f"{k} {out[f'{k}_card_vs_host']:.3g}" for k in ("cgls", "fista_tv",
                                                        "modular_cgls"))
        + f" (host {out['host_cut_s']:.1f} s on {ITER_HOST_THREADS} threads beside the "
        f"card's phases, {out['host_wait_s']:.1f} s waited)")
    for k in ("cgls", "fista_tv", "modular_cgls"):
        check(out[f"{k}_card_vs_host"] < ITER_IMG_TOL,
              f"iterative_recon {k}: card vs host {out[f'{k}_card_vs_host']:.3g}")


PORT_KERNEL = re.compile(r"_sf_kernel|flash_\w*kernel")


def profiled(torch, fn, reps: int):
    """``fn`` ``reps`` times in a torch.profiler window.  Returns the device
    kernels as ``(us per call, name)`` sorted longest first, the window's
    wall time in us, and the port's kernel events the profiler recorded
    against the launches the wrappers counted in the window (a profiler
    session that follows many others in one process can lose kernel events;
    ``events_complete`` is false then)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    before = sum(K.launches().values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    launched = sum(K.launches().values()) - before
    rows, seen = [], 0
    for ev in prof.key_averages():
        # device-side events only: the CPU op that launched a kernel also
        # reports that kernel's time as its own
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        rows.append((us / reps, ev.key))
        if PORT_KERNEL.search(ev.key):
            seen += ev.count
    rows.sort(reverse=True)
    return rows, wall_us, {"port_kernel_events": seen, "port_kernel_launches": launched,
                           "events_complete": seen == launched}


def events_note(events: dict) -> str:
    if events["events_complete"]:
        return ""
    return (f" (INCOMPLETE: the profiler saw {events['port_kernel_events']} of "
            f"{events['port_kernel_launches']} kernel launches)")


def breakdown(torch, name: str, fn, results, reps: int = 3,
              ms_reps: int = 5, warmup: int = 1) -> None:
    """Where the time of ``fn`` goes: its median device time (CUDA events),
    then a torch.profiler window over ``reps`` calls — device time by
    kernel and the device's busy share of the window's wall time."""
    ms = cuda_ms(torch, fn, reps=ms_reps, warmup=warmup)
    rows, wall_us, events = profiled(torch, fn, reps)
    busy = sum(us for us, _ in rows) * reps / wall_us
    results.setdefault("breakdown", {})[name] = {
        "ms": ms, "device_busy_share": busy, **events,
        "device_us_per_call": [[k[:60], us] for us, k in rows[:10]]}
    log(f"breakdown {name}: {ms:.3f} ms per call, device busy {busy:.3f} of the "
        f"profiled window" + ("" if rows else " (profiler saw no device time)")
        + events_note(events))
    for us, k in rows[:6]:
        log(f"  {us / 1e3:9.3f} ms  {k[:60]}")


def profile_cells(torch, results) -> None:
    """Device-time breakdown of the main, fan, helical and cone_packed
    cells' projector pair (one training step's A then A^T on the batch of
    8) and of the 3D and cone cells' FP and BP."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.data.phantoms import random_ellipse_phantom
    vol = main_geometry().vol
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, vol)[0]
                                   for s in range(8)])[..., None]).cuda()
    for name, geom in (("main_pair", main_geometry()),
                       ("fan_pair", fan_geometry("flat"))):
        proj = Projector(ProjectorSpec(geom))
        y = proj(x)
        breakdown(torch, name, lambda: proj.T(proj(x) - y), results)
        del y
    del x
    proj = Projector(ProjectorSpec(helical_geometry()))
    xh = helical_phantoms(torch, proj.geom.vol)
    yh = proj(xh)
    breakdown(torch, "helical_pair", lambda: proj.T(proj(xh) - yh), results,
              reps=2, ms_reps=3)
    del xh, yh
    packed = Projector(ProjectorSpec(cone_packed_geometry()))
    xp = helical_phantoms(torch, packed.geom.vol)
    yp = packed(xp)
    breakdown(torch, "cone_packed_pair", lambda: packed.T(packed(xp) - yp), results)
    del xp, yp
    # the kernels are warm from their paths; the cone's take ~4 s a call
    for name, geom, reps, ms_reps in (
            ("3d", table1("parallel_512_180"), 2, 3),
            ("cone", cone_geometry(), 1, 1)):
        proj3 = Projector(ProjectorSpec(geom))
        x3 = torch.rand(geom.vol.shape, device="cuda")
        breakdown(torch, f"{name}_fp", lambda: proj3(x3), results, reps=reps,
                  ms_reps=ms_reps, warmup=0)
        y3 = proj3(x3)
        del x3
        breakdown(torch, f"{name}_bp", lambda: proj3.T(y3), results, reps=reps,
                  ms_reps=ms_reps, warmup=0)
        del y3
        torch.cuda.empty_cache()


def instance_times(torch, results) -> None:
    """One sample of the helical cell through both instances of each
    modular kernel: the single-sample one that the wrappers pick for batch
    1, and the one that carries 8 samples per thread (batch > 1), which sums
    the same terms in the same order.  The launches count in a local tally,
    not in the kernels' counts."""
    from repro_torch.kernels import fp_cone, fp_modular
    geom = helical_geometry()
    plan = fp_modular.ModularPlan(geom)
    tally = {"fp_modular_sf": 0, "bp_modular_sf": 0}
    x = helical_phantoms(torch, geom.vol, seeds=(0,))
    y = fp_cone.launch("fp_modular", "fp_modular_sf", x, plan, tally, spt=1)
    out = {}
    for kname, inp in (("fp_modular_sf", x), ("bp_modular_sf", y)):
        got = {}
        for spt in (1, 8):
            def run(kname=kname, inp=inp, spt=spt):
                return fp_cone.launch("fp_modular", kname, inp, plan, tally, spt=spt)
            got[spt] = run()
            out[f"{kname}_spt{spt}_ms"] = cuda_ms(torch, run, reps=3, warmup=1)
        rel = rel_err(got[8], got[1])
        out[f"{kname}_bit_equal"] = bool(torch.equal(got[8], got[1]))
        check(rel < 1e-6, f"{kname} batch 1: 8-sample instance vs 1-sample {rel:.3g}")
        was = (f" (15I: {FP_15I_PATH_MS['fp_modular_sf_spt1']:.1f} and "
               f"{FP_15I_PATH_MS['fp_modular_sf_spt8']:.1f})" if kname == "fp_modular_sf"
               else f" (parent: {BP_PARENT_PATH_MS['bp_modular_sf_spt1']:.1f} and "
               f"{BP_PARENT_PATH_MS['bp_modular_sf_spt8']:.1f})")
        log(f"{kname} batch 1 on the helical cell: 1 sample per thread "
            f"{out[f'{kname}_spt1_ms']:.1f} ms, 8 per thread "
            f"{out[f'{kname}_spt8_ms']:.1f} ms{was} (bit-equal "
            f"{out[f'{kname}_bit_equal']})")
    results["instances"] = out


def attn_pairs(S: int, window) -> int:
    """Kept (query, key) pairs of one causal head, with the window if any."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def fp_build_report(results) -> None:
    """ptxas's registers and spills of the cone-family FP instances (from
    the build's log) and, on this card, each one's tile, dynamic shared
    memory a block and resident blocks per SM at the cone cell (cone
    kernels) and the helical cell (modular kernels)."""
    import re
    import torch
    from repro_torch.kernels import build, fp_cone, fp_modular
    plans = {"fp_cone": fp_cone.ConePlan(cone_geometry()),
             "fp_modular": fp_modular.ModularPlan(helical_geometry())}
    rows = {}
    for lib, plan in plans.items():
        for mangled, rep in build.ptxas_report(lib).items():
            m = re.search(rf"({lib}_sf_kernel)I(f|13__nv_bfloat16)Li(\d)E", mangled)
            if not m:
                continue
            dtype = torch.float32 if m.group(2) == "f" else torch.bfloat16
            spt = int(m.group(3))
            key = f"{m.group(1)}<{str(dtype)[6:]}, {spt}>"
            rows[key] = dict(rep, **fp_cone.fp_info(lib, plan, dtype, spt))
    check(len(rows) == 8, f"ptxas report of the cone-family FP kernels: {sorted(rows)}")
    results["fp_sf_build"] = rows
    for k, r in sorted(rows.items()):
        log(f"ptxas {k}: {r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['spill_loads']} bytes spill loads, {r['stack']} bytes stack; "
            f"tile {r['tile_rows']} x {r['tile_cols']}, {r['smem_bytes']} bytes dynamic "
            f"shared a block, {r['blocks_per_sm']} blocks per SM")


def par_build_report(results) -> None:
    """ptxas's registers and spills of the 8 parallel kernel instances (FP
    and BP, f32 and bf16, 8 or 16 lanes a thread) and, on this card, at the
    main and 512^3 cells' layouts (the parallel heuristic of each dtype),
    for the cell that runs each instance: threads a block, dynamic shared
    memory (the kernel's count, which the FP checks against the host's) and
    resident blocks per SM."""
    import re
    import torch
    from repro_torch.kernels import build, fp_par, tune
    cells = {"main": (main_geometry(), 8), "3d": (table1("parallel_512_180"), 1)}
    rows = {}
    for mangled, rep in build.ptxas_report("fp_par").items():
        m = re.search(r"([fb]p_par_sf_kernel)I(f|13__nv_bfloat16)Li(\d+)E", mangled)
        if not m:
            continue
        fp = m.group(1).startswith("fp")
        dtype = torch.float32 if m.group(2) == "f" else torch.bfloat16
        lpt = int(m.group(3))
        key = f"{m.group(1)}<{str(dtype)[6:]}, lpt={lpt}>"
        row = dict(rep)
        for cell, (geom, batch) in cells.items():
            plan = fp_par.ParallelPlan(geom)
            cfg = tune.parallel_config(geom, batch)
            lay = plan.fp_layout(0, dtype, cfg) if fp else plan.bp_layout(cfg)
            if lay.lpt != lpt:
                row[cell] = None          # the cell runs the other instance
                continue
            if fp:
                threads, info = lay.tu * lay.tl * lay.nvb, fp_par.fp_info(lay, dtype)
                shape = (f"{lay.tu} columns x {lay.tl * lay.lpt} lanes x "
                         f"{lay.nvb} views, {lay.lch} lines")
            else:
                threads, info = lay.bx * lay.by * lay.tl, fp_par.bp_info(lay, dtype)
                shape = f"{lay.bx} x {lay.by} voxels x {lay.tl * lay.lpt} lanes"
            row[cell] = {"tile": shape, "threads": threads, **info}
        check(any(row[cell] for cell in cells), f"{key}: no cell runs it")
        rows[key] = row
    check(len(rows) == 8, f"ptxas report of the parallel kernels: {sorted(rows)}")
    results["par_sf_build"] = rows
    for k, r in sorted(rows.items()):
        log(f"ptxas {k}: {r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['spill_loads']} bytes spill loads, {r['stack']} bytes stack; "
            + "; ".join(f"{cell}: {r[cell]['tile']}, {r[cell]['threads']} threads, "
                        f"{r[cell]['smem_bytes']} bytes dynamic shared, "
                        f"{r[cell]['blocks_per_sm']} blocks per SM"
                        for cell in cells if r[cell]))


def fan_build_report(results) -> None:
    """ptxas's registers and spills of the 16 fan kernel instances (FP and
    BP, f32 and bf16, flat and curved, 8 or 16 lanes a thread) and, on this
    card, at the layout of each fan cell that runs the instance (the fan
    heuristic): its tile, threads a block, dynamic shared memory (the
    kernel's count, which the FP checks against the host's) and resident
    blocks per SM."""
    import re
    import torch
    from repro_torch.kernels import build, fp_fan, tune
    if not hasattr(fp_fan, "fp_info"):     # a tree from before the redesign
        log("fan build report: this tree's fan pair has no layouts; skipped")
        return
    cells = {"fan": (fan_geometry("flat"), 8), "fan_curved": (fan_geometry("curved"), 8),
             "fan_rows": (fan_rows_geometry(), 4)}
    rows = {}
    for mangled, rep in build.ptxas_report("fp_fan").items():
        m = re.search(r"([fb]p_fan_sf_kernel)I(f|13__nv_bfloat16)Lb([01])ELi(\d+)E",
                      mangled)
        if not m:
            continue
        fp, curved = m.group(1).startswith("fp"), m.group(3) == "1"
        dtype = torch.float32 if m.group(2) == "f" else torch.bfloat16
        lpt = int(m.group(4))
        key = f"{m.group(1)}<{str(dtype)[6:]}, {'curved' if curved else 'flat'}, lpt={lpt}>"
        row = dict(rep)
        for cell, (geom, batch) in cells.items():
            plan = fp_fan.FanPlan(geom)
            cfg = tune.heuristic_config(geom, batch)
            lay = plan.fp_layout(0, dtype, cfg) if fp else plan.bp_layout(cfg)
            if lay.lpt != lpt or plan.curved != curved:
                continue                  # the cell runs another instance
            if fp:
                threads, info = lay.tu * lay.tl, fp_fan.fp_info(lay, dtype, curved)
                shape = (f"{lay.tu} columns x {lay.tl * lay.lpt} lanes, {lay.vcap} "
                         f"voxels a piece")
            else:
                threads = lay.bx * lay.by * lay.tl
                info = fp_fan.bp_info(lay, dtype, curved, geom.n_cols)
                shape = f"{lay.bx} x {lay.by} voxels x {lay.tl * lay.lpt} lanes"
            row[cell] = {"tile": shape, "threads": threads, **info}
        rows[key] = row
    check(len(rows) == 16, f"ptxas report of the fan kernels: {sorted(rows)}")
    results["fan_sf_build"] = rows
    for k, r in sorted(rows.items()):
        log(f"ptxas {k}: {r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['spill_loads']} bytes spill loads, {r['stack']} bytes stack"
            + "".join(f"; {cell}: {r[cell]['tile']}, {r[cell]['threads']} threads, "
                      f"{r[cell]['smem_bytes']} bytes dynamic shared, "
                      f"{r[cell]['blocks_per_sm']} blocks per SM"
                      for cell in cells if cell in r))


# Pairs on which the fan kernels' division is held against __fdiv_rn.
FAN_DIV_PAIRS = 1 << 28


def fan_division_check(torch, results) -> None:
    """The fan kernels divide by 2 (t1 - t0), 2 (t3 - t2) and the pixel
    width without a division instruction (csrc/fp_fan.cu ``fan_div_rn``):
    FAN_DIV_PAIRS pseudo-random (overlap, divisor) pairs over the divisors
    the weights take must give __fdiv_rn's bits."""
    from repro_torch.kernels import fp_fan
    if not hasattr(fp_fan, "division_mismatches"):   # from before the redesign
        log("fan division check: this tree's fan pair divides by __fdiv_rn; skipped")
        return
    t = time.perf_counter()
    bad = fp_fan.division_mismatches(1, FAN_DIV_PAIRS)
    results["fan_division"] = {"pairs": FAN_DIV_PAIRS, "mismatches": bad,
                               "s": time.perf_counter() - t}
    log(f"fan division against __fdiv_rn on {FAN_DIV_PAIRS} pairs: {bad} differ "
        f"({time.perf_counter() - t:.2f} s)")
    check(bad == 0, f"fan division differs from __fdiv_rn on {bad} pairs")


def bp_build_report(results) -> None:
    """ptxas's registers and spills of the eight cone-family BP instances
    (from the build's log) and, on this card, each one's block, z slices a
    thread and resident blocks per SM (its shared memory is static)."""
    import re
    import torch
    from repro_torch.kernels import build, fp_cone
    rows = {}
    for lib in ("fp_cone", "fp_modular"):
        fam = lib.split("_")[1]
        for mangled, rep in build.ptxas_report(lib).items():
            m = re.search(rf"(bp_{fam}_sf_kernel)I(f|13__nv_bfloat16)Li(\d)E", mangled)
            if not m:
                continue
            dtype = torch.float32 if m.group(2) == "f" else torch.bfloat16
            spt = int(m.group(3))
            key = f"{m.group(1)}<{str(dtype)[6:]}, {spt}>"
            rows[key] = dict(rep, **fp_cone.bp_info(lib, dtype, spt))
    check(len(rows) == 8, f"ptxas report of the cone-family BP kernels: {sorted(rows)}")
    results["bp_sf_build"] = rows
    for k, r in sorted(rows.items()):
        log(f"ptxas {k}: {r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['spill_loads']} bytes spill loads, {r['stack']} bytes stack, "
            f"{r['smem']} bytes static shared; {r['threads']} threads, "
            f"{r['z_slices_a_thread']} z slices a thread, {r['blocks_per_sm']} blocks per SM")


# Detector row pitches (mm) at which the cone-family FP's division is held
# against __fdiv_rn: the cells' (2, 1.5), powers of two, published
# flat-panel and CT detector pitches (0.1, 0.127, 0.139, 0.2, 0.388,
# 0.625, 0.75), and both ends of the range the kernel accepts.
FP_DIV_PITCHES = (2.0, 1.5, 1.0, 0.5, 0.1, 0.127, 0.139, 0.2, 0.388, 0.625,
                  0.75, 1.2, 2.0 ** -20, 3.0 * 2.0 ** -21, 2.0 ** 20,
                  1.75 * 2.0 ** 19)


def fp_division_check(torch, results) -> None:
    """The cone-family FP divides each overlap by the row pitch without a
    division instruction (csrc/cone_sf.cuh ``sf_div_rn``): at each pitch of
    FP_DIV_PITCHES, every float overlap with a normal quotient must give
    __fdiv_rn's bits."""
    from repro_torch.kernels import fp_cone
    t = time.perf_counter()
    bad = {dv: fp_cone.division_mismatches(dv) for dv in FP_DIV_PITCHES}
    torch.cuda.synchronize()
    results["fp_division"] = {"pitches": list(FP_DIV_PITCHES),
                              "mismatches": list(bad.values()),
                              "s": time.perf_counter() - t}
    log(f"FP division against __fdiv_rn at {len(bad)} pitches, every float "
        f"overlap with a normal quotient: {sum(bad.values())} differ "
        f"({time.perf_counter() - t:.2f} s)")
    check(not any(bad.values()), f"FP division differs from __fdiv_rn: {bad}")


# The kernel-phase cells whose FP is profiled by phase (fp_phases).
FP_PHASE_CELLS = ("cone128", "cone128_dv1.5", "modular_wobbly",
                  "modular_wobbly_dv1.5", "cone", "helical_cut")
FP_PHASES = ("classify", "wu", "pairs", "sum")


def fp_phases(torch, cells, results) -> None:
    """Where the cone-family FP's cycles go, from its build with the phase
    profile compiled in (csrc/cone_sf.cuh SF_FP_PHASES): per cell of
    FP_PHASE_CELLS, the instrumented kernel's time, each phase's share of
    thread 0's cycles summed over the blocks, and per pass the survivors,
    (survivor, slice) pairs and classification rounds."""
    import ctypes
    from repro_torch.kernels import build, fp_cone
    fams = families()
    out = {}
    for cell in FP_PHASE_CELLS:
        if cell not in cells:
            continue
        c = cells[cell]
        lib = f"fp_{c.family}"
        kname = f"{lib}_sf"
        plan = fams[c.family]["plan"](c.geom)
        x = c.make_x()
        read = getattr(build.library(lib, "phases"), f"{lib}_phases_read")
        sums = (ctypes.c_ulonglong * 8)()

        def run():
            return fp_cone.launch(lib, kname, x, plan, {kname: 0},
                                  variant="phases")

        run()
        torch.cuda.synchronize()
        build.check(lib, read(sums), "phases read")          # zero the sums
        run()
        torch.cuda.synchronize()
        build.check(lib, read(sums), "phases read")
        v = list(sums)
        cycles = max(sum(v[:4]), 1)
        passes = max(v[4], 1)
        row = {"ms": cuda_ms(torch, run, reps=5, warmup=1),
               "shares": {p: v[i] / cycles for i, p in enumerate(FP_PHASES)},
               "passes": v[4], "survivors_a_pass": v[5] / passes,
               "pairs_a_pass": v[6] / passes, "rounds_a_pass": v[7] / passes,
               "cycles_a_pass": cycles / passes}
        out[cell] = row
        log(f"fp phases {cell}: {row['ms']:.3f} ms (instrumented); cycle shares "
            + ", ".join(f"{p} {x:.3f}" for p, x in row["shares"].items())
            + f"; {v[4]} passes, a pass {row['survivors_a_pass']:.1f} survivors, "
            f"{row['pairs_a_pass']:.1f} (survivor, slice) pairs, "
            f"{row['rounds_a_pass']:.2f} rounds")
        del x
    results["fp_phases"] = out


BP_PHASES = ("axial", "trapezoid", "columns")


def bp_phases(torch, cells, results) -> None:
    """Where the cone-family BP's cycles go, from its build with the phase
    profile compiled in (csrc/cone_sf.cuh SF_BP_PHASES): per cell of
    FP_PHASE_CELLS, the instrumented kernel's time, each phase's share of
    every thread's cycles in its view loop, the share of thread-views
    dropped before their trapezoid, and per thread-view that reached it the
    columns with wu != 0 and the (column, slice, row) terms."""
    import ctypes
    from repro_torch.kernels import build, fp_cone
    fams = families()
    out = {}
    for cell in FP_PHASE_CELLS:
        if cell not in cells:
            continue
        c = cells[cell]
        lib = f"fp_{c.family}"
        kname = f"bp_{c.family}_sf"
        plan = fams[c.family]["plan"](c.geom)
        y = fams[c.family]["fp"](c.make_x(), plan)
        read = getattr(build.library(lib, "phases"), f"{lib}_phases_read")
        sums = (ctypes.c_ulonglong * 8)()

        def run():
            return fp_cone.launch(lib, kname, y, plan, {kname: 0}, variant="phases")

        run()
        torch.cuda.synchronize()
        build.check(lib, read(sums), "phases read")          # zero the sums
        run()
        torch.cuda.synchronize()
        build.check(lib, read(sums), "phases read")
        v = list(sums)
        cycles = max(sum(v[:3]), 1)
        reached = max(v[4], 1)
        row = {"ms": cuda_ms(torch, run, reps=5, warmup=1),
               "shares": {p: v[i] / cycles for i, p in enumerate(BP_PHASES)},
               "thread_views": v[4] + v[5],
               "dropped_share": v[5] / max(v[4] + v[5], 1),
               "columns_a_view": v[6] / reached, "terms_a_view": v[7] / reached}
        out[cell] = row
        log(f"bp phases {cell}: {row['ms']:.3f} ms (instrumented); cycle shares "
            + ", ".join(f"{p} {x:.3f}" for p, x in row["shares"].items())
            + f"; {row['thread_views']} thread-views, {row['dropped_share']:.3f} dropped "
            f"before the trapezoid, a view {row['columns_a_view']:.2f} columns, "
            f"{row['terms_a_view']:.2f} terms")
        del y
    results["bp_phases"] = out


def flash_build_report(torch, results) -> None:
    """ptxas's registers, spills and coded notes of every flash kernel
    instance (from the build's log) and, on this card, its dynamic shared
    memory (the kernel's own count, which ``flash.kernel_info`` holds
    against the host's) and resident blocks per SM.  Fails on any ptxas
    note (``build.parse_ptxas``) of a bf16 instance, such as a serialized
    wgmma or an ignored setmaxnreg.  The warp-specialised forward's
    registers are ptxas's count at entry; its setmaxnreg values are
    printed beside them."""
    import re
    from repro_torch.kernels import build, flash
    rows, stray = {}, []
    for mangled, rep in build.ptxas_report("flash").items():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv))(_tc|_ws)?_kernelIf?Li(\d+)E"
                      r"(?:Lb([01])E)?", mangled)
        if m:
            kname = "flash_fwd_stats" if m.group(4) == "1" else m.group(1)
            dtype = "bfloat16" if m.group(2) else "float32"
            rows[(kname, dtype, int(m.group(3)))] = dict(rep)
        elif rep.get("notes"):
            stray += [f"{mangled or 'no kernel'}: {n}" for n in rep["notes"]]
    for kname in flash.KERNELS:
        for dtype in ("float32", "bfloat16"):
            for hd in flash.KERNEL_HEAD_DIMS:
                row = rows.setdefault((kname, dtype, hd), {})
                row.update(flash.kernel_info(kname, getattr(torch, dtype), hd))
                if (dtype == "bfloat16" and kname.startswith("flash_fwd")
                        and flash.fwd_specialised(hd)):
                    row["setmaxnreg"] = {"producer": flash.FWD_PRODUCER_REGS,
                                         "consumers": flash.FWD_CONSUMER_REGS}
    check(len(rows) == 2 * len(flash.KERNELS) * len(flash.KERNEL_HEAD_DIMS)
          and all("registers" in r for r in rows.values()),
          f"ptxas report of the flash kernels: {sorted(rows)}")
    results["flash_build"] = {f"{k} {dt} hd {hd}": v
                              for (k, dt, hd), v in sorted(rows.items())}
    for (k, dt, hd), r in sorted(rows.items()):
        regs = r.get("setmaxnreg")
        log(f"ptxas {k} {dt} hd {hd}: {r['registers']} registers"
            + (f" at entry (setmaxnreg: producer {regs['producer']}, consumers "
               f"{regs['consumers']})" if regs else "")
            + f", {r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes "
            f"spill loads, {r['stack']} bytes stack; {r['smem_bytes']} bytes dynamic "
            f"shared a block, {r['blocks_per_sm']} blocks per SM")
        for note in r.get("notes", []):
            log(f"ptxas note {k} {dt} hd {hd}: {note}")
    for note in stray:
        log(f"ptxas note {note}")
    noted = [f"{k} {dt} hd {hd}" for (k, dt, hd), r in sorted(rows.items())
             if dt == "bfloat16" and r.get("notes")]
    check(not noted and not stray,
          f"ptxas notes on the bf16 flash instances {noted} {stray}")


def flash_phase(torch, results):
    """The four flash kernels against their plain versions (the chunked
    attention and ``flash_bwd_plain``) on the card, with times, bounds and
    the library call's."""
    from repro_torch.kernels import flash
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for cell, (B, H, KV, S, hd, window, dtypes) in FLASH_CELLS.items():
        t_cell = time.perf_counter()
        pairs = B * H * attn_pairs(S, window)
        mask = None
        if window is not None:                  # the library call's mask
            pos = torch.arange(S, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        for name in dtypes:
            dt = getattr(torch, name)
            tol = flash.KERNEL_TOL[dt]
            gen = torch.Generator(device="cuda").manual_seed(7)
            q, k, v = (torch.randn((B, n, S, hd), generator=gen, device="cuda").to(dt)
                       for n in (H, KV, KV))
            do = torch.randn((B, H, S, hd), generator=gen, device="cuda").to(dt)
            esz = q.element_size()
            nq, nkv, nrow = q.numel() * esz, k.numel() * esz, B * H * S * 4
            # the plain forward: its time at the reference's 1024 chunk, the
            # check's output at the kernels' tile (the same running maxima)
            with torch.no_grad():
                plain_fwd_ms = cuda_ms(torch, lambda: flash.flash_attention_plain(
                    q, k, v, window), reps=3, warmup=1)
                p_o, p_lse = flash.flash_attention_plain(
                    q, k, v, window, chunk=flash.KERNEL_TILE, return_lse=True)
                # the check must see one key too few at each row's window
                # edge (or, causal, the first keys of the last 64 rows)
                short = flash.flash_attention_plain(
                    q, k, v, (window or S - 63) - 1, chunk=flash.KERNEL_TILE)
            seen = flash.kernel_mismatch(short, p_o, *tol)
            log(f"flash {cell} {name}: one key short at the window edge "
                f"scores {seen:.3g} (> 1 fails)")
            check(seen > 1, f"flash {cell} {name}: the check misses a one-key "
                            f"window error ({seen:.3g})")
            del short
            # the library call: forward, and its autograd backward
            lib_kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
            with torch.no_grad():
                lib_fwd_ms = cuda_ms(torch, lambda: sdpa(q, k, v, enable_gqa=True, **lib_kw))
            largs = [t.clone().requires_grad_() for t in (q, k, v)]
            l_o = sdpa(*largs, enable_gqa=True, **lib_kw)
            lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                l_o, largs, do, retain_graph=True), reps=5)
            del largs, l_o
            o, lse = flash.flash_fwd_with_stats(q, k, v, window)
            delta = flash.flash_delta(o, do)
            # the plain backward, on the kernels' own lse and delta
            p_grads = flash.flash_bwd_plain(q, k, v, do, lse, delta, window)
            plain_bwd_ms = cuda_ms(torch, lambda: flash.flash_bwd_plain(
                q, k, v, do, lse, delta, window), reps=3, warmup=1)
            runs = {
                "flash_fwd": (lambda: flash.flash_attention(q, k, v, window), (p_o,),
                              2, nq * 2 + 2 * nkv, plain_fwd_ms, lib_fwd_ms),
                "flash_fwd_stats": (lambda: flash.flash_fwd_with_stats(q, k, v, window),
                                    (p_o, p_lse), 2, nq * 2 + 2 * nkv + nrow,
                                    plain_fwd_ms, lib_fwd_ms),
                "flash_bwd_dq": (lambda: (flash.flash_bwd_dq(q, k, v, do, lse, delta, window),),
                                 p_grads[:1], 3, nq * 3 + 2 * nkv + 2 * nrow,
                                 plain_bwd_ms, lib_bwd_ms),
                "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, window),
                                  p_grads[1:], 4, nq * 2 + 4 * nkv + 2 * nrow,
                                  plain_bwd_ms, lib_bwd_ms),
            }
            for kname, (run, wants, products, nbytes, p_ms, l_ms) in runs.items():
                got = run()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                err = max(rel_err(g, w) for g, w in zip(got, wants))
                abs_err = max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, wants))
                # element by element, each output at its dtype's tolerance
                # (the lse rows are f32 in both)
                worst = max(flash.kernel_mismatch(g, w, *flash.KERNEL_TOL[g.dtype])
                            for g, w in zip(got, wants))
                check(all(bool(torch.isfinite(g).all()) for g in got),
                      f"{kname} {cell} {name}: non-finite")
                check(worst <= 1, f"{kname} {cell} {name}: |kernel - plain| is "
                                  f"{worst:.3g} x the allowed (rtol, atol) {tol}")
                del got
                ms = cuda_ms(torch, run, reps=10)
                ops = 2.0 * products * pairs * hd
                hbm, peak = peak_rates()
                t_bytes = nbytes / hbm * 1e3
                t_ops = ops / peak[name] * 1e3
                row = {"kernel": kname, "cell": cell, "dtype": name,
                       "shape": {"B": B, "H": H, "KV": KV, "S": S, "hd": hd,
                                 "window": window},
                       "rel_err": err, "max_abs_err": abs_err, "tol": tol,
                       "mismatch": worst,
                       "ms": ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "bytes": nbytes, "ops": ops,
                       "library_note": "scaled_dot_product_attention forward" if products == 2
                       else "scaled_dot_product_attention backward (dq, dk, dv together)",
                       "plain_note": "flash_attention_plain forward, chunk 1024" if products == 2
                       else "flash_bwd_plain (dq, dk, dv together) on the kernels' lse and delta"}
                if hd == 192 and name == "bfloat16":
                    row["ms_parent"] = FLASH_HD192_PARENT_MS.get(kname)
                results["kernels"].append(row)
                log(f"kernel {kname:15s} {cell:17s} {name:8s} rel_err {err:.3g} mismatch "
                    f"{worst:.3g} ms {ms:.4f} "
                    f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
                    f"{row['bound_ms']:.4f} ({row['bound_by']})"
                    + (f" parent_ms {row['ms_parent']}" if row.get("ms_parent") else ""))
            del runs, q, k, v, do, o, lse, delta, p_o, p_lse, p_grads
            torch.cuda.empty_cache()
        results["phase_s"][f"kernels {cell}"] = time.perf_counter() - t_cell


def lm_setup(torch):
    """Qwen3-0.6B at its published widths, random weights from seed 0."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get("qwen3-0.6b")
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    return cfg, params


def lm_tokens(torch, cfg, batch: int, seq: int, seed: int = 0):
    from repro_torch.data.tokens import TokenPipeline
    return torch.from_numpy(TokenPipeline(cfg.vocab_size, seq, batch, seed=seed)
                            .batch(0)).long().cuda()


def top2_gap(lg):
    top = lg.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def lm_prefill(torch, results, cfg, params):
    """Two 4096-token prompts through make_prefill_step; the same prefill
    with the plain attention."""
    from repro_torch.launch.steps import make_prefill_step
    toks = lm_tokens(torch, cfg, 2, 4096)
    prefill = make_prefill_step(cfg)
    lg, t_first = host_s(torch, lambda: prefill(params, {"tokens": toks}))
    check(tuple(lg.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
          f"lm_prefill logits shape {tuple(lg.shape)} / finite")
    plain = make_prefill_step(cfg, backend="ref")
    want, t_plain = host_s(torch, lambda: plain(params, {"tokens": toks}))
    rel = rel_err(lg, want)
    gap = top2_gap(want)
    err = float((lg.float() - want.float()).abs().max())
    same = (lg.argmax(-1) == want.argmax(-1))
    decided = gap > 2 * err
    results["lm_prefill"] = {"rel_err_vs_plain": rel, "max_abs_err": err,
                             "first_call_s": t_first, "plain_call_s": t_plain,
                             "argmax_equal": same.tolist(), "top2_gap": gap.tolist()}
    log(f"lm_prefill 2 x 4096: logits vs plain attention rel {rel:.3g} (tol "
        f"{LM_PREFILL_REL_TOL}), argmax equal {same.tolist()} (top-2 gaps "
        f"{[round(g, 4) for g in gap.tolist()]}); first call {t_first:.3f} s, plain "
        f"{t_plain:.3f} s")
    check(rel <= LM_PREFILL_REL_TOL, f"lm_prefill vs plain attention {rel:.3g}")
    check(bool(same[decided].all()), "lm_prefill argmax differs where the top-2 gap "
                                     "exceeds twice the error")


def lm_grad(torch, results, cfg, params):
    """The loss gradient at 1 x 4096, the full depth, under the published
    config's remat "full"."""
    from repro_torch.models import model
    toks = lm_tokens(torch, cfg, 1, 4096, seed=1)
    leaves = [t.requires_grad_() for _, t in model._leaves(params)]
    torch.cuda.reset_peak_memory_stats()
    (loss, grads), t_step = host_s(torch, lambda: (
        lambda l: (l, torch.autograd.grad(l, leaves)))(
            model.loss_fn(cfg, params, {"tokens": toks})))
    for t in leaves:
        t.requires_grad_(False)
    loss = loss.detach()
    check(bool(torch.isfinite(loss)), "lm_grad loss non-finite")
    check(all(bool(torch.isfinite(g).all()) for g in grads), "lm_grad non-finite gradient")
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    results["lm_grad"] = {"loss": float(loss), "ln_vocab": float(np.log(cfg.vocab_size)),
                          "grad_norm": gnorm, "first_step_s": t_step,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"lm_grad 1 x 4096: loss {float(loss):.4f} (ln V {np.log(cfg.vocab_size):.4f}), "
        f"grad norm {gnorm:.4g}, first step {t_step:.3f} s, peak "
        f"{results['lm_grad']['peak_gb']:.1f} GB")


def layer_cut(cfg, params, n_layers: int):
    """The model's first ``n_layers`` layers, the same widths: its config,
    and its parameters as detached views of the full model's."""
    cut = {k: v.detach() for k, v in params.items() if k != "layers"}
    cut["layers"] = {g: {n: t.detach()[:n_layers] for n, t in ps.items()}
                     for g, ps in params["layers"].items()}
    return dataclasses.replace(cfg, n_layers=n_layers), cut


def lm_grad_vs_plain(torch, results, cfg, params):
    """A 4-layer cut of the same widths: the kernels' gradients against
    plain autograd through the plain attention (which keeps every chunk's
    probabilities, ~1 GB a layer at this length)."""
    from repro_torch.models import model
    cfg4, p4 = layer_cut(cfg, params, 4)
    paths, leaves = zip(*model._leaves(p4))
    for t in leaves:
        t.requires_grad_()
    toks = lm_tokens(torch, cfg, 1, 4096, seed=1)
    got = torch.autograd.grad(model.loss_fn(cfg4, p4, {"tokens": toks}), leaves)
    want = torch.autograd.grad(
        model.loss_fn(cfg4, p4, {"tokens": toks}, backend="ref"), leaves)
    errs = {"/".join(p): rel_err(g, w) for p, g, w in zip(paths, got, want)}
    worst = max(errs, key=errs.get)
    results["lm_grad_vs_plain"] = {"rel_err_by_leaf": errs, "worst": worst}
    log(f"lm_grad 4-layer cut vs plain autograd: worst leaf {worst} rel "
        f"{errs[worst]:.3g} (tol {LM_GRAD_REL_TOL})")
    check(errs[worst] <= LM_GRAD_REL_TOL, f"lm_grad vs plain: {worst} {errs[worst]:.3g}")


def offline_greedy(torch, cfg, params, reqs, slots: int, max_len: int) -> dict:
    """Greedy decode_step loops of ``reqs``, ``slots`` at a time, each
    request in its own lane from position 0 (lanes are independent in a
    decode step); codebook tokens fed and kept as the Server does."""
    from repro_torch.models import model
    out = {}
    for i in range(0, len(reqs), slots):
        group = reqs[i:i + slots]
        cache = model.init_cache(cfg, slots, max_len, "cuda")
        outs = [[] for _ in group]
        with torch.no_grad():
            for t in range(max(len(r.prompt) + r.max_new - 1 for r in group)):
                cur = [0] * slots
                for j, r in enumerate(group):
                    cur[j] = r.prompt[t] if t < len(r.prompt) else (outs[j] or [0])[-1]
                toks = torch.tensor(cur, device="cuda")
                if cfg.n_codebooks > 1:
                    toks = toks[:, None].expand(slots, cfg.n_codebooks)
                lg, cache = model.decode_step(cfg, params, cache, toks,
                                              torch.full((slots,), t, device="cuda"))
                nxt = lg.argmax(-1).cpu().numpy()
                for j, r in enumerate(group):
                    if len(r.prompt) - 1 <= t and len(outs[j]) < r.max_new:
                        outs[j].append(int(nxt[j, 0] if nxt.ndim > 1 else nxt[j]))
        del cache
        out.update({r.rid: o for r, o in zip(group, outs)})
    return out


def lm_requests(cfg, n: int, lo: int, hi: int, new: int, seed: int = 0):
    """``n`` requests of ``lo``-``hi`` random prompt tokens and ``new`` new
    ones (the reference's serve.py main draws 3-9 from seed 0)."""
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, cfg.vocab_size,
                                      size=rng.integers(lo, hi + 1)).tolist(), new)
            for rid in range(n)]


def serve_round(torch, out: dict, name: str, cfg, params, reqs, slots: int = 4,
                max_len: int = 32) -> None:
    """A ``slots``-slot Server round over ``reqs``: its tokens against
    offline greedy decoding."""
    from repro_torch.launch.serve import Server
    srv = Server(cfg, slots=slots, max_len=max_len, params=params, device="cuda")
    for r in reqs:
        srv.submit(r)
    done, t_serve = host_s(torch, lambda: {r.rid: r for r in srv.run()})
    check(len(done) == len(reqs), f"{name}: served {len(done)} of {len(reqs)} requests")
    want, t_off = host_s(torch, lambda: offline_greedy(torch, cfg, srv.params, reqs,
                                                       slots, max_len))
    same = [done[r.rid].out == want[r.rid] for r in reqs]
    new = sum(len(r.out) for r in done.values())
    out["serve"] = {"requests": len(reqs), "slots": slots, "steps": srv.steps,
                    "serve_s": t_serve, "ms_per_step": t_serve / srv.steps * 1e3,
                    "new_tokens": new, "offline_s": t_off, "equal_offline": same}
    log(f"{name} serve: {len(reqs)} requests on {slots} slots, {srv.steps} steps, "
        f"{t_serve / srv.steps * 1e3:.2f} ms/step, {new} new tokens in {t_serve:.2f} s; "
        f"equal to offline greedy {same} ({t_off:.2f} s)")
    check(all(same), f"{name}: served tokens differ from offline greedy decoding")
    del srv


def decode_vs_forward(torch, cfg, params, n_tokens: int, last: int = 8):
    """A prompt of ``n_tokens`` decoded token by token against the
    forward's logits at its last ``last`` positions: rel, argmax agreement
    where the forward's top-2 gap exceeds twice the error, and seconds."""
    from repro_torch.models import model
    toks = lm_tokens(torch, cfg, 1, n_tokens, seed=2)
    with torch.no_grad():
        full = model.logits_fn(cfg, params, model.forward(cfg, params, toks)[:, -last:])[0]
        cache = model.init_cache(cfg, 1, n_tokens, "cuda")
        dec = []
        t = time.perf_counter()
        for i in range(n_tokens):
            lg, cache = model.decode_step(cfg, params, cache, toks[:, i], i)
            if i >= n_tokens - last:
                dec.append(lg[0])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t
    dec = torch.stack(dec)
    err = float((dec.float() - full.float()).abs().max())
    gap = top2_gap(full)
    agree = dec.argmax(-1) == full.argmax(-1)
    return {"rel": rel_err(dec, full), "max_abs_err": err, "decode_s": t_dec,
            "argmax_equal": agree.tolist(), "top2_gap": gap.tolist(),
            "argmax_decided_equal": bool(agree[gap > 2 * err].all())}


def lm_serve(torch, results, cfg, params):
    """The continuous-batching server (4 slots; 8 requests of 3-9 prompt
    tokens and 16 new ones, drawn as the reference's serve.py main draws
    them) against offline greedy decoding, and a 3072-token prompt decoded
    token by token against the forward on the first DECODE_LAYERS layers
    (decoding is launch-bound: at 28 layers the 3072 steps take minutes)."""
    from repro_torch.models import model
    out = results["lm_serve"] = {}
    serve_round(torch, out, "lm_serve", cfg, params, lm_requests(cfg, 8, 3, 9, 16),
                max_len=64)
    cfgd, pd = layer_cut(cfg, params, DECODE_LAYERS)
    dv = out["decode_vs_forward"] = decode_vs_forward(
        torch, cfgd, model.compute_params(cfgd, pd), 3072)
    log(f"lm_serve 3072-token prompt, {DECODE_LAYERS} layers, decoded token by token "
        f"({dv['decode_s']:.1f} s) vs the forward at the last 8 positions: rel "
        f"{dv['rel']:.3g} (tol {LM_DECODE_REL_TOL}), argmax equal {dv['argmax_equal']}, "
        f"top-2 gaps {[round(g, 4) for g in dv['top2_gap']]}, max abs err "
        f"{dv['max_abs_err']:.4g}")
    check(dv["rel"] <= LM_DECODE_REL_TOL, f"decode vs forward {dv['rel']:.3g}")
    check(dv["argmax_decided_equal"], "decode argmax differs from the forward's where "
                                      "the top-2 gap exceeds twice the error")
    torch.cuda.empty_cache()


def lm_category(key: str) -> str:
    if "flash_" in key:
        return "attention_kernels"
    if any(s in key for s in ("gemm", "xmma", "cutlass", "nvjet", "matmul", "cublas")):
        return "matmul"
    return "other"


def category_breakdown(torch, results, name: str, fn, reps: int = 2,
                       section: str = "lm_breakdown", classify=lm_category,
                       categories=("attention_kernels", "matmul", "other"),
                       ms=None) -> None:
    """Device time of ``fn`` by category (``classify`` of each lower-cased
    kernel name; the LM's: the attention kernels, matrix products,
    everything else), its median time (``ms``, where the caller measured
    it), and the device's busy share of the profiled window."""
    if ms is None:
        ms = cuda_ms(torch, fn, reps=3, warmup=1)
    rows, wall_us, events = profiled(torch, fn, reps)
    cats = dict.fromkeys(categories, 0.0)
    top = {k: [] for k in categories}
    for us, key in rows:
        cat = classify(key.lower())
        cats[cat] += us
        top[cat].append([key[:90], us / 1e3])
    total = sum(cats.values())
    results.setdefault(section, {})[name] = {
        "ms": ms, "device_busy_share": total * reps / wall_us, **events,
        "device_ms_by_category": {k: v / 1e3 for k, v in cats.items()},
        "share_by_category": {k: (v / total if total else 0.0) for k, v in cats.items()},
        "top_ms_by_category": {k: v[:4] for k, v in top.items()},
        "device_us_per_call": [[k[:60], us] for us, k in rows[:10]]}
    log(f"breakdown {name}: {ms:.2f} ms per call, device busy {total * reps / wall_us:.3f}; "
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in cats.items()) + events_note(events))
    for cat, ks in top.items():
        for key, kms in ks[:3]:
            log(f"  {kms:9.3f} ms  {cat:18s} {key[:60]}")


def lm_paths(torch, results) -> dict:
    """The LM paths at Qwen3-0.6B's full width, each under run_path."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model
    t = time.perf_counter()
    cfg, params = lm_setup(torch)
    results["phase_s"]["lm setup"] = time.perf_counter() - t
    n_layers = cfg.n_layers
    launches = run_path(torch, results, "lm_prefill", ("flash_fwd",),
                        lambda: lm_prefill(torch, results, cfg, params))
    check(launches["flash_fwd"] == n_layers,
          f"lm_prefill launched flash_fwd {launches['flash_fwd']} times, not {n_layers}")
    grad_kernels = ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")
    launches.update(run_path(torch, results, "lm_grad", grad_kernels,
                             lambda: lm_grad(torch, results, cfg, params)))
    # remat "full" (the published config's) runs each layer's forward again
    # in the backward
    want = {"flash_fwd_stats": 2 * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers}
    for k in grad_kernels:
        check(launches[k] == want[k], f"lm_grad launched {k} {launches[k]} times, "
                                      f"not {want[k]}")
    t = time.perf_counter()
    lm_grad_vs_plain(torch, results, cfg, params)
    results["phase_s"]["lm_grad vs plain"] = time.perf_counter() - t
    run_path(torch, results, "lm_serve", ("flash_fwd",),
             lambda: lm_serve(torch, results, cfg, params))

    t = time.perf_counter()
    toks = lm_tokens(torch, cfg, 2, 4096)
    prefill = make_prefill_step(cfg)
    # one profiled call each: the gradient is host-bound under remat, and
    # each profiled call costs seconds of the run
    category_breakdown(torch, results, "lm_prefill",
                       lambda: prefill(params, {"tokens": toks}), reps=1)
    toks1 = lm_tokens(torch, cfg, 1, 4096, seed=1)
    leaves = [p for _, p in model._leaves(params)]

    def grad_step():
        for p in leaves:
            p.requires_grad_()
        g = torch.autograd.grad(model.loss_fn(cfg, params, {"tokens": toks1}), leaves)
        for p in leaves:
            p.requires_grad_(False)
        return g

    category_breakdown(torch, results, "lm_grad", grad_step, reps=1)
    bd = results["lm_breakdown"]
    results["lm_prefill"]["ms"] = bd["lm_prefill"]["ms"]
    results["lm_prefill"]["tokens_per_s"] = 2 * 4096 / (bd["lm_prefill"]["ms"] / 1e3)
    results["lm_grad"]["ms"] = bd["lm_grad"]["ms"]
    results["lm_grad"]["tokens_per_s"] = 4096 / (bd["lm_grad"]["ms"] / 1e3)
    results["phase_s"]["lm breakdown"] = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    return launches


# LM training at Qwen3-0.6B's published widths and depth (28 layers, remat
# "full"): a global batch of 4 x 4096 tokens in 2 microbatches, build's AdamW
# over an 8-step schedule (warmup 1 step), f32 master parameters, bf16
# compute.  The checks run a 2-layer cut of the same widths.
LM_TRAIN_STEPS = 8
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_ACCUM = 4, 4096, 2
LM_TRAIN_LR = 3e-4
LM_TRAIN_CUT = 2              # layers of the checks' cut
LM_RESUME_STEPS, LM_RESUME_EVERY, LM_RESUME_FAIL = 4, 2, 3
LM_RESUME_TOL = 1e-6          # resumed vs uninterrupted losses (rel)
LM_COMPRESS_STEPS = 3


def lm_train_cfg(n_layers=None):
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("qwen3-0.6b"), grad_accum=LM_TRAIN_ACCUM)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def lm_pipeline(cfg):
    from repro_torch.data.tokens import TokenPipeline
    return TokenPipeline(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH)


def lm_train(torch, results) -> None:
    """train_loop at full width and depth for LM_TRAIN_STEPS steps on the
    card: the losses fall; each step's time (CUDA events between the
    steps' batch draws, the host's batch and the loss read included),
    tokens/s and the peak memory."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model
    cfg = lm_train_cfg()
    marks = []

    class Marked(TokenPipeline):
        def batch(self, step=None):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return super().batch(step)

    pipe = Marked(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (params, losses), wall = host_s(torch, lambda: train_loop(
        cfg, None, pipe, LM_TRAIN_STEPS, log_every=0, lr=LM_TRAIN_LR))
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    marks[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out = results["lm_train"] = {
        "losses": losses, "step_ms": step_ms, "ms": ms,
        "tokens_per_s": tokens / (ms / 1e3), "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "n_params": sum(t.numel() for t in model.flatten(params).values())}
    log(f"lm_train {cfg.name}, {cfg.n_layers} layers, remat {cfg.remat_policy}, "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens a step in {LM_TRAIN_ACCUM} microbatches, "
        f"{out['n_params'] / 1e6:.1f}M f32 parameters: median step {ms:.2f} ms after the "
        f"first ({step_ms[0]:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{out['peak_gib']:.2f} GiB; losses {[round(v, 4) for v in losses]} "
        f"[{results['device']}]")
    check(all(np.isfinite(losses)), f"lm_train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"lm_train: the loss did not fall: {losses}")
    del params
    torch.cuda.empty_cache()


def lm_train_breakdown(torch, results) -> None:
    """Device time of one full-depth training step by category, in a
    profiler window of one step (lm_train warmed the same shapes and timed
    the step)."""
    from repro_torch.launch.train import build
    from repro_torch.models import model
    cfg = lm_train_cfg()
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt, step_fn = build(cfg, None, lr=LM_TRAIN_LR, total_steps=LM_TRAIN_STEPS)
    state = opt.init(model.flatten(params))
    batch = {"tokens": torch.from_numpy(lm_pipeline(cfg).batch(0)).cuda()}
    category_breakdown(torch, results, "lm_train_step",
                       lambda: step_fn(params, state, batch), reps=1,
                       ms=results["lm_train"]["ms"])
    del params, state
    torch.cuda.empty_cache()


def lm_train_checks(torch, results) -> None:
    """At full width and LM_TRAIN_CUT layers: one training step (both
    microbatches) with the kernels against backend="ref"; remat none, full
    and dots bit-equal, each with its peak memory; a Supervisor resume from
    a failure against the uninterrupted run; 1-bit compression."""
    from repro_torch.launch import steps
    from repro_torch.launch.train import build, train_loop
    from repro_torch.models import model
    from repro_torch.runtime import checkpoint as CKPT
    from repro_torch.runtime import compression
    from repro_torch.runtime.fault import Supervisor
    cfg = lm_train_cfg(LM_TRAIN_CUT)
    out = results["lm_train_checks"] = {}
    gen = torch.Generator(device="cuda")
    params = model.init_params(cfg, gen.manual_seed(0))
    toks = torch.from_numpy(lm_pipeline(cfg).batch(0)).cuda()

    # one step, kernels against the plain attention
    seen = {}
    for backend in ("auto", "ref"):
        def capture(g, backend=backend):
            seen[backend] = g
            return g
        opt, _ = build(cfg, None, lr=LM_TRAIN_LR, total_steps=LM_TRAIN_STEPS)
        _, _, m = steps.make_train_step(cfg, opt, compress_fn=capture, backend=backend)(
            params, opt.init(model.flatten(params)), {"tokens": toks})
        seen[backend + "_loss"] = float(m["loss"])
    errs = {k: rel_err(g, seen["ref"][k]) for k, g in seen["auto"].items()}
    worst = max(errs, key=errs.get)
    loss_rel = abs(seen["auto_loss"] / seen["ref_loss"] - 1)
    out["vs_plain"] = {"loss_rel": loss_rel, "worst": worst, "rel_err_by_leaf": errs}
    log(f"lm_train step, {LM_TRAIN_CUT} layers, kernels vs plain attention: loss rel "
        f"{loss_rel:.3g}, worst gradient {worst} rel {errs[worst]:.3g} (tol "
        f"{LM_GRAD_REL_TOL})")
    check(loss_rel <= LM_GRAD_REL_TOL and errs[worst] <= LM_GRAD_REL_TOL,
          f"lm_train step vs plain: loss {loss_rel:.3g}, {worst} {errs[worst]:.3g}")
    del seen

    # remat: the same bits, and each policy's peak memory
    mb = {"tokens": toks[:LM_TRAIN_BATCH // LM_TRAIN_ACCUM]}
    got, peaks = {}, {}
    for policy in ("none", "full", "dots"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got[policy] = steps.value_and_grad(
            dataclasses.replace(cfg, remat_policy=policy), params, mb)
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() / 2 ** 30
    same = {p: bool(torch.equal(got[p][0], got["none"][0])
                    and all(torch.equal(g, got["none"][1][k]) for k, g in got[p][1].items()))
            for p in ("full", "dots")}
    out["remat"] = {"peak_gib": peaks, "bit_equal": same}
    log(f"lm_train remat at {LM_TRAIN_CUT} layers, one microbatch of "
        f"{LM_TRAIN_BATCH // LM_TRAIN_ACCUM} x {LM_TRAIN_SEQ}: peak GiB "
        + ", ".join(f"{p} {v:.3f}" for p, v in peaks.items())
        + f"; loss and gradients bit-equal to none: {same}")
    check(all(same.values()), f"lm_train: remat changed the bits: {same}")
    del got

    # a failure under the Supervisor, resumed from the checkpoint
    def run(ckpt_dir=None, fail=None):
        return train_loop(cfg, None, lm_pipeline(cfg), LM_RESUME_STEPS, ckpt_dir,
                          ckpt_every=LM_RESUME_EVERY, log_every=0, fail_at_step=fail,
                          lr=LM_TRAIN_LR)

    want_p, want = run()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_")
    try:
        starts, runs = [], []

        def loop(start):
            starts.append(start)
            runs.append(run(ckpt_dir, LM_RESUME_FAIL if len(starts) == 1 else None))
            return LM_RESUME_STEPS

        t = time.perf_counter()
        sup = Supervisor(loop, lambda: CKPT.latest_step(ckpt_dir) or 0, backoff_s=0.0)
        sup.run()
        resume_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    got_p, losses = runs[-1]
    k0 = LM_RESUME_STEPS - len(losses)
    rel = max(abs(a / b - 1) for a, b in zip(losses, want[k0:]))
    perr = max(float((t - want_p_t).abs().max()) for t, want_p_t in
               zip(model.flatten(got_p).values(), model.flatten(want_p).values()))
    out["resume"] = {"starts": starts, "restarts": sup.restarts, "losses": losses,
                     "uninterrupted": want, "loss_rel": rel, "params_max_abs": perr,
                     "supervised_s": resume_s}
    log(f"lm_train resume at {LM_TRAIN_CUT} layers: failure at step {LM_RESUME_FAIL}, "
        f"checkpoints every {LM_RESUME_EVERY}: attempts from {starts}, losses "
        f"{[round(v, 6) for v in losses]} vs uninterrupted "
        f"{[round(v, 6) for v in want]} (rel {rel:.3g}, tol {LM_RESUME_TOL}), "
        f"parameters max abs {perr:.3g}; supervised run {resume_s:.1f} s")
    check(starts == [0, LM_RESUME_EVERY] and k0 == LM_RESUME_EVERY and rel <= LM_RESUME_TOL,
          f"lm_train resume: starts {starts}, losses {losses} vs {want}")
    del want_p, got_p, runs

    # 1-bit error-feedback compression
    opt, step_fn = build(cfg, None, lr=LM_TRAIN_LR, total_steps=LM_TRAIN_STEPS,
                         compress=True)
    p = params
    state = opt.init(model.flatten(p))
    pipe = lm_pipeline(cfg)
    comp = []
    for i in range(LM_COMPRESS_STEPS):
        p, state, m = step_fn(p, state, {"tokens": torch.from_numpy(pipe.batch(i)).cuda()})
        comp.append(float(m["loss"]))
    f32_bytes = sum(t.numel() * 4 for t in model.flatten(p).values())
    out["compression"] = {"losses": comp, "bytes": compression.compressed_bytes(
        model.flatten(p)), "f32_bytes": f32_bytes}
    log(f"lm_train with 1-bit compression at {LM_TRAIN_CUT} layers: losses "
        f"{[round(v, 4) for v in comp]} (first without: {want[0]:.4f}); "
        f"{out['compression']['bytes']} bytes a step on the data axis against "
        f"{f32_bytes} in f32")
    check(all(np.isfinite(comp)) and comp[0] == want[0],
          f"lm_train compression: losses {comp}, first without {want[0]}")
    del p, state, params
    torch.cuda.empty_cache()


def lm_train_paths(torch, results) -> dict:
    """The LM training path, under run_path, then one step's breakdown and
    the checks."""
    cfg = lm_train_cfg()
    kernels = ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")
    launches = run_path(torch, results, "lm_train", kernels,
                        lambda: lm_train(torch, results))
    micro = LM_TRAIN_STEPS * cfg.grad_accum * cfg.n_layers
    want = {"flash_fwd_stats": 2 * micro, "flash_bwd_dq": micro, "flash_bwd_dkv": micro}
    check(launches == want, f"lm_train launches {launches}, want {want} (remat "
                            f"{cfg.remat_policy}: the forward twice a layer)")
    t = time.perf_counter()
    lm_train_breakdown(torch, results)
    results["phase_s"]["lm_train breakdown"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_train_checks(torch, results)
    results["phase_s"]["lm_train checks"] = time.perf_counter() - t
    return launches


# The other LM families at their published widths (configs/*.py), random
# weights from seed 0 on the card, each model freed before the next:
# Hymba-1.5B trained (full depth, remat "full", 2 x 4096 tokens a step in 2
# microbatches; the published grad_accum is 4) and served; OLMoE-1B-7B,
# Falcon-Mamba-7B, Qwen2-VL-72B (a 2-layer cut: 72.7e9 parameters do not
# fit one card) and MusicGen-large prefilled and served.
FAMILY_TRAIN_STEPS = 4
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_ACCUM = 2, 4096, 2
FAMILY_CUT = 3                 # Hymba's checks: layers 0 and 2 global, 1 windowed
FAMILY_DECODE_PROMPT = 128     # Hymba's cut: decode vs forward
# Hymba's serving round: 4 requests of 16-32 prompt tokens on 4 slots, 16
# new tokens each; a decode step takes ~100-140 ms (32 layers, host-bound),
# so 8 requests of 16-64 tokens took 43 s with their offline decoding, and 5
# of 16-32 took 15.8 s (an NVIDIA H100 80GB HBM3 at 700.00 W, runs 29A and
# 29B in PERF.md).
HYMBA_REQUESTS = 4
MAMBA_CUT, MAMBA_DECODE_PROMPT = 4, 64
MAMBA_DECODE_REL_TOL = 5e-2    # tests/test_archs.py:96
# The parameter change of one AdamW step, kernels against backend="ref"
# (tests/test_torch_cuda.py's bounds for Qwen3-0.6B's step)
LM_UPDATE_REL_TOL, LM_UPDATE_LEAF_REL_TOL = 0.15, 0.3


def family_cfg(arch: str, **change):
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), **change)


def family_params(torch, cfg, cast: bool = True):
    """Random parameters from seed 0 on the card; ``cast``: cast once to the
    compute dtype (model.compute_params), the f32 masters freed."""
    from repro_torch.models import model
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if cast:
        params = model.compute_params(cfg, params)
        torch.cuda.empty_cache()
    return params


def hymba_train(torch, results) -> dict:
    """train_loop at Hymba-1.5B's full width and depth: the losses fall;
    each step's time (CUDA events between the steps' batch draws), tokens/s
    and the peak memory; then the time of one layer's pieces at the step's
    shapes (the Mamba block and its plain scan, forward and gradient)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import train_loop
    from repro_torch.models import mamba, model
    cfg = family_cfg("hymba-1.5b", grad_accum=FAMILY_TRAIN_ACCUM)
    marks = []

    class Marked(TokenPipeline):
        def batch(self, step=None):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            return super().batch(step)

    pipe = Marked(cfg.vocab_size, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (params, losses), wall = host_s(torch, lambda: train_loop(
        cfg, None, pipe, FAMILY_TRAIN_STEPS, log_every=0, lr=LM_TRAIN_LR))
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    marks[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms = statistics.median(step_ms[1:])
    tokens = FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ
    out = {"losses": losses, "step_ms": step_ms, "ms": ms, "tokens_per_s": tokens / (ms / 1e3),
           "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "n_params": sum(t.numel() for t in model.flatten(params).values())}
    log(f"hymba_train {cfg.name}, {cfg.n_layers} layers, remat {cfg.remat_policy}, "
        f"{FAMILY_TRAIN_BATCH} x {FAMILY_TRAIN_SEQ} tokens a step in {FAMILY_TRAIN_ACCUM} "
        f"microbatches, {out['n_params'] / 1e9:.3f}e9 f32 parameters: median step "
        f"{ms:.2f} ms after the first ({step_ms[0]:.1f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_gib']:.2f} GiB; losses {[round(v, 4) for v in losses]} "
        f"[{results['device']}]")
    check(all(np.isfinite(losses)), f"hymba_train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"hymba_train: the loss did not fall: {losses}")
    del params
    torch.cuda.empty_cache()

    # one layer's pieces at the step's shapes (1 x 4096 a microbatch), bf16
    gen = torch.Generator(device="cuda").manual_seed(1)
    lp = model._cast_layer(model._layer(family_params(torch, dataclasses.replace(
        cfg, n_layers=1), cast=False), 0), torch.bfloat16)
    x = torch.randn((1, FAMILY_TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ssm = {k: v.requires_grad_() for k, v in lp["ssm"].items() if k != "ln"}
    xg = x.clone().requires_grad_()

    def block_grad():
        return torch.autograd.grad(mamba.mamba_train(ssm, xg, cfg).float().square().sum(),
                                   [xg] + list(ssm.values()))

    C, di, N = mamba.CHUNK, cfg.d_inner, cfg.ssm.d_state
    a = torch.rand((1, C, di, N), generator=gen, device="cuda").requires_grad_()
    b = torch.randn((1, C, di, N), generator=gen, device="cuda").requires_grad_()

    def scan_grad():
        acum, hcum = mamba._scan(a, b)
        return torch.autograd.grad((acum.sum() + hcum.sum()), [a, b])

    with torch.no_grad():
        mamba_fwd = cuda_ms(torch, lambda: mamba.mamba_train(lp["ssm"], x, cfg), reps=3, warmup=1)
        scan_fwd = cuda_ms(torch, lambda: mamba._scan(a, b), reps=3, warmup=1)
    mamba_grad = cuda_ms(torch, block_grad, reps=3, warmup=1)
    scan_grad_ms = cuda_ms(torch, scan_grad, reps=3, warmup=1)
    chunks = FAMILY_TRAIN_SEQ // C
    # a microbatch runs each layer's forward twice (remat "full") and its
    # backward once: forward + (forward + backward) = fwd + grad
    per_step = FAMILY_TRAIN_ACCUM * cfg.n_layers
    out["pieces"] = {
        "mamba_fwd_ms": mamba_fwd, "mamba_grad_ms": mamba_grad,
        "scan_fwd_ms_per_chunk": scan_fwd, "scan_grad_ms_per_chunk": scan_grad_ms,
        "mamba_share_of_step": per_step * (mamba_fwd + mamba_grad) / ms,
        "scan_share_of_step": per_step * chunks * (scan_fwd + scan_grad_ms) / ms}
    log(f"hymba_train pieces (one layer, 1 x {FAMILY_TRAIN_SEQ}, bf16): Mamba block "
        f"forward {mamba_fwd:.2f} ms, forward+backward {mamba_grad:.2f} ms; plain scan a "
        f"chunk of {C} x {di} x {N} f32: forward {scan_fwd:.2f} ms, forward+backward "
        f"{scan_grad_ms:.2f} ms; of the median step: Mamba blocks "
        f"{out['pieces']['mamba_share_of_step']:.3f}, scans "
        f"{out['pieces']['scan_share_of_step']:.3f}")
    del lp, ssm, x, xg, a, b
    torch.cuda.empty_cache()
    return out


def hymba_cut_check(torch, out: dict) -> None:
    """The FAMILY_CUT-layer cut: one training step (both microbatches) on
    the kernels against backend="ref"."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.train import build
    from repro_torch.models import model
    cfg = family_cfg("hymba-1.5b", n_layers=FAMILY_CUT, grad_accum=FAMILY_TRAIN_ACCUM)
    check(model._layer_windows(cfg).tolist() == [True, False, True],
          f"hymba cut windows {model._layer_windows(cfg)}")
    params = family_params(torch, cfg, cast=False)
    p0 = {k: v.clone() for k, v in model.flatten(params).items()}
    toks = torch.from_numpy(TokenPipeline(cfg.vocab_size, FAMILY_TRAIN_SEQ,
                                          FAMILY_TRAIN_BATCH).batch(0)).cuda()
    seen = {}
    for backend in ("auto", "ref"):
        grads = {}

        def capture(g, grads=grads):
            grads.update(g)
            return g

        opt, _ = build(cfg, None, lr=LM_TRAIN_LR, total_steps=FAMILY_TRAIN_STEPS)
        p, _, m = steps.make_train_step(cfg, opt, compress_fn=capture, backend=backend)(
            params, opt.init(model.flatten(params)), {"tokens": toks})
        seen[backend] = (float(m["loss"]), grads, model.flatten(p))
    loss_rel = abs(seen["auto"][0] / seen["ref"][0] - 1)
    errs = {k: rel_err(g, seen["ref"][1][k]) for k, g in seen["auto"][1].items()}
    worst = max(errs, key=errs.get)
    num = den = 0.0
    upd = {}
    for k, p in seen["auto"][2].items():
        d = p.double() - p0[k].double()
        d_ref = seen["ref"][2][k].double() - p0[k].double()
        err, ref = float(((d - d_ref) ** 2).sum()), float((d_ref ** 2).sum())
        check(ref > 0, f"hymba cut: the plain step did not move {k}")
        upd[k] = (err / ref) ** 0.5
        num, den = num + err, den + ref
    upd_worst = max(upd, key=upd.get)
    out["cut_vs_plain"] = {"loss_rel": loss_rel, "worst": worst, "rel_err_by_leaf": errs,
                           "update_rel": (num / den) ** 0.5, "update_worst": upd_worst,
                           "update_rel_by_leaf": upd}
    log(f"hymba_train step, {FAMILY_CUT} layers, kernels vs plain attention: loss rel "
        f"{loss_rel:.3g}, worst gradient {worst} rel {errs[worst]:.3g} (tol "
        f"{LM_GRAD_REL_TOL}); update rel {(num / den) ** 0.5:.3g} (tol {LM_UPDATE_REL_TOL}), "
        f"worst leaf {upd_worst} {upd[upd_worst]:.3g} (tol {LM_UPDATE_LEAF_REL_TOL})")
    check(loss_rel <= LM_GRAD_REL_TOL and errs[worst] <= LM_GRAD_REL_TOL,
          f"hymba cut vs plain: loss {loss_rel:.3g}, {worst} {errs[worst]:.3g}")
    check((num / den) ** 0.5 <= LM_UPDATE_REL_TOL and upd[upd_worst] <= LM_UPDATE_LEAF_REL_TOL,
          f"hymba cut update vs plain: {(num / den) ** 0.5:.3g}, {upd_worst} "
          f"{upd[upd_worst]:.3g}")
    del seen, params, p0
    torch.cuda.empty_cache()


def hymba_serve(torch, results) -> dict:
    """Server(slots=4) on the full model: HYMBA_REQUESTS requests of 16-32
    prompt tokens and 16 new tokens each against offline greedy decoding;
    on the cut, a prompt decoded token by token against the forward."""
    cfg = family_cfg("hymba-1.5b")
    params = family_params(torch, cfg)
    out = {}
    serve_round(torch, out, "hymba_serve", cfg, params,
                lm_requests(cfg, HYMBA_REQUESTS, 16, 32, 16), max_len=64)
    del params
    cfgc = family_cfg("hymba-1.5b", n_layers=FAMILY_CUT)
    pc = family_params(torch, cfgc)
    dv = out["decode_vs_forward"] = decode_vs_forward(torch, cfgc, pc, FAMILY_DECODE_PROMPT)
    log(f"hymba_serve {FAMILY_CUT}-layer cut, a {FAMILY_DECODE_PROMPT}-token prompt decoded "
        f"({dv['decode_s']:.1f} s) vs the forward at the last 8 positions: rel "
        f"{dv['rel']:.3g} (tol {LM_DECODE_REL_TOL}), argmax equal {dv['argmax_equal']}")
    check(dv["rel"] <= LM_DECODE_REL_TOL and dv["argmax_decided_equal"],
          f"hymba decode vs forward {dv}")
    del pc
    torch.cuda.empty_cache()
    return out


def olmoe_cell(torch, results) -> dict:
    """OLMoE-1B-7B at full width and depth: prefill 2 x 4096 under the
    published impl "dense" and under "ragged" on the same weights (within
    LM_PREFILL_REL_TOL), "gather" with its dropped slots; a Server round."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe
    cfg = family_cfg("olmoe-1b-7b")
    params = family_params(torch, cfg)
    toks = lm_tokens(torch, cfg, 2, 4096)
    out = {"n_params": cfg.n_params()}
    lg = {}
    for impl in moe.IMPLS:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
        drops = []
        if impl == "gather":
            gather = moe.moe_gather

            def counted(p, x, cfg_, stats=None):
                s = {}
                y = gather(p, x, cfg_, s)
                drops.append(s["dropped"])
                return y
            moe.moe_gather = counted
        try:
            lg[impl], s = host_s(torch, lambda: make_prefill_step(c)(params, {"tokens": toks}))
        finally:
            if impl == "gather":
                moe.moe_gather = gather
        out[impl] = {"s": s, "ms": s * 1e3}
        if drops:
            out[impl]["dropped_slots"] = int(sum(int(d) for d in drops))
            out[impl]["slots"] = cfg.n_layers * 2 * 4096 * cfg.moe.top_k
        check(bool(torch.isfinite(lg[impl]).all()), f"olmoe {impl} prefill non-finite")
    rel = rel_err(lg["ragged"], lg["dense"])
    out["ragged_vs_dense_rel"] = rel
    out["gather_vs_dense_rel"] = rel_err(lg["gather"], lg["dense"])
    log(f"olmoe prefill 2 x 4096 ({cfg.n_params() / 1e9:.2f}e9 parameters, bf16 cast once): "
        + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in out.items() if k in moe.IMPLS)
        + f"; ragged vs dense rel {rel:.3g} (tol {LM_PREFILL_REL_TOL}); gather dropped "
        f"{out['gather']['dropped_slots']} of {out['gather']['slots']} slots, vs dense rel "
        f"{out['gather_vs_dense_rel']:.3g}")
    check(rel <= LM_PREFILL_REL_TOL, f"olmoe ragged vs dense prefill {rel:.3g}")
    serve_round(torch, out, "olmoe", cfg, params, lm_requests(cfg, 4, 8, 16, 8))
    del params, lg
    torch.cuda.empty_cache()
    return out


def falcon_mamba_cell(torch, results) -> dict:
    """Falcon-Mamba-7B at full width and depth (no attention: no kernel):
    prefill 1 x 4096, a Server round, and on a MAMBA_CUT-layer cut a
    MAMBA_DECODE_PROMPT-token prompt decoded against the forward's last
    position."""
    from repro_torch.launch.steps import make_prefill_step
    cfg = family_cfg("falcon-mamba-7b")
    params = family_params(torch, cfg)
    toks = lm_tokens(torch, cfg, 1, 4096)
    lg, s = host_s(torch, lambda: make_prefill_step(cfg)(params, {"tokens": toks}))
    check(bool(torch.isfinite(lg).all()), "falcon_mamba prefill non-finite")
    out = {"n_params": cfg.n_params(), "prefill_ms": s * 1e3}
    log(f"falcon_mamba prefill 1 x 4096 ({cfg.n_params() / 1e9:.2f}e9 parameters): "
        f"{s * 1e3:.1f} ms")
    serve_round(torch, out, "falcon_mamba", cfg, params, lm_requests(cfg, 4, 8, 16, 8))
    cfgc, pc = layer_cut(cfg, params, MAMBA_CUT)
    dv = out["decode_vs_forward"] = decode_vs_forward(torch, cfgc, pc, MAMBA_DECODE_PROMPT,
                                                      last=1)
    log(f"falcon_mamba {MAMBA_CUT}-layer cut, a {MAMBA_DECODE_PROMPT}-token prompt decoded vs "
        f"the forward's last position: rel {dv['rel']:.3g} (tol {MAMBA_DECODE_REL_TOL})")
    check(dv["rel"] <= MAMBA_DECODE_REL_TOL, f"falcon_mamba decode vs forward {dv}")
    del params, pc
    torch.cuda.empty_cache()
    return out


def qwen2_vl_cell(torch, results) -> dict:
    """Qwen2-VL-72B's widths at 2 layers: prefill 1 x (1024 vision
    embeddings + 3072 text tokens) with M-RoPE positions whose sections
    differ (a 32 x 32 patch grid at temporal 0, then the text ids), against
    backend="ref"."""
    from repro_torch.launch.steps import make_prefill_step
    cfg = family_cfg("qwen2-vl-72b", n_layers=2)
    params = family_params(torch, cfg)
    nv, nt = cfg.vision_tokens, 4096 - cfg.vision_tokens
    gen = torch.Generator(device="cuda").manual_seed(3)
    ve = 0.02 * torch.randn((1, nv, cfg.d_model), generator=gen, device="cuda")
    i = torch.arange(nv, device="cuda")
    side = int(round(nv ** 0.5))
    grid = torch.stack([torch.zeros_like(i), i // side, i % side])
    text = (torch.arange(nt, device="cuda") + side)[None].expand(3, nt)
    batch = {"tokens": lm_tokens(torch, cfg, 1, nt), "vision_embeds": ve,
             "positions": torch.cat([grid, text], 1)[:, None]}
    lg, s = host_s(torch, lambda: make_prefill_step(cfg)(params, batch))
    want = make_prefill_step(cfg, backend="ref")(params, batch)
    rel = rel_err(lg, want)
    out = {"n_params": cfg.n_params(), "prefill_ms": s * 1e3, "rel_err_vs_plain": rel}
    log(f"qwen2_vl 2-layer cut ({cfg.n_params() / 1e9:.2f}e9 parameters) prefill 1 x ({nv} "
        f"vision + {nt} text), M-RoPE: {s * 1e3:.1f} ms, vs plain attention rel {rel:.3g} "
        f"(tol {LM_PREFILL_REL_TOL})")
    check(bool(torch.isfinite(lg).all()) and rel <= LM_PREFILL_REL_TOL,
          f"qwen2_vl prefill vs plain {rel:.3g}")
    del params, lg, want
    torch.cuda.empty_cache()
    return out


def musicgen_cell(torch, results) -> dict:
    """MusicGen-large at full width and depth (4 codebooks): prefill 2 x
    4096, a Server round whose decode step returns (slots, 4) tokens."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model
    cfg = family_cfg("musicgen-large")
    params = family_params(torch, cfg)
    toks = lm_tokens(torch, cfg, 2, 4096)[:, None].expand(2, cfg.n_codebooks, 4096)
    lg, s = host_s(torch, lambda: make_prefill_step(cfg)(params, {"tokens": toks}))
    check(bool(torch.isfinite(lg).all()), "musicgen prefill non-finite")
    out = {"n_params": cfg.n_params(), "prefill_ms": s * 1e3}
    nxt, _, _ = make_serve_step(cfg)(params, model.init_cache(cfg, 4, 8, "cuda"),
                                     torch.zeros((4, cfg.n_codebooks), dtype=torch.long,
                                                 device="cuda"), 0)
    check(tuple(nxt.shape) == (4, cfg.n_codebooks), f"musicgen serve step {tuple(nxt.shape)}")
    log(f"musicgen prefill 2 x 4096 x {cfg.n_codebooks} codebooks ({cfg.n_params() / 1e9:.2f}e9 "
        f"parameters): {s * 1e3:.1f} ms; a serve step returns {tuple(nxt.shape)} tokens")
    serve_round(torch, out, "musicgen", cfg, params, lm_requests(cfg, 4, 8, 16, 8))
    del params
    torch.cuda.empty_cache()
    return out


def lm_families(torch, results) -> None:
    """Every cell of the other LM families, each under run_path with its
    flash kernels' launch counts."""
    t_phase = time.perf_counter()
    out = results["lm_families"] = {}
    grad_kernels = ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")
    micro = FAMILY_TRAIN_STEPS * FAMILY_TRAIN_ACCUM * family_cfg("hymba-1.5b").n_layers
    cells = [
        ("hymba_train", lambda: out.__setitem__("hymba_train", hymba_train(torch, results)),
         {"flash_fwd_stats": 2 * micro, "flash_bwd_dq": micro, "flash_bwd_dkv": micro}),
        ("hymba_cut", lambda: hymba_cut_check(torch, out["hymba_train"]), None),
        ("hymba_serve", lambda: out.__setitem__("hymba_serve", hymba_serve(torch, results)), {}),
        ("olmoe", lambda: out.__setitem__("olmoe", olmoe_cell(torch, results)),
         {"flash_fwd": 3 * family_cfg("olmoe-1b-7b").n_layers}),
        ("falcon_mamba", lambda: out.__setitem__("falcon_mamba",
                                                 falcon_mamba_cell(torch, results)), {}),
        ("qwen2_vl", lambda: out.__setitem__("qwen2_vl", qwen2_vl_cell(torch, results)),
         {"flash_fwd": 2}),
        ("musicgen", lambda: out.__setitem__("musicgen", musicgen_cell(torch, results)),
         {"flash_fwd": family_cfg("musicgen-large").n_layers}),
    ]
    for name, fn, want in cells:
        t = time.perf_counter()
        if want is None:
            fn()
        else:
            got = run_path(torch, results, f"lm_families {name}", tuple(want), fn)
            check(got == want, f"lm_families {name} launches {got}, want {want}")
        results["phase_s"][f"lm_families {name}"] = time.perf_counter() - t
    results["phase_s"]["lm_families"] = time.perf_counter() - t_phase
    log(f"lm_families {results['phase_s']['lm_families']:.1f} s [{results['device']}]")


def nemotron_attn_layer(torch, results) -> dict:
    """One attention layer of Nemotron-4 340B at its published widths
    (``configs/nemotron_4_340b.py``: d_model 18432, 96 query heads and 8 kv
    heads of 192, standard RoPE): its wq, wk, wv and wo random from seed 0
    in f32 (0.74e9 parameters, cast to bf16 as a layer is), on x of (1,
    4096, 18432) in bf16, through ``layers.attention_train``: the forward,
    and the gradient with respect to x and the four weights, on backend
    "auto" (the hd-192 kernels) against backend "ref" (the plain attention)
    at LM_GRAD_REL_TOL.  Returns the launches of each flash kernel: one
    forward without grad, one each of the three gradient kernels with it."""
    import math
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.kernels import flash
    from repro_torch.models import layers
    cfg = configs.get("nemotron-4-340b")
    S = 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = {n: torch.randn(shp, generator=gen, device="cuda") / math.sqrt(shp[0])
         for n, shp in layers.attn_param_shapes(cfg).items()}
    x = torch.randn((1, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((1, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(S, device="cuda")[None]
    out = {"params": sum(t.numel() for t in w.values()), "hd": cfg.resolved_head_dim}

    def forward(backend):
        wb = {n: t.to(torch.bfloat16) for n, t in w.items()}
        return layers.attention_train(wb, x, cfg, pos, backend=backend)

    launches = {}
    K.reset_launches()
    with torch.no_grad():
        got = forward("auto")
        torch.cuda.synchronize()
        launches["forward"] = {k: K.launches()[k] for k in flash.KERNELS}
        want = forward("ref")
    out["forward_rel_err"] = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(x.shape),
          "nemotron_attn_layer forward non-finite or misshapen")
    del got, want
    leaves = [x] + list(w.values())
    names = ["x"] + list(w)
    grads = {}
    for backend in ("auto", "ref"):
        for t in leaves:
            t.requires_grad_()
        K.reset_launches()
        grads[backend] = torch.autograd.grad(forward(backend), leaves, dy)
        torch.cuda.synchronize()
        if backend == "auto":
            launches["gradient"] = {k: K.launches()[k] for k in flash.KERNELS}
        for t in leaves:
            t.requires_grad_(False)
    out["grad_rel_err"] = {n: rel_err(g, r) for n, g, r in
                           zip(names, grads["auto"], grads["ref"])}
    out["launches"] = launches
    results["nemotron_attn_layer"] = out
    worst = max(out["grad_rel_err"], key=out["grad_rel_err"].get)
    log(f"nemotron_attn_layer (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.resolved_head_dim}, S {S}, bf16): forward vs plain rel "
        f"{out['forward_rel_err']:.3g}, gradient worst {worst} rel "
        f"{out['grad_rel_err'][worst]:.3g} (tol {LM_GRAD_REL_TOL}); launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in grads["auto"]),
          "nemotron_attn_layer non-finite gradient")
    check(out["forward_rel_err"] <= LM_GRAD_REL_TOL,
          f"nemotron_attn_layer forward vs plain {out['forward_rel_err']:.3g}")
    check(out["grad_rel_err"][worst] <= LM_GRAD_REL_TOL,
          f"nemotron_attn_layer gradient vs plain: {worst} {out['grad_rel_err'][worst]:.3g}")
    check(launches["forward"] == {"flash_fwd": 1, "flash_fwd_stats": 0,
                                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"nemotron_attn_layer forward launches {launches['forward']}")
    check(launches["gradient"] == {"flash_fwd": 0, "flash_fwd_stats": 1,
                                   "flash_bwd_dq": 1, "flash_bwd_dkv": 1},
          f"nemotron_attn_layer gradient launches {launches['gradient']}")
    del grads, w, x, dy
    torch.cuda.empty_cache()
    return {"flash_fwd": launches["forward"]["flash_fwd"],
            **{k: launches["gradient"][k]
               for k in ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")}}


def projector_phases(torch, results, only=None, host_run=None) -> dict:
    """The projector kernels' cells and paths, and their profile; returns the
    launches of each projector kernel on its own path.  ``only``: the names
    of the kernel-phase cells to run, and nothing else."""
    from repro_torch.core.geometry import cone_as_modular
    from repro_torch.data.phantoms import random_ellipse_phantom

    main_vol = main_geometry().vol
    gen = torch.Generator(device="cuda").manual_seed(2)

    def phantom_lanes():                    # (512, 512, 8): seeds 0-7 as lanes
        return torch.from_numpy(np.stack(
            [random_ellipse_phantom(s, main_vol)[0] for s in range(8)], -1)).cuda()

    def rand(*shape):
        return lambda: torch.rand(shape, generator=gen, device="cuda")

    cone = cone_geometry()
    # one view of each view group: 14 degrees (y-gathered), 62 (x-gathered)
    cone_two = cone.subset([7, 31])
    # the axes and both sides of the 45 and 135 degree group boundaries
    cone_edges = cone.subset([0, 22, 23, 45, 67, 68, 90])
    cone128 = cone128_geometry()
    lanes = lane_cells()

    def lane_cell(name, *a, **kw):
        return Cell(*lanes[name], *a, **kw)

    cells = {
        "main": lane_cell("main", phantom_lanes, plain_reps=1),
        "3d128": lane_cell("3d128", rand(128, 128, 128)),
        "3d": lane_cell("3d", rand(512, 512, 512), plain_reps=1),
        "fan": lane_cell("fan", phantom_lanes, plain_reps=1),
        "fan_curved": lane_cell("fan_curved", phantom_lanes, plain_reps=1),
        "fan_rows": lane_cell("fan_rows", rand(512, 512, 64), 0,
                              "16 detector rows over 512x512x16 at batch 4: 64 "
                              "lanes, whose threads share each weight"),
        "cone_packed": Cell("cone_packed", cone_packed_geometry(), 8,
                            rand(512, 512, 64), 0,
                            "the packed cone pair's kernels (rows 3-4) on the "
                            "micro-CT slab: 8 rows at batch 8, 64 lanes"),
        "cone": Cell("cone", cone_two, 1, rand(1, 512, 512, 512), 0,
                     "2 of the 180 views: the plain version cannot run all 180 at "
                     "512^3 in this run's time"),
        "cone_edges": Cell("cone", cone_edges, 1, rand(1, 512, 512, 512), 0,
                           "views at 0, 44, 46, 90, 134, 136, 180 degrees: the FP's "
                           "voxel window at the group edges, which the tile's "
                           "dtype does not change; f32; no library matrix",
                           ("float32",)),
        "cone128": Cell("cone", cone128, 1, rand(1, 128, 128, 128), 2),
        "cone128_dv1.5": Cell("cone", cone128_geometry(1.5), 1,
                              rand(1, 128, 128, 128), 2,
                              "cone128 with 1.5 mm rows (not a power of two)",
                              library=False),
    }
    for name, (fam, geom) in lane_caps_geometries().items():
        cells[name] = Cell(fam, geom, 8, rand(geom.vol.nx, geom.vol.ny, 8), 0,
                           "past the old 8-bit counts", library=False)
    helical = helical_geometry()
    cells.update({
        "helical": Cell("modular", helical, 8,
                        lambda: helical_phantoms(torch, helical.vol), 0,
                        "the whole cell at the path's batch, the plain versions "
                        "on its first sample; f32", ("float32",), 1),
        "helical_cut": Cell("modular", helical.subset(helical_views()), 8,
                            lambda: helical_phantoms(torch, helical.vol), 0,
                            "90 of the 768 views (the ends, both sides of the 45 "
                            "and 135 degree group edges in each turn, evenly "
                            "spaced others), with the library matrix"),
        "modular_wobbly": Cell("modular", wobbly_geometry(), 1, rand(1, 128, 128, 64),
                               2),
        "modular_wobbly_dv1.5": Cell("modular", wobbly_geometry(1.5), 1,
                                     rand(1, 128, 128, 64), 2,
                                     "modular_wobbly with 1.5 mm rows (not a "
                                     "power of two)", library=False),
        "cone_as_modular": Cell("modular", cone_as_modular(cone_two), 1,
                                rand(1, 512, 512, 512), 0,
                                "views 7 and 31 of the cone cell as modular frames",
                                library=False),
    })
    if only is not None:
        kernel_phase(torch, {k: cells[k] for k in only}, results)
        return {}
    kernel_phase(torch, cells, results)
    t = time.perf_counter()
    fp_phases(torch, cells, results)
    results["phase_s"]["fp phases"] = time.perf_counter() - t
    t = time.perf_counter()
    bp_phases(torch, cells, results)
    results["phase_s"]["bp phases"] = time.perf_counter() - t
    t = time.perf_counter()
    instance_times(torch, results)
    results["phase_s"]["instances"] = time.perf_counter() - t

    launches = run_path(torch, results, "main", ("fp_par_sf", "bp_par_sf"),
                        lambda: main_cell(torch, results))
    run_path(torch, results, "3d", ("fp_par_sf", "bp_par_sf"),
             lambda: cell_3d(torch, results))
    launches.update(run_path(
        torch, results, "fan", ("fp_fan_sf", "bp_fan_sf"),
        lambda: [fan_path(torch, results, d) for d in ("flat", "curved")]))
    launches.update(run_path(torch, results, "cone", ("fp_cone_sf", "bp_cone_sf"),
                             lambda: cone_path(torch, results)))
    modular = ("fp_modular_sf", "bp_modular_sf")
    launches.update(run_path(torch, results, "helical", modular,
                             lambda: helical_path(torch, results)))
    run_path(torch, results, "cone_as_modular", modular,
             lambda: cone_as_modular_path(torch, results))
    fan = ("fp_fan_sf", "bp_fan_sf")
    packed = run_path(torch, results, "cone_packed", fan,
                      lambda: cone_packed_path(torch, results))
    cone_packed_exact(torch, results, packed)
    run_path(torch, results, "joseph", (), lambda: joseph_path(torch, results))
    run_path(torch, results, "iterative_recon", ("fp_cone_sf", "bp_cone_sf"),
             lambda: iterative_recon_path(torch, results, host_run))
    t = time.perf_counter()
    profile_cells(torch, results)
    torch.cuda.synchronize()
    results["phase_s"]["profile"] = time.perf_counter() - t

    return launches


# -- CT training (launch/ct_train.py) --------------------------------------- #
TRAIN_KERNELS = {"limited_angle": ("fp_par_sf", "bp_par_sf"),
                 "sparse_fan": ("fp_fan_sf", "bp_fan_sf"),
                 "helical": ("fp_modular_sf", "bp_modular_sf")}
TRAIN_N = 512                # the full-width cells: TrainConfig defaults at n = 512
TRAIN_STEPS = {"limited_angle": 20, "sparse_fan": 20, "helical": 8}
TRAIN_LOSS_TOL = 1e-5        # one step, kernel pair vs plain pair: the loss (rel)
TRAIN_GRAD_TOL = 1e-4        # ... and the gradients (relative L2)
TRAIN_HOST_TOL = 1e-4        # smoke run: the first 3 losses, card vs host (rel)
TRAIN_RESUME_TOL = 1e-6      # resumed vs uninterrupted losses (deterministic cuDNN)


TRAIN_CATEGORIES = ("projector_kernels", "convolution", "gather_scatter", "matmul",
                    "other")


def train_category(key: str) -> str:
    """Kernel classes of a training step: the port's projector kernels;
    cuDNN's convolutions (f32 without TF32 picks FFT algorithms: the
    ``fft2d_*`` transforms and their complex ``cf32`` products count here,
    with the implicit-gemm and weight-gradient engines); the FBP's column
    interpolation (``torch.gather`` and, in its backward, the scatter);
    real matrix products (the FBP's einsum: cuBLAS ``xmma``/``sgemm``
    kernels without ``cf32``); the rest."""
    if "_sf_kernel" in key:
        return "projector_kernels"
    if "cf32" in key or any(s in key for s in (
            "cudnn", "fft2d", "implicit", "wgrad", "dgrad", "fprop",
            "winograd", "convolve")):
        return "convolution"
    if "scatter_gather" in key or "scatter_add" in key:
        return "gather_scatter"
    if any(s in key for s in ("gemm", "cutlass", "nvjet", "cublas", "matmul")):
        return "matmul"
    return "other"


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    return (num / den) ** 0.5


def train_step_vs_plain(torch, cfg, out: dict) -> None:
    """One step's loss and gradients with the kernel pair against the plain
    pair (``backend="ref"``) on the card: the same weights (one seed), the
    same batch (the kernels' synthesized sinogram)."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.launch.ct_train import CTTrainer
    kern, plain = CTTrainer(cfg), CTTrainer(cfg)
    plain.proj = Projector(ProjectorSpec(plain.geom, backend="ref",
                                         compute_dtype=cfg.compute_dtype),
                           plain.device)
    batch = kern.data(0)
    (lk, gk), t_k = host_s(torch, lambda: kern.grad_fn(kern.params, *batch))
    (lp, gp), t_p = host_s(torch, lambda: plain.grad_fn(plain.params, *batch))
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_rel = rel_l2(gk, gp)
    out["vs_plain"] = {"n": cfg.n, "loss": float(lk), "loss_plain": float(lp),
                       "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                       "step_s": t_k, "plain_step_s": t_p}
    log(f"train {cfg.geometry} n={cfg.n}: one step, kernels vs plain: loss rel "
        f"{loss_rel:.3g}, gradients rel L2 {grad_rel:.3g} (grad {t_k:.3f} s, "
        f"plain {t_p:.3f} s)")
    check(loss_rel < TRAIN_LOSS_TOL, f"train {cfg.geometry}: loss vs plain {loss_rel:.3g}")
    check(grad_rel < TRAIN_GRAD_TOL, f"train {cfg.geometry}: gradients vs plain "
                                     f"{grad_rel:.3g}")


def train_smoke(torch, geometry: str, out: dict) -> None:
    """The training-smoke gate of docs/TRAINING.md on the card (smoke_config,
    40 steps; the loss falls, refinement raises held-out PSNR), and its first
    3 losses against the same run on the host."""
    from repro_torch.launch.ct_train import CTTrainer, _check_run, smoke_config
    cfg = smoke_config(geometry)
    trainer = CTTrainer(cfg)
    losses, t_fit = host_s(torch, lambda: trainer.fit(log_every=0))
    metrics = trainer.evaluate()
    host = CTTrainer(cfg, device="cpu")
    host_losses = [float(host.train_step(*host.data(i))) for i in range(3)]
    host_rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:3], host_losses))
    out["smoke"] = {"losses": losses, "fit_s": t_fit, "metrics": metrics,
                    "host_losses": host_losses, "card_vs_host_rel": host_rel}
    log(f"train {geometry} smoke: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"({t_fit:.2f} s), PSNR net {metrics['psnr_net']:.3f} -> refined "
        f"{metrics['psnr_refined']:.3f} dB; first 3 losses card vs host {host_rel:.3g}")
    fails = _check_run(geometry, losses, metrics)
    check(not fails, "; ".join(fails))
    check(host_rel < TRAIN_HOST_TOL, f"train {geometry} smoke: card vs host {host_rel:.3g}")


def train_full(torch, results, geometry: str, out: dict):
    """A short fit at n = 512 with the TrainConfig defaults: the median step
    (CUDA events between steps, after the warm-up step, host data included),
    the peak memory, and evaluate(n_test=2), beside the step's breakdown
    from ``train_breakdowns``.  Returns the first loss."""
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    cfg = TrainConfig(geometry=geometry, n=TRAIN_N, steps=TRAIN_STEPS[geometry])
    trainer = CTTrainer(cfg)
    _, data_s = host_s(torch, lambda: trainer.pipe.batch(0))
    events = []

    def on_step(i, loss):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, fit_s = host_s(torch, lambda: trainer.fit(log_every=0, on_step=on_step))
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    check(len(losses) == cfg.steps and all(np.isfinite(losses)),
          f"train {geometry} n={cfg.n}: losses {losses}")
    metrics, eval_s = host_s(torch, lambda: trainer.evaluate(n_test=2))
    bd = results["train_breakdown"][geometry]
    out["full"] = {
        "n": cfg.n, "batch": cfg.batch, "steps": cfg.steps, "losses": losses,
        "fit_s": fit_s, "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms, "host_batch_s": data_s, "peak_bytes": peak,
        "train_step_ms": bd["ms"], "device_busy_share": bd["device_busy_share"],
        "device_ms_by_category": bd["device_ms_by_category"],
        "events_complete": bd["events_complete"], "metrics": metrics, "evaluate_s": eval_s}
    log(f"train {geometry} n={cfg.n} batch {cfg.batch}: {cfg.steps} steps, loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; step {statistics.median(step_ms):.2f} ms "
        f"median (host batch {data_s * 1e3:.1f} ms), train_step {bd['ms']:.2f} ms, "
        f"busy {bd['device_busy_share']:.3f}, peak {peak / 2**30:.2f} GiB; "
        f"evaluate(2): PSNR net {metrics['psnr_net']:.3f} -> refined "
        f"{metrics['psnr_refined']:.3f} dB, residual {metrics['dc_net']:.4f} -> "
        f"{metrics['dc_refined']:.4f} ({eval_s:.2f} s) [{results['device']}]")
    for k in ("psnr_net", "psnr_refined", "dc_net", "dc_refined"):
        check(np.isfinite(metrics[k]), f"train {geometry}: {k} {metrics[k]}")
    check(metrics["dc_refined"] < metrics["dc_net"],
          f"train {geometry}: refinement did not lower the residual")
    del trainer
    torch.cuda.empty_cache()
    return losses[0]


def train_bf16(torch, first_f32: float, out: dict) -> None:
    """compute_dtype="bfloat16" at limited_angle n = 512, 3 steps: the first
    loss within BF16_FP_REL_BOUND of the f32 run's (same weights, batch)."""
    from repro_torch.kernels import precision
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    cfg = TrainConfig(geometry="limited_angle", n=TRAIN_N, steps=3,
                      compute_dtype="bfloat16")
    losses = CTTrainer(cfg).fit(log_every=0)
    rel = abs(losses[0] - first_f32) / abs(first_f32)
    out["bf16"] = {"losses": losses, "first_loss_rel_to_f32": rel}
    log(f"train limited_angle n={TRAIN_N} bf16: losses {losses}, first vs f32 {rel:.3g} "
        f"(bound {precision.BF16_FP_REL_BOUND:.3g})")
    check(all(np.isfinite(losses)), "train bf16: non-finite loss")
    check(rel < precision.BF16_FP_REL_BOUND, f"train bf16: first loss {rel:.3g} off f32")


class _Stop(Exception):
    pass


def train_resume(torch, out: dict) -> None:
    """Fit 6 steps with a checkpoint every 3, stopped after step 4; a new
    trainer resumes from step 3 and its losses equal the uninterrupted
    run's, under deterministic cuDNN (restored after)."""
    import shutil
    from repro_torch.launch.ct_train import CTTrainer, smoke_config
    cfg = smoke_config("sparse_fan", steps=6, ckpt_every=3)
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        full = CTTrainer(cfg).fit(log_every=0)

        def stop(i, loss):
            if i == 3:
                raise _Stop

        ck = cfg.replace(ckpt_dir=str(d))
        try:
            CTTrainer(ck).fit(log_every=0, on_step=stop)
        except _Stop:
            pass
        again = CTTrainer(ck)
        rest = again.fit(log_every=0)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        shutil.rmtree(d, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(rest, full[3:]))
    out["resume"] = {"full": full, "resumed": rest, "rel": rel}
    log(f"train resume: steps 3-5 resumed {rest} vs uninterrupted {full[3:]} (rel {rel:.3g})")
    check(len(rest) == 3, f"train resume: {len(rest)} steps after the resume, not 3")
    check(rel < TRAIN_RESUME_TOL, f"train resume: rel {rel:.3g}")


def train_breakdowns(torch, results) -> None:
    """Device time of one train_step at n = 512 by category, per geometry
    (TrainConfig defaults, a fixed batch), measured by a process of its own
    (``chip_smoke.py --train-breakdown FILE``) whose first profiler sessions
    these are: a session that follows others in one process has lost
    kernel events, or seen none.  Each checks the profiler's kernel events
    against the counted launches."""
    t = time.perf_counter()
    out = ROOT / "chiprun_out" / "train_breakdown.json"
    out.parent.mkdir(exist_ok=True)
    subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-breakdown",
                    str(out)], check=True, timeout=600)
    results["train_breakdown"] = json.loads(out.read_text())
    results["phase_s"]["train_breakdown"] = time.perf_counter() - t


def train_breakdown_child(torch, out: pathlib.Path) -> int:
    """The process of ``train_breakdowns``: writes its section to ``out``."""
    from repro_torch.kernels import build
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    build.build_all()
    results = {}
    for geometry in TRAIN_KERNELS:
        trainer = CTTrainer(TrainConfig(geometry=geometry, n=TRAIN_N))
        batch = trainer.data(0)
        category_breakdown(torch, results, geometry,
                           lambda: trainer.train_step(*batch),
                           section="train_breakdown", classify=train_category,
                           categories=TRAIN_CATEGORIES)
        del trainer, batch
        torch.cuda.empty_cache()
    out.write_text(json.dumps(results["train_breakdown"]))
    return 0


def train_path(torch, results, geometry: str) -> None:
    """One geometry of the training phase: the smoke gate on the card and
    host, the kernel pair against the plain pair (at n = 512; helical at the
    smoke size, whose plain pair at n = 512 takes minutes), the n = 512 fit;
    limited_angle adds bf16, sparse_fan the resume check."""
    from repro_torch.launch.ct_train import TrainConfig, smoke_config
    out = {}
    train_smoke(torch, geometry, out)
    train_step_vs_plain(torch, smoke_config(geometry) if geometry == "helical"
                        else TrainConfig(geometry=geometry, n=TRAIN_N), out)
    first = train_full(torch, results, geometry, out)
    if geometry == "limited_angle":
        train_bf16(torch, first, out)
    if geometry == "sparse_fan":
        train_resume(torch, out)
    results.setdefault("train", {})[geometry] = out


def train_paths(torch, results) -> None:
    """The CT training phase: one path per geometry, each with its kernels'
    launch counts."""
    t = time.perf_counter()
    for geometry, kernels in TRAIN_KERNELS.items():
        run_path(torch, results, f"train_{geometry}", kernels,
                 lambda g=geometry: train_path(torch, results, g))
    results["phase_s"]["train"] = time.perf_counter() - t


# --------------------------------------------------------------------------- #
# CT serving and the autotuner
# --------------------------------------------------------------------------- #
# A served answer against the solver on its request alone (rel L2).  The
# kernels give each lane the same bits at any lane count, and CGLS reduces
# its inner products one sample at a time, so the iterative answers are
# bit-equal to their requests alone; FBP/FDK chunk their views by the batch.
SERVE_TOL = 2e-4
# Every SERVE_ALONE_EVERY-th request of a bucket is solved again alone and
# held to its served answer (and its serial one): 44 of the 176.  All of
# them took 53.8 s of the run on an NVIDIA H100 80GB HBM3 at 700 W, time
# that went to the lm_tp phase.
SERVE_ALONE_EVERY = 4
SERVE_MAX_BATCH = 16
SERVE_PLAIN_CHUNK = 8        # requests a plain call: the kernel phase's batch
SERVE_KERNELS = ("fp_par_sf", "bp_par_sf", "fp_fan_sf", "bp_fan_sf")


def serve_buckets() -> dict:
    """name -> (geometry, solver, solver kwargs, requests): the scanner-farm
    burst's five buckets, each at an existing cell's full width."""
    main, fan, cone = main_geometry(), fan_geometry("flat"), cone_packed_geometry()
    return {
        "serve_main_fbp": (main, "fbp", {}, 64),
        "serve_main_sirt": (main, "sirt", {"n_iters": 50}, 32),
        "serve_main_fista": (main, "fista_tv", {"n_iters": 30}, 16),
        "serve_fan_cgls": (fan, "cgls", {"n_iters": 20}, 32),
        "serve_cone_packed_fdk": (cone, "fbp", {}, 32),
    }


def image_rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def serve_sinograms(torch, geom, n: int):
    """n sinograms (numpy, on the host, as a scanner sends them): the
    forward projections on the card of the cells' ellipse phantoms, seeds
    0..n-1 (2D), or slabs blended along z from seeds s and s + 8."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.data.phantoms import random_ellipse_phantom
    proj = Projector(ProjectorSpec(geom))
    out = []
    for s0 in range(0, n, 8):
        seeds = range(s0, min(n, s0 + 8))
        if geom.vol.nz == 1:
            x = torch.from_numpy(np.stack([random_ellipse_phantom(s, geom.vol)[0]
                                           for s in seeds])[..., None]).cuda()
        else:
            x = helical_phantoms(torch, geom.vol, seeds)
        out.extend(proj(x).cpu().numpy())
    return out


def warm_state(srv) -> dict:
    """What a warm server's request path must leave as it is."""
    from repro_torch.kernels import build, ops, tune
    st = ops.cache_stats()
    return {"sweeps": tune.sweep_count(), "cache_size": st["size"],
            "cache_misses": st["misses"], "executors": set(srv._executors),
            "loaded": build.loaded()}


def check_warm(before: dict, after: dict, what: str) -> None:
    for k in before:
        check(after[k] == before[k], f"{what}: {k} changed on the request path "
              f"({before[k]} -> {after[k]})")


def alone(torch, geom, solver: str, kw: dict, y):
    """The bucket's solver on one request alone, through Projector on the
    card; FISTA-TV with the Lipschitz constant its server computes."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch import recon
    proj = Projector(ProjectorSpec(geom))
    yd = torch.from_numpy(y).cuda()
    with torch.no_grad():
        if solver == "fbp":
            return proj.fbp(yd).cpu()
        if solver == "fista_tv":
            kw = dict(kw, L=float(recon.power_iteration(proj)) * 1.05)
        return getattr(recon, solver)(proj, yd, **kw).image.cpu()


def plain_pair(torch, geom):
    """The plain version of the pair that ``ProjectorSpec(geom)`` runs: the
    ``ref`` backend, or, where ``mode="auto"`` resolves the packed cone pair
    (the ``ref`` backend runs the exact cone pair there), the plain
    composition around its plan, as ``cone_packed_path`` holds it."""
    from repro_torch import Projector, ProjectorSpec, resolve_mode
    from repro_torch.kernels import fp_par
    from repro_torch.kernels.fp_fan import ConePackedPlan
    if resolve_mode(ProjectorSpec(geom)) == "packed":
        plan = ConePackedPlan(geom)
        return (lambda x: fp_par.fp_packed(x, plan, torch.float32,
                                           lambda g: fp_par.fp_lanes_plain(g, plan)),
                lambda y: fp_par.bp_packed(y, plan, torch.float32,
                                           lambda q: fp_par.bp_lanes_plain(q, plan)))
    plain = Projector(ProjectorSpec(geom, backend="ref"))
    return plain, plain.T


def served_vs_plain(torch, geom, x, y) -> tuple:
    """The server's kernel pair at a served batch's own lane count against
    its plain version (max-abs relative): the FP of the batch's answers
    ``x`` and the BP of its packed sinograms ``y``, the whole size class
    each; the plain pair runs SERVE_PLAIN_CHUNK requests a call (its memory
    at the kernel phase's batch), which gives each request the same
    values."""
    from repro_torch import Projector, ProjectorSpec
    kern = Projector(ProjectorSpec(geom))
    fp_plain, bp_plain = plain_pair(torch, geom)
    xd, yd, c = x.cuda(), torch.from_numpy(y).cuda(), SERVE_PLAIN_CHUNK
    with torch.no_grad():
        fp_err = rel_err(kern(xd), torch.cat([fp_plain(xd[i:i + c])
                                              for i in range(0, len(xd), c)]))
        bp_err = rel_err(kern.T(yd), torch.cat([bp_plain(yd[i:i + c])
                                                for i in range(0, len(yd), c)]))
    return fp_err, bp_err


def latency_ms(resps) -> dict:
    lat = np.array([r.latency_s for r in resps]) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def serve_phase(torch, results) -> None:
    """The scanner-farm burst: five buckets at full width (SERVE_BUCKETS),
    submitted interleaved to one warmed CTServer(max_batch=16) and drained.
    Every answer bit-equal to the solver on its own packed batch, and
    against its request alone on the card (SERVE_TOL); for one dispatch of
    each bucket, the kernel pair at that batch's lane count against the
    plain pair (F32_TOL: the FP of the answers, the BP of the sinograms);
    interactive dispatches first, one bucket a dispatch; warm() leaves the
    burst no sweep, op-cache miss or entry, executor or library to make;
    rows 1-4 launched by the burst (run_path); per bucket wall time, us a
    recon batched (and serial, max_batch=1, for the interactive buckets),
    p50/p99 latency and the size-class histogram; then a batch executor
    that raises leaves its batch mates answered."""
    from collections import Counter
    from repro_torch import ProjectorSpec
    from repro_torch.launch.ct_serve import CTServer, ReconRequest
    t_phase = time.perf_counter()
    buckets = serve_buckets()
    out = {"max_batch": SERVE_MAX_BATCH, "buckets": {}}
    t = time.perf_counter()
    sinos = {}
    for name, (geom, _, _, n) in buckets.items():
        cell = geom.canonical_hash()
        if cell not in sinos or len(sinos[cell]) < n:
            sinos[cell] = serve_sinograms(torch, geom, n)
    out["setup_s"] = time.perf_counter() - t
    specs = {name: ProjectorSpec(b[0]) for name, b in buckets.items()}

    srv = CTServer(max_batch=SERVE_MAX_BATCH)
    t = time.perf_counter()
    for name, (geom, solver, kw, _) in buckets.items():
        srv.warm(specs[name], solver, kw)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t
    log(f"serve: sinograms {out['setup_s']:.1f} s, warm {out['warm_s']:.1f} s "
        f"({len(srv._executors)} executors)")

    order = []                                   # interleaved: one of each in turn
    for i in range(max(b[3] for b in buckets.values())):
        order += [(name, i) for name, b in buckets.items() if i < b[3]]
    rid_of = {}

    def burst():
        before = warm_state(srv)
        for name, i in order:
            geom, solver, kw, _ = buckets[name]
            rid = srv.submit(ReconRequest(spec=specs[name],
                                          sino=sinos[geom.canonical_hash()][i],
                                          solver=solver, solver_kwargs=dict(kw)))
            rid_of[rid] = (name, i)
        t0 = time.perf_counter()
        srv.drain()
        torch.cuda.synchronize()
        out["burst_s"] = time.perf_counter() - t0
        check_warm(before, warm_state(srv), "serve burst")

    out["launches"] = run_path(torch, results, "serve", SERVE_KERNELS, burst)
    done = srv.take_responses()
    check(len(done) == len(order) == sum(b[3] for b in buckets.values()),
          f"serve: {len(done)} responses for {len(order)} requests")
    bad = [(rid_of[r], d.error) for r, d in done.items() if not d.ok]
    check(not bad, f"serve: failed requests {bad[:4]}")
    tiers = [rec["tier"] for rec in srv.dispatch_log]
    check(tiers == sorted(tiers, key=("interactive", "quality").index),
          f"serve: a quality dispatch came before an interactive one: {tiers}")
    for rec in srv.dispatch_log:
        names = {rid_of[r][0] for r in rec["rids"]}
        check(len(names) == 1, f"serve: one dispatch held buckets {names}")
        rec["name"] = names.pop()

    # each answer: the solver's on its own packed batch, bit for bit (the
    # server adds nothing), and on that request alone within the tolerance;
    # the first batch of each bucket also holds the kernel pair at its lane
    # count against the plain pair
    t = time.perf_counter()
    for rec in srv.dispatch_log:
        name = rec["name"]
        geom, solver, kw, _ = buckets[name]
        ys = sinos[geom.canonical_hash()]
        pack = np.zeros((rec["size_class"],) + geom.sino_shape, np.float32)
        for j, r in enumerate(rec["rids"]):
            pack[j] = ys[rid_of[r][1]]
        got = alone(torch, geom, solver, kw, pack)
        same = [bool(torch.equal(done[r].image, got[j])) for j, r in enumerate(rec["rids"])]
        check(all(same), f"serve {name}: {same.count(False)} answers differ "
              f"from the solver on the same packed batch")
        if name in out["buckets"]:
            continue
        fp_err, bp_err = served_vs_plain(torch, geom, got, pack)
        lanes = rec["size_class"] * geom.n_rows
        out["buckets"][name] = {"max_rel_l2": 0.0, "bit_equal": 0, "plain_lanes": lanes,
                                "fp_vs_plain": fp_err, "bp_vs_plain": bp_err}
        log(f"serve {name}: a batch of {rec['size_class']} ({lanes} lanes), kernel "
            f"pair vs plain: FP of its answers {fp_err:.3g}, BP of its sinograms "
            f"{bp_err:.3g}")
        check(fp_err <= F32_TOL and bp_err <= F32_TOL,
              f"serve {name}: kernel pair at {lanes} lanes vs plain FP {fp_err:.3g}, "
              f"BP {bp_err:.3g} > {F32_TOL}")
    out["pack_check_s"] = time.perf_counter() - t
    t = time.perf_counter()
    want = {}
    for rid, (name, i) in rid_of.items():
        b = out["buckets"].setdefault(name, {"max_rel_l2": 0.0, "bit_equal": 0})
        b.setdefault("alone", 0)
        if i % SERVE_ALONE_EVERY:
            continue
        geom, solver, kw, _ = buckets[name]
        want[(name, i)] = alone(torch, geom, solver, kw, sinos[geom.canonical_hash()][i])
        err = image_rel_l2(done[rid].image, want[(name, i)])
        b["max_rel_l2"] = max(b["max_rel_l2"], err)
        b["alone"] += 1
        b["bit_equal"] += bool(torch.equal(done[rid].image, want[(name, i)]))
        check(err <= SERVE_TOL, f"serve {name} request {i}: rel L2 {err:.3g} "
              f"against the request alone > {SERVE_TOL}")
    out["alone_s"] = time.perf_counter() - t

    for name, (geom, solver, kw, n) in buckets.items():
        b = out["buckets"][name]
        recs = [rec for rec in srv.dispatch_log if rec["name"] == name]
        b["wall_s"] = sum(rec["wall_s"] for rec in recs)
        b["us_per_recon"] = b["wall_s"] / n * 1e6
        b["size_classes"] = dict(sorted(Counter(rec["size_class"] for rec in recs).items()))
        b.update(latency_ms([d for r, d in done.items() if rid_of[r][0] == name]))

    # serial baseline (max_batch=1) of the interactive buckets
    serial = CTServer(max_batch=1)
    inter = [name for name, b in buckets.items() if b[1] == "fbp"]
    for name in inter:
        geom, solver, kw, _ = buckets[name]
        serial.warm(specs[name], solver, kw, batch_sizes=(1,))
    srid = {}
    for name, i in order:
        if name in inter:
            geom, solver, kw, _ = buckets[name]
            srid[serial.submit(ReconRequest(
                spec=specs[name], sino=sinos[geom.canonical_hash()][i],
                solver=solver, solver_kwargs=dict(kw)))] = (name, i)
    sdone = serial.drain()
    for rec in serial.dispatch_log:
        rec["name"] = srid[rec["rids"][0]][0]
    for name in inter:
        b = out["buckets"][name]
        recs = [rec for rec in serial.dispatch_log if rec["name"] == name]
        b["serial_wall_s"] = sum(rec["wall_s"] for rec in recs)
        b["serial_us_per_recon"] = b["serial_wall_s"] / buckets[name][3] * 1e6
        b["batched_over_serial"] = b["serial_us_per_recon"] / b["us_per_recon"]
        sl = latency_ms([d for r, d in sdone.items() if srid[r][0] == name])
        b["serial_p50_ms"], b["serial_p99_ms"] = sl["p50_ms"], sl["p99_ms"]
    for r, d in sdone.items():
        check(d.ok, f"serve serial {srid[r]}: {d.error}")
        check(srid[r] not in want or image_rel_l2(d.image, want[srid[r]]) <= SERVE_TOL,
              f"serve serial {srid[r]}: differs from alone")
    for tier in ("interactive", "quality"):
        out[tier] = latency_ms([d for d in done.values() if d.tier == tier])

    for name, b in out["buckets"].items():
        serial_s = (f", serial {b['serial_us_per_recon']:.1f} us a recon "
                    f"({b['batched_over_serial']:.2f}x), serial p50/p99 "
                    f"{b['serial_p50_ms']:.1f}/{b['serial_p99_ms']:.1f} ms"
                    if "serial_us_per_recon" in b else "")
        log(f"{name}: {buckets[name][3]} requests, wall {b['wall_s']:.3f} s, "
            f"{b['us_per_recon']:.1f} us a recon batched{serial_s}; latency "
            f"p50 {b['p50_ms']:.1f} ms p99 {b['p99_ms']:.1f} ms; size classes "
            f"{b['size_classes']}; vs alone ({b['alone']} of them) max rel L2 "
            f"{b['max_rel_l2']:.3g}, {b['bit_equal']}/{b['alone']} bit-equal")
    log(f"serve tiers: interactive p50/p99 {out['interactive']['p50_ms']:.1f}/"
        f"{out['interactive']['p99_ms']:.1f} ms, quality "
        f"{out['quality']['p50_ms']:.1f}/{out['quality']['p99_ms']:.1f} ms; burst "
        f"{out['burst_s']:.2f} s, {len(srv.dispatch_log)} dispatches")

    # a batch executor that raises: its batch mates are re-run one by one
    key = srv.bucket_key(ReconRequest(spec=specs["serve_main_fbp"],
                                      sino=sinos[buckets["serve_main_fbp"][0]
                                                 .canonical_hash()][0],
                                      solver="fbp"))
    saved = {k: srv._executors[(key, k)] for k in (1, 4)}

    def exploding_batch(batch):
        raise RuntimeError("batch executor blew up")

    def picky_single(batch):
        if float(batch.sum()) < 0:
            raise RuntimeError("poisoned request")
        return saved[1](batch)

    srv._executors[(key, 4)], srv._executors[(key, 1)] = exploding_batch, picky_single
    try:
        main_sinos = sinos[buckets["serve_main_fbp"][0].canonical_hash()]
        good = [srv.submit(ReconRequest(spec=specs["serve_main_fbp"],
                                        sino=main_sinos[i], solver="fbp"))
                for i in range(3)]
        poisoned = srv.submit(ReconRequest(spec=specs["serve_main_fbp"],
                                           sino=-np.abs(main_sinos[3]), solver="fbp"))
        iso = srv.drain()
    finally:
        srv._executors.update({(key, k): v for k, v in saved.items()})
    geom, solver, kw, _ = buckets["serve_main_fbp"]
    for i, rid in enumerate(good):
        ref = want.get(("serve_main_fbp", i))
        if ref is None:
            ref = alone(torch, geom, solver, kw, main_sinos[i])
        check(iso[rid].ok and image_rel_l2(iso[rid].image, ref) <= SERVE_TOL,
              f"serve isolation: batch mate {i} {iso[rid].error}")
    check(not iso[poisoned].ok and "poisoned" in iso[poisoned].error,
          f"serve isolation: the poisoned request answered {iso[poisoned].error}")
    out["isolation"] = "ok"
    log("serve isolation: a raising batch executor left its 3 batch mates "
        "answered; the poisoned request failed alone")
    results["serve"] = out
    results["phase_s"]["serve"] = time.perf_counter() - t_phase


def autotune_phase(torch, results) -> None:
    """The autotuner on the card: sweeps of the main and fan cells at batch
    8 in f32 (each candidate's FP and BP ms; the heuristic's pair against
    the tuned pair), the tuned pair against the plain pair (F32_TOL) and
    the dot test (< 1e-4), the winner read back from the run's cache file
    with no new sweep; then a SIRT bucket's server warmed with
    REPRO_TORCH_AUTOTUNE=1 sweeps inside warm() and not in its burst."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch.data.phantoms import random_ellipse_phantom
    from repro_torch.kernels import tune
    from repro_torch.launch.ct_serve import CTServer, ReconRequest
    t_phase = time.perf_counter()
    out = {}
    for name, geom in (("main", main_geometry()), ("fan", fan_geometry("flat"))):
        tune.clear()
        n0 = tune.sweep_count()
        cfg, t_sweep = host_s(torch, lambda: tune.autotune(
            geom, 8, torch.float32, device="cuda"))
        rec = tune.last_sweep()
        check(tune.sweep_count() == n0 + 1 and rec.get("tuned") == cfg,
              f"autotune {name}: sweep not recorded ({rec.get('tuned')} vs {cfg})")
        for (lg, bu), ms in sorted(rec["fp_ms"].items()):
            log(f"autotune {name} FP lg {lg} bu {bu}: {ms:.4f} ms")
        for (lg, bg), ms in sorted(rec["bp_ms"].items()):
            log(f"autotune {name} BP lg {lg} bg {bg}: {ms:.4f} ms")
        heur = rec["heuristic"]
        log(f"autotune {name}: heuristic {heur} pair {rec['heuristic_ms']:.4f} ms, "
            f"tuned {cfg} pair {rec['tuned_ms']:.4f} ms, sweep {t_sweep:.2f} s")
        x = torch.from_numpy(np.stack([random_ellipse_phantom(s, geom.vol)[0]
                                       for s in range(8)])[..., None]).cuda()
        gen = torch.Generator(device="cuda").manual_seed(3)
        y = torch.randn((8,) + geom.sino_shape, generator=gen, device="cuda")
        tuned = Projector(ProjectorSpec(geom, config=cfg))
        plain = Projector(ProjectorSpec(geom, backend="ref"))
        ax = tuned(x)
        fp_err, bp_err = rel_err(ax, plain(x)), rel_err(tuned.T(y), plain.T(y))
        dot = abs(vdot64(ax, y) - vdot64(x, tuned.T(y))) / abs(vdot64(ax, y))
        check(fp_err <= F32_TOL and bp_err <= F32_TOL and dot < 1e-4,
              f"autotune {name}: tuned pair vs plain FP {fp_err:.3g}, BP "
              f"{bp_err:.3g}, dot {dot:.3g}")
        path = tune.cache_path()
        check(path.exists() and str(path) == os.environ[tune.CACHE_PATH_ENV],
              f"autotune {name}: no cache file at {path}")
        tune.clear()
        n1 = tune.sweep_count()
        back = tune.get_config(geom, 8, torch.float32, device="cuda")
        check(back == cfg and tune.sweep_count() == n1,
              f"autotune {name}: read back {back} (want {cfg}), sweeps "
              f"{tune.sweep_count() - n1}")
        out[name] = {"fp_ms": {f"{k[0]},{k[1]}": v for k, v in rec["fp_ms"].items()},
                     "bp_ms": {f"{k[0]},{k[1]}": v for k, v in rec["bp_ms"].items()},
                     "heuristic": dataclasses.asdict(heur),
                     "heuristic_ms": rec["heuristic_ms"],
                     "tuned": dataclasses.asdict(cfg), "tuned_ms": rec["tuned_ms"],
                     "sweep_s": t_sweep, "fp_rel_err": fp_err, "bp_rel_err": bp_err,
                     "dot": dot}
        log(f"autotune {name}: tuned pair vs plain FP {fp_err:.3g}, BP {bp_err:.3g}, "
            f"dot {dot:.3g}; read back from disk with no sweep")

    # a server warmed with autotuning on sweeps in warm() only
    geom = main_geometry()
    spec = ProjectorSpec(geom)
    kw = {"n_iters": 5}
    os.environ[tune.AUTOTUNE_ENV] = "1"
    try:
        tune.clear()
        srv = CTServer(max_batch=SERVE_MAX_BATCH)
        s0 = tune.sweep_count()
        srv.warm(spec, "sirt", kw)
        torch.cuda.synchronize()
        warm_sweeps = tune.sweep_count() - s0
        check(warm_sweeps > 0, "autotuned warm(): no sweep")
        ys = serve_sinograms(torch, geom, 24)
        before = warm_state(srv)
        rids = [srv.submit(ReconRequest(spec=spec, sino=y, solver="sirt",
                                        solver_kwargs=dict(kw))) for y in ys]
        done = srv.drain()
        check_warm(before, warm_state(srv), "autotuned server burst")
        errs = [image_rel_l2(done[r].image, alone(torch, geom, "sirt", kw, y))
                for r, y in zip(rids, ys)]
        check(all(done[r].ok for r in rids) and max(errs) <= SERVE_TOL,
              f"autotuned server: max rel L2 vs alone {max(errs):.3g}")
    finally:
        os.environ[tune.AUTOTUNE_ENV] = "0"
    out["server"] = {"warm_sweeps": warm_sweeps, "burst_sweeps": 0,
                     "requests": len(rids), "max_rel_l2": max(errs),
                     "size_classes": [rec["size_class"] for rec in srv.dispatch_log]}
    log(f"autotune server (main, SIRT-5, max_batch {SERVE_MAX_BATCH}): {warm_sweeps} "
        f"sweeps in warm(), 0 in a burst of {len(rids)} (size classes "
        f"{out['server']['size_classes']}); max rel L2 vs alone {max(errs):.3g}")
    results["autotune"] = out
    results["phase_s"]["autotune"] = time.perf_counter() - t_phase


# -- sharded recon (core/distributed.py) on torch.distributed --------------- #
# The reference's tests/test_distributed_ct.py tolerances: the sharded pair
# against one device (FP rtol/atol; BP atol of this times max|BP|, :68-78),
# the conditioning-aware dot test (:53-65), overlap against psum (:351-362;
# its atol, as the pair's BP, times max|BP|: at 512^3 a backprojection of
# random views reaches ~100 and cancels to near 0, where f32 sums in two
# orders differ by more than 1e-5 absolute) and SIRT-12 against one device
# (:332-348); CGLS-10 against one device in relative L2.
SHARD_PAIR_TOL = 2e-5
SHARD_DOT_TOL = 1e-6
SHARD_OVERLAP_TOL = 1e-5
SHARD_SIRT_TOL = 1e-4
SHARD_CGLS_TOL = 1e-4
SHARD_KERNELS = {"sharded_main_11": ("fp_par_sf", "bp_par_sf"),
                 "sharded_3d": ("fp_par_sf", "bp_par_sf"),
                 "sharded_cone": ("fp_cone_sf", "bp_cone_sf"),
                 "helical_long": ("fp_modular_sf", "bp_modular_sf"),
                 "dp_train": ("fp_par_sf", "bp_par_sf")}
# dp_train: CTTrainer(data_parallel=True) on 2 ranks against one device.
# The first batch's loss and gradients (relative; L2 over all gradients)
# against the mean of one device's on the same two halves, which run the
# same batch-2 convolutions: DP_HALVES_TOL, for the order of the two-term
# sum and the FBP's scatter, whose atomic adds land in any order.  Against
# one device on the whole batch: DP_BATCH_TOL for the first loss, its
# gradients and the 3 losses, since cuDNN picks other algorithms at batch 4
# than at batch 2 (f32 FFT convolutions round differently; the script logs
# one device's own halves against its batch 4 beside it); each parameter
# within 2 x steps x lr, AdamW's bound on how far two runs can drift apart
# (the convolution biases in front of a group norm have gradients that are
# rounding noise, which AdamW scales up to steps of lr).
# make_ct_dp_train_step's SGD is linear in its gradient: its losses and
# parameters within DP_STEP_TOL (relative, L2 for the parameters).
DP_TRAIN_STEPS = 3
DP_HALVES_TOL = 1e-5
DP_BATCH_TOL = 1e-3
DP_STEP_TOL = 1e-5


def helical_long_geometry():
    """The helical cell's widths over a long object: 512x512x64 voxels of 1
    mm, 8 turns of 8 mm pitch in 3072 views (384 a turn), 6 rows of 2 mm x
    1126 columns of 1 mm, sod 1024, sdd 1536."""
    from repro_torch import VolumeGeometry, helical_beam
    return helical_beam(n_turns=8.0, pitch=8.0, n_angles=3072, n_rows=6,
                        n_cols=1126, vol=VolumeGeometry(512, 512, 64),
                        sod=1024.0, sdd=1536.0, pixel_width=1.0, pixel_height=2.0)


def wall_ms(torch, fn, reps: int = 2) -> float:
    """Median wall time of one call in ms after one warm call (host clock
    around a synchronize): a sharded call's collectives run on the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def rank_setup(torch) -> None:
    """A rank computes as the parent does: no TF32 (main() turns it off
    there; a spawned rank starts from torch's defaults, where cuDNN's
    convolutions take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rank_launches(torch, cell: str) -> dict:
    """This rank's launches of its cell's kernels since the last reset; fails
    if one was not launched."""
    from repro_torch import kernels as K
    launches = K.launches()
    for k in SHARD_KERNELS[cell]:
        check(launches[k] > 0, f"{cell}: kernel {k} was not launched on rank "
                               f"{torch.distributed.get_rank()}")
    return {k: launches[k] for k in SHARD_KERNELS[cell]}


def close(torch, got, want, tol: float, bp: bool, what: str) -> float:
    """``got`` (on the host) against ``want`` at the reference's
    ``_vs_local`` tolerance, on ``want``'s device; returns max |got - want|."""
    got = got.to(want.device)
    atol = tol * float(want.abs().max()) if bp else tol
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=tol, atol=atol),
          f"{what}: max |sharded - one device| {err:.3g} (rtol {tol}, atol {atol:.3g})")
    return err


def shard_cell(torch, rank: int, cell: str, mesh, geom) -> dict:
    """One 4-rank projector cell on every rank: the sharded pair on seeded
    inputs (times, dot test, overlap against psum; on helical_long SIRT-12
    and CGLS-10), counted; on sharded_3d then the power iteration,
    FISTA-TV-3 and refinement-3; then rank 0 holds the gathered results
    against the single-device kernel pair and solvers.  Returns this rank's
    numbers."""
    from repro_torch import Projector, ProjectorSpec
    from repro_torch import kernels as K
    from repro_torch.core.distributed import distribute
    from repro_torch.recon import cgls, sirt
    dev = torch.device("cuda")
    spec = ProjectorSpec(geom)
    out = {"rank": rank}

    def inputs():
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn(geom.vol.shape, generator=gen, device=dev)
        y = torch.randn(geom.sino_shape, generator=gen, device=dev)
        return x, y, torch.abs(torch.randn(geom.vol.shape, generator=gen, device=dev))

    torch.distributed.barrier()            # rank 0 may still be checking a cell
    t_cell = time.perf_counter()
    dp = distribute(spec, mesh, z_axis="model")     # halo: suggest_halo; psum
    ovl = distribute(spec, mesh, z_axis="model", comm="overlap")
    lay = dp._layout
    out.update(halo=dp.shard.halo, comm_blocks=len(ovl._layout.bp_specs),
               mode=lay.fp_spec.resolved_mode, vol_local=lay.vol_local,
               sino_local=lay.sino_local)
    x, y, f = inputs()
    xs, ys, fs = dp.shard_volume(x), dp.shard_sino(y), dp.shard_volume(f)
    del x, y, f
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    ax = dp(xs)
    aty = dp.T(ys)
    out["fp_ms"] = wall_ms(torch, lambda: dp(xs))
    out["bp_ms"] = wall_ms(torch, lambda: dp.T(ys))
    lhs = dp.reduce_partial(torch.sum(ax.double() * ys.double()), "sino")
    rhs = dp.reduce_partial(torch.sum(xs.double() * aty.double()), "vol")
    mass = dp.reduce_partial(torch.sum(torch.abs(ax.double() * ys.double())), "sino")
    out["dot"] = float(abs(lhs - rhs) / (mass + 1e-12))
    check(out["dot"] < SHARD_DOT_TOL, f"{cell}: dot test {out['dot']:.3g}")
    aty_ovl = ovl.T(ys)
    # one timed call of the schedule that is not the default
    out["bp_overlap_ms"] = wall_ms(torch, lambda: ovl.T(ys), reps=1)
    out["overlap_vs_psum"] = float((aty_ovl - aty).abs().max())
    scale = float(aty.abs().max())
    check(torch.allclose(aty_ovl, aty, rtol=SHARD_OVERLAP_TOL,
                         atol=SHARD_OVERLAP_TOL * scale),
          f"{cell}: overlap vs psum max abs {out['overlap_vs_psum']:.3g} "
          f"(max |BP| {scale:.3g})")
    del aty_ovl
    if cell == "helical_long":
        yh = dp(fs)
        res, out["sirt12_s"] = host_s(torch, lambda: sirt(dp, yh, n_iters=12))
        cg, out["cgls10_s"] = host_s(torch, lambda: cgls(dp, yh, n_iters=10))
        hist = res.residual_history
        out["sirt_residual_ratio"] = float(hist[-1] / hist[0])
        check(out["sirt_residual_ratio"] < 0.25,
              f"{cell}: SIRT-12 residual ratio {out['sirt_residual_ratio']:.3g}")
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = rank_launches(torch, cell)
    out["path_s"] = time.perf_counter() - t_cell
    if cell == "sharded_3d":               # after the pair's peak memory
        ys3 = dp(fs)
        ms3 = dp.shard_sino(half_views_mask(torch, geom.sino_shape, dev))
        (L3, fi3, dc3), out["fista3_dc3_s"] = host_s(torch, lambda: sharded_solve(
            dp, ys3, ms3, 0.5 * fs))
        out["fista3_L"] = L3
        out["fista3_hist"] = fi3.residual_history.cpu().tolist()
    # the global tensors, on the host of rank 0
    got = {"fp": dp.gather_sino(ax), "bp": dp.gather_volume(aty)}
    if cell == "sharded_3d":
        got.update(fista3=dp.gather_volume(fi3.image), dc3=dp.gather_volume(dc3))
        del ys3, ms3, fi3, dc3
    if cell == "helical_long":
        got.update(y=dp.gather_sino(yh), sirt=dp.gather_volume(res.image),
                   cgls=dp.gather_volume(cg.image))
        out["sirt_hist"] = res.residual_history.cpu().tolist()
        del yh, res, cg
    got = {k: v.cpu() for k, v in got.items()} if rank == 0 else {}
    del ax, aty, xs, ys, fs, dp, ovl
    torch.cuda.empty_cache()
    if rank != 0:
        return out

    x, y, f = inputs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    proj = Projector(spec)
    fp1, bp1 = proj(x), proj.T(y)
    out["single_fp_ms"] = wall_ms(torch, lambda: proj(x))
    out["single_bp_ms"] = wall_ms(torch, lambda: proj.T(y))
    if cell == "helical_long":
        yg = got["y"].to(dev)
        ref, ref_cg = sirt(proj, yg, n_iters=12), cgls(proj, yg, n_iters=10).image
        del yg
    torch.cuda.synchronize()
    out["single_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if cell == "sharded_3d":
        L1, fi1, dc1 = sharded_solve(proj, proj(f), half_views_mask(
            torch, geom.sino_shape, dev), 0.5 * f)
    out["fp_max_abs_err"] = close(torch, got["fp"], fp1, SHARD_PAIR_TOL, False,
                                  f"{cell} FP")
    out["bp_max_abs_err"] = close(torch, got["bp"], bp1, SHARD_PAIR_TOL, True,
                                  f"{cell} BP")
    if cell == "sharded_3d":
        out["fista3_L_rel_err"] = abs(out["fista3_L"] / L1 - 1)
        check(out["fista3_L_rel_err"] < SHARD_SIRT_TOL,
              f"{cell}: power iteration {out['fista3_L']} vs one device {L1}")
        out["fista3_max_abs_err"] = close(torch, got["fista3"], fi1.image,
                                          SHARD_SIRT_TOL, False, f"{cell} FISTA-TV-3")
        hist = fi1.residual_history.cpu().numpy()
        out["fista3_hist_rel_err"] = float(np.max(np.abs(
            np.asarray(out["fista3_hist"]) - hist) / hist))
        check(out["fista3_hist_rel_err"] < SHARD_SIRT_TOL,
              f"{cell}: FISTA-TV-3 history rel {out['fista3_hist_rel_err']:.3g}")
        got_dc = got["dc3"].to(dev)
        out["dc3_rel_l2"] = float(torch.linalg.vector_norm(got_dc - dc1)
                                  / torch.linalg.vector_norm(dc1))
        check(out["dc3_rel_l2"] < SHARD_CGLS_TOL,
              f"{cell}: refinement-3 rel L2 {out['dc3_rel_l2']:.3g}")
        del fi1, dc1, got_dc
    if cell == "helical_long":
        out["sirt_max_abs_err"] = close(torch, got["sirt"], ref.image,
                                        SHARD_SIRT_TOL, False, f"{cell} SIRT-12")
        hist = ref.residual_history.cpu().numpy()
        out["sirt_hist_rel_err"] = float(np.max(np.abs(np.asarray(out["sirt_hist"])
                                                       - hist) / hist))
        check(out["sirt_hist_rel_err"] < SHARD_SIRT_TOL,
              f"{cell}: SIRT-12 history rel {out['sirt_hist_rel_err']:.3g}")
        got_cg = got["cgls"].to(dev)
        out["cgls_rel_l2"] = float(torch.linalg.vector_norm(got_cg - ref_cg)
                                   / torch.linalg.vector_norm(ref_cg))
        check(out["cgls_rel_l2"] < SHARD_CGLS_TOL,
              f"{cell}: CGLS-10 rel L2 {out['cgls_rel_l2']:.3g}")
        del ref, ref_cg, got_cg
    del x, y, f, proj, got, fp1, bp1
    torch.cuda.empty_cache()
    return out


def half_views_mask(torch, sino_shape, dev):
    """Every other view measured (a few-view refinement)."""
    m = torch.zeros(sino_shape, device=dev)
    m[..., ::2, :, :] = 1.0
    return m


def sharded_solve(op, y, mask, x_net):
    """sharded_3d's solvers on a DistributedProjector or one device: the
    power iteration (3), FISTA-TV-3 with its L, refinement-3."""
    from repro_torch.recon import data_consistency_refine, fista_tv, power_iteration
    L = float(power_iteration(op, n_iters=3)) * 1.05
    return (L, fista_tv(op, y, n_iters=3, L=L),
            data_consistency_refine(op, x_net, y, mask, n_iters=3))


def sharded_world4(rank: int, world: int) -> dict:
    """The three 4-rank projector cells, on every rank of a gloo world of
    ranks sharing the card: sharded_3d and sharded_cone on a (2, 2) mesh,
    helical_long on a (1, 4) mesh."""
    import torch
    rank_setup(torch)
    from repro_torch.core.distributed import distribute
    from repro_torch import ProjectorSpec
    from repro_torch.launch.mesh import Mesh
    mesh22, mesh14 = Mesh((2, 2)), Mesh((1, 4))
    out = {"backend": torch.distributed.get_backend()}
    for cell, mesh, geom in (("sharded_3d", mesh22, table1("parallel_512_180")),
                             ("sharded_cone", mesh22, table1("cone_512_180")),
                             ("helical_long", mesh14, helical_long_geometry())):
        out[cell] = shard_cell(torch, rank, cell, mesh, geom)
        if cell == "sharded_cone":
            try:
                distribute(ProjectorSpec(geom), mesh, z_axis="model", halo=0)
            except ValueError as e:
                out[cell]["halo0_refused"] = str(e)
            check("halo0_refused" in out[cell], "sharded_cone: halo=0 was accepted")
    return out


def main_solve(op, y, mask, x_net) -> dict:
    """sharded_main_11's other solvers on a DistributedProjector or one
    device: FISTA-TV-30 (its own power iteration), refinement-20 of
    ``x_net`` on the measured half of the views, and the projection
    residual of the refined image."""
    from repro_torch.recon import data_consistency_refine, fista_tv, projection_residual
    fi = fista_tv(op, y, n_iters=30)
    dc = data_consistency_refine(op, x_net, y, mask, n_iters=20)
    return {"fista30": fi.image, "fista30_history": fi.residual_history,
            "dc20": dc, "projection_residual": projection_residual(op, dc, y, mask)}


def sharded_main_world(rank: int, world: int) -> dict:
    """sharded_main_11: the main cell (batch 8) on a (1, 1) mesh of one NCCL
    rank with one all-reduce: FP, BP, SIRT-50, FISTA-TV-30,
    refinement-20 (SIRT's image as the prior, half of the views measured)
    and the projection residual bit-equal to the single-device Projector
    (tests/test_distributed_ct.py:213-230)."""
    import torch
    rank_setup(torch)
    from repro_torch import Projector, ProjectorSpec
    from repro_torch import kernels as K
    from repro_torch.core.distributed import distribute
    from repro_torch.data.phantoms import random_ellipse_phantom
    from repro_torch.launch.mesh import Mesh
    from repro_torch.recon import sirt
    cell = "sharded_main_11"
    geom = main_geometry()
    spec = ProjectorSpec(geom)
    x = torch.from_numpy(np.stack([random_ellipse_phantom(s, geom.vol)[0]
                                   for s in range(8)])[..., None]).cuda()
    out = {"backend": torch.distributed.get_backend()}
    t = time.perf_counter()
    K.reset_launches()
    dp = distribute(spec, Mesh((1, 1)), z_axis="model", comm="psum")
    sino = dp(dp.shard_volume(x))
    back = dp.T(dp.shard_sino(sino))
    res = sirt(dp, sino, n_iters=50)
    mask = half_views_mask(torch, sino.shape, sino.device)
    solved, out["fista30_dc20_s"] = host_s(torch, lambda: main_solve(
        dp, sino, mask, res.image))
    out["fp_ms"] = wall_ms(torch, lambda: dp(x))
    out["bp_ms"] = wall_ms(torch, lambda: dp.T(sino))
    out["launches"] = rank_launches(torch, cell)
    out["path_s"] = time.perf_counter() - t
    proj = Projector(spec)
    one = sirt(proj, sino, n_iters=50)
    alone = main_solve(proj, sino, mask, one.image)
    out["single_fp_ms"] = wall_ms(torch, lambda: proj(x))
    out["single_bp_ms"] = wall_ms(torch, lambda: proj.T(sino))
    out["projection_residual"] = float(solved["projection_residual"])
    for name, a, b in (("fp", sino, proj(x)), ("bp", back, proj.T(sino)),
                       ("sirt50", res.image, one.image),
                       ("sirt50_history", res.residual_history, one.residual_history),
                       *((k, v, alone[k]) for k, v in solved.items())):
        out[f"{name}_bit_equal"] = bool(torch.equal(a, b))
        check(out[f"{name}_bit_equal"], f"{cell}: {name} is not bit-equal to one device")
    return out


def dp_train_world(rank: int, world: int) -> dict:
    """dp_train on every rank of a 2-rank gloo world: CTTrainer(data_parallel=
    True) at n = 512 (TrainConfig defaults, batch 4: 2 a rank), the first
    batch's averaged loss and gradients and 3 steps; then
    make_ct_dp_train_step on the trainer's geometry, 5 steps.  Rank 0 runs
    the step on one device on the whole batch."""
    import torch
    rank_setup(torch)
    from repro_torch import Projector, ProjectorSpec
    from repro_torch import kernels as K
    from repro_torch.data.phantoms import random_ellipse_phantom
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    from repro_torch.launch.mesh import pmean
    from repro_torch.launch.train import make_ct_dp_train_step
    cell = "dp_train"
    t = time.perf_counter()
    K.reset_launches()
    cfg = TrainConfig(geometry="limited_angle", n=TRAIN_N, steps=DP_TRAIN_STEPS,
                      data_parallel=True)
    trainer = CTTrainer(cfg)
    loss0, grads0 = pmean(trainer._mesh, "data",
                          *trainer.grad_fn(trainer.params, *trainer.data(0)))
    events = []

    def on_step(i, loss):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    losses = trainer.fit(log_every=0, on_step=on_step)
    torch.cuda.synchronize()
    out = {"backend": torch.distributed.get_backend(), "loss0": float(loss0),
           "grads0": {k: v.cpu().numpy() for k, v in grads0.items()},
           "losses": losses,
           "params": {k: v.cpu().numpy() for k, v in trainer.params.items()},
           "step_ms": [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])],
           "lr": cfg.lr}
    geom = trainer.geom
    spec = ProjectorSpec(geom)

    def apply_fn(params, y):
        return params["vol"].expand((y.shape[0],) + geom.vol.shape)

    truth = torch.from_numpy(random_ellipse_phantom(3, geom.vol)[0][..., None]).cuda()
    yb = Projector(spec)(truth).expand((cfg.batch,) + geom.sino_shape).contiguous()

    def run(mesh):
        step = make_ct_dp_train_step(spec, mesh, apply_fn, lr=0.1)
        params, step_losses = {"vol": torch.zeros(geom.vol.shape, device="cuda")}, []
        for _ in range(5):
            params, loss = step(params, yb)
            step_losses.append(float(loss))
        return step_losses, params["vol"]

    step_losses, vol = run(trainer._mesh)
    out["step_losses"] = step_losses
    check(all(b < a for a, b in zip(step_losses, step_losses[1:])),
          f"{cell}: make_ct_dp_train_step's loss did not fall: {step_losses}")
    out["launches"] = rank_launches(torch, cell)
    out["path_s"] = time.perf_counter() - t
    if rank == 0:
        one_losses, one_vol = run(None)
        out["step_one_device"] = one_losses
        out["step_loss_rel_err"] = float(np.max(np.abs(np.subtract(step_losses, one_losses))
                                                / np.abs(one_losses)))
        out["step_vol_rel_l2"] = float(torch.linalg.vector_norm(vol - one_vol)
                                       / torch.linalg.vector_norm(one_vol))
        check(out["step_loss_rel_err"] < DP_STEP_TOL and out["step_vol_rel_l2"] < DP_STEP_TOL,
              f"{cell}: make_ct_dp_train_step on 2 ranks vs one device: losses "
              f"{out['step_loss_rel_err']:.3g}, parameters {out['step_vol_rel_l2']:.3g}")
    return out


def dp_train_compare(torch, ranks: list) -> dict:
    """The 2-rank CTTrainer against CTTrainer on one device, here: the first
    batch's loss and gradients against the mean of one device's on the
    ranks' halves of it (the same batch-2 convolutions: DP_HALVES_TOL) and
    on the whole batch (batch 4: DP_BATCH_TOL), and 3 steps."""
    from repro_torch.launch.ct_train import CTTrainer, TrainConfig
    cfg = TrainConfig(geometry="limited_angle", n=TRAIN_N, steps=DP_TRAIN_STEPS)
    trainer = CTTrainer(cfg)
    batch = trainer.data(0)
    loss0, grads0 = trainer.grad_fn(trainer.params, *batch)
    per = cfg.batch // len(ranks)
    halves = [trainer.grad_fn(trainer.params, *(t[k * per:(k + 1) * per] for t in batch))
              for k in range(len(ranks))]
    loss_h = sum(h[0] for h in halves) / len(ranks)
    grads_h = {k: sum(h[1][k] for h in halves) / len(ranks) for k in grads0}
    losses = trainer.fit(log_every=0)

    def flat(g):
        return np.concatenate([np.asarray(g[k].cpu() if torch.is_tensor(g[k]) else g[k])
                               .ravel() for k in grads0])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    want_g, want_h = flat(grads0), flat(grads_h)
    bound = 2 * DP_TRAIN_STEPS * cfg.lr
    out = {"one_device_losses": losses,
           "halves_vs_batch_grads_rel_l2": rel(want_h, want_g)}
    for r in ranks:
        got_g = flat(r["grads0"])
        out.setdefault("loss0_vs_halves_rel", []).append(abs(r["loss0"] / float(loss_h) - 1))
        out.setdefault("grads0_vs_halves_rel_l2", []).append(rel(got_g, want_h))
        out.setdefault("loss0_rel_err", []).append(abs(r["loss0"] / float(loss0) - 1))
        out.setdefault("grads0_rel_l2", []).append(rel(got_g, want_g))
        out.setdefault("losses_rel_err", []).append(
            float(np.max(np.abs(np.subtract(r["losses"], losses)) / np.abs(losses))))
        out.setdefault("params_max_abs_err", []).append(max(
            float(np.max(np.abs(r["params"][k] - v.cpu().numpy())))
            for k, v in trainer.params.items()))
    check(max(out["loss0_vs_halves_rel"]) < DP_HALVES_TOL
          and max(out["grads0_vs_halves_rel_l2"]) < DP_HALVES_TOL,
          f"dp_train: first loss {out['loss0_vs_halves_rel']}, gradients "
          f"{out['grads0_vs_halves_rel_l2']} against one device on the same halves")
    check(max(out["loss0_rel_err"]) < DP_BATCH_TOL
          and max(out["grads0_rel_l2"]) < DP_BATCH_TOL
          and max(out["losses_rel_err"]) < DP_BATCH_TOL
          and max(out["params_max_abs_err"]) <= bound,
          f"dp_train: first loss {out['loss0_rel_err']}, gradients "
          f"{out['grads0_rel_l2']}, losses {out['losses_rel_err']}, parameters "
          f"{out['params_max_abs_err']} (bound {bound}) against one device at batch 4 "
          f"(one device's halves vs its batch 4: {out['halves_vs_batch_grads_rel_l2']:.3g})")
    a, b = (r["params"] for r in ranks)
    out["ranks_bit_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    check(out["ranks_bit_equal"], "dp_train: the ranks' parameters differ")
    return out


def log_shard_cell(cell: str, rs: list, device: str) -> None:
    r0 = rs[0]
    log(f"{cell}: halo {r0['halo']}, mode "
        f"{r0['mode']}, local vol {r0['vol_local']} sino {r0['sino_local']}; per rank "
        f"FP ms {[round(r['fp_ms'], 2) for r in rs]}, BP ms "
        f"{[round(r['bp_ms'], 2) for r in rs]} (overlap, {r0['comm_blocks']} blocks "
        f"{[round(r['bp_overlap_ms'], 2) for r in rs]}), peak GiB "
        f"{[round(r['peak_gib'], 3) for r in rs]}, launches "
        f"{[r['launches'] for r in rs]}; one device FP {r0['single_fp_ms']:.2f} ms "
        f"BP {r0['single_bp_ms']:.2f} ms, peak {r0['single_peak_gib']:.3f} GiB; "
        f"max abs err FP {r0['fp_max_abs_err']:.3g} BP {r0['bp_max_abs_err']:.3g}; "
        f"dot {max(r['dot'] for r in rs):.3g}; overlap vs psum max abs "
        f"{max(r['overlap_vs_psum'] for r in rs):.3g}; path s "
        f"{[round(r['path_s'], 1) for r in rs]} [{device}]")
    if cell == "sharded_3d":
        log(f"sharded_3d: power iteration 3 L {r0['fista3_L']:.6g} (rel "
            f"{r0['fista3_L_rel_err']:.3g}), FISTA-TV-3 vs one device max abs "
            f"{r0['fista3_max_abs_err']:.3g} (history {r0['fista3_hist_rel_err']:.3g}), "
            f"refinement-3 rel L2 {r0['dc3_rel_l2']:.3g}; the three "
            f"{r0['fista3_dc3_s']:.2f} s")
    if cell == "helical_long":
        log(f"helical_long: SIRT-12 {r0['sirt12_s']:.2f} s (residual ratio "
            f"{r0['sirt_residual_ratio']:.3g}, vs one device max abs "
            f"{r0['sirt_max_abs_err']:.3g}, history {r0['sirt_hist_rel_err']:.3g}), "
            f"CGLS-10 {r0['cgls10_s']:.2f} s (rel L2 {r0['cgls_rel_l2']:.3g})")


def sharded_phase(torch, results) -> None:
    """Sharded recon on torch.distributed: sharded_main_11 on one NCCL rank,
    the three 4-rank cells and dp_train on gloo worlds of ranks that share
    the card (NCCL takes one rank a card).  The kernels are built here,
    before the ranks start; each rank loads them, counts its own launches
    and fails the run if its path's kernels did not run."""
    from repro_torch.launch.mesh import run_world
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = results["sharded"] = {}
    for name, fn, n, backend, timeout in (
            ("sharded_main_11", sharded_main_world, 1, "nccl", 300),
            ("sharded_4", sharded_world4, 4, "gloo", 600),
            ("dp_train", dp_train_world, 2, "gloo", 400)):
        log(f"sharded: {name}: a world of {n} rank(s), backend {backend}")
        t = time.perf_counter()
        ranks = run_world(fn, n, backend=backend, timeout=timeout)
        results["phase_s"][f"world {name}"] = time.perf_counter() - t
        for r, res in enumerate(ranks):
            check(res["backend"] == backend, f"{name}: rank {r} ran {res['backend']}")
        cells = (("sharded_3d", "sharded_cone", "helical_long")
                 if name == "sharded_4" else (name,))
        for cell in cells:
            out[cell] = [res[cell] for res in ranks] if name == "sharded_4" else ranks
            for r, res in enumerate(out[cell]):
                results.setdefault("path_launches", {})[f"{cell} rank {r}"] = \
                    res["launches"]
            if name == "sharded_4":
                log_shard_cell(cell, out[cell], results["device"])
        if name == "sharded_main_11":
            m = ranks[0]
            log(f"sharded_main_11: FP {m['fp_ms']:.3f} ms BP {m['bp_ms']:.3f} ms (one "
                f"device {m['single_fp_ms']:.3f} / {m['single_bp_ms']:.3f}); FP, BP, "
                f"SIRT-50 and its history, FISTA-TV-30 and its history, refinement-20 "
                f"and the projection residual ({m['projection_residual']:.4g}) "
                f"bit-equal; FISTA-TV-30 + refinement-20 {m['fista30_dc20_s']:.2f} s; "
                f"launches {m['launches']} [{results['device']}]")
    d = out["dp_train"]
    c = out["dp_train_vs_one_device"] = dp_train_compare(torch, d)
    log(f"dp_train: losses {[r['losses'] for r in d]} (one device "
        f"{c['one_device_losses']}); against one device on the same halves: first "
        f"loss rel {max(c['loss0_vs_halves_rel']):.3g}, gradients rel L2 "
        f"{max(c['grads0_vs_halves_rel_l2']):.3g}; against its batch 4 (its halves "
        f"vs its batch 4: {c['halves_vs_batch_grads_rel_l2']:.3g}): first loss rel "
        f"{max(c['loss0_rel_err']):.3g}, "
        f"gradients rel L2 {max(c['grads0_rel_l2']):.3g}, losses rel "
        f"{max(c['losses_rel_err']):.3g}, parameters max abs "
        f"{max(c['params_max_abs_err']):.3g}; step ms per rank "
        f"{[np.round(r['step_ms'], 1).tolist() for r in d]}; make_ct_dp_train_step "
        f"losses {d[0]['step_losses']} (one device rel {d[0]['step_loss_rel_err']:.3g}, "
        f"parameters {d[0]['step_vol_rel_l2']:.3g}); launches {[r['launches'] for r in d]} "
        f"[{results['device']}]")
    for r in d:
        r.pop("grads0"), r.pop("params")
    results["phase_s"]["sharded"] = time.perf_counter() - t_phase


# --------------------------------------------------------------------------- #
# lm_tp: tensor parallelism (launch/sharding.py) on two ranks of the card
# --------------------------------------------------------------------------- #
TP_STEPS = 3
TP_BATCH, TP_SEQ = 2, 4096
TP_LOSS_TOL = 1e-3             # step 1's loss, TP vs one device (rel)
TP_LOSSES_TOL = 2e-2           # train_loop's losses, TP vs one device (rel, bf16)
TP_REQUESTS = 4
TP_CUT = 3                     # Hymba's degrade check: layers 0 and 2 global
TP_GRAD_KERNELS = ("flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")


def tp_qwen3_cfg():
    """Qwen3-0.6B at its published widths and depth, one microbatch a step."""
    return dataclasses.replace(lm_train_cfg(), grad_accum=1)


def tp_step_vs_one(torch, name: str, cfg, mesh, rank: int) -> dict:
    """One training step of ``cfg`` from seed 0 on the rank's shards
    against one device's (rank 0) on the same batch: step 1's loss (rel)
    and the update in norm, as a whole and leaf by leaf."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding
    from repro_torch.launch.train import build
    from repro_torch.models import model
    full = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(TokenPipeline(cfg.vocab_size, TP_SEQ, TP_BATCH)
                            .batch(0)).cuda()
    ac = sharding.make_ac(mesh, cfg)
    shards = sharding.shard_params(cfg, full, mesh, specs=ac.specs)
    opt, step = build(cfg, mesh, lr=LM_TRAIN_LR, total_steps=TP_STEPS, ac=ac)
    p, _, m = step(shards, opt.init(model.flatten(shards)), {"tokens": toks})
    del shards
    got = model.flatten(sharding.gather_params(cfg, p, mesh, specs=ac.specs))
    del p
    out = {"loss": float(m["loss"]), "split": ac.split}
    if rank == 0:
        opt1, step1 = build(cfg, None, lr=LM_TRAIN_LR, total_steps=TP_STEPS)
        p1, _, m1 = step1(full, opt1.init(model.flatten(full)), {"tokens": toks})
        p1 = model.flatten(p1)
        p0 = model.flatten(full)
        num = den = 0.0
        upd = {}
        for k, v in got.items():
            d = v.double() - p0[k].double()
            d1 = p1[k].double() - p0[k].double()
            err, ref = float(((d - d1) ** 2).sum()), float((d1 ** 2).sum())
            upd[k] = (err / ref) ** 0.5 if ref > 0 else 0.0
            num, den = num + err, den + ref
        worst = max(upd, key=upd.get)
        out.update({"one_device_loss": float(m1["loss"]),
                    "loss_rel": abs(out["loss"] / float(m1["loss"]) - 1),
                    "update_rel": (num / den) ** 0.5, "update_worst": worst,
                    "update_worst_rel": upd[worst]})
        check(out["loss_rel"] <= TP_LOSS_TOL,
              f"{name}: step 1's loss on 2 ranks {out['loss']} vs one device "
              f"{out['one_device_loss']}: rel {out['loss_rel']:.3g}")
        check(out["update_rel"] <= LM_UPDATE_REL_TOL
              and upd[worst] <= LM_UPDATE_LEAF_REL_TOL,
              f"{name}: update on 2 ranks vs one device {out['update_rel']:.3g}, "
              f"{worst} {upd[worst]:.3g}")
        del p1, p0
    del full, got
    torch.cuda.empty_cache()
    return out


def tp_prefill(torch, mesh, rank: int) -> dict:
    """make_prefill_step on the mesh, 2 x 4096 tokens at Qwen3-0.6B's
    widths: the last-position logits (all-gathered over V) against one
    device's (rank 0), and this rank's flash_fwd launches (row 9)."""
    from repro_torch import kernels as K
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model
    cfg = tp_qwen3_cfg()
    full = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ac = sharding.make_ac(mesh, cfg)
    shards = sharding.shard_params(cfg, full, mesh, specs=ac.specs)
    toks = lm_tokens(torch, cfg, TP_BATCH, TP_SEQ)
    K.reset_launches()
    lg, s = host_s(torch, lambda: make_prefill_step(cfg, ac)(shards, {"tokens": toks}))
    out = {"launches": K.launches()["flash_fwd"], "s": s}
    if rank == 0:
        want = make_prefill_step(cfg)(full, {"tokens": toks})
        out["rel"] = rel_err(lg, want)
        check(out["rel"] <= LM_PREFILL_REL_TOL,
              f"lm_tp prefill on 2 ranks vs one device: rel {out['rel']:.3g}")
    del full, shards, lg
    torch.cuda.empty_cache()
    return out


def tp_train(torch, mesh, rank: int) -> dict:
    """train_loop on the (1, 2) mesh at Qwen3-0.6B's full width and depth:
    TP_STEPS steps of TP_BATCH x TP_SEQ tokens; each step's time (CUDA
    events between the steps' batch draws) and peak memory
    (max_memory_allocated, reset at each draw); the flash kernels'
    launches on this rank.  Rank 0 then runs the same loop on one device
    (the other rank waits), whose losses the phase holds the ranks' to."""
    from repro_torch import kernels as K
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import train_loop
    cfg = tp_qwen3_cfg()
    marks, peaks = [], []

    class Marked(TokenPipeline):
        def batch(self, step=None):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return super().batch(step)

    pipe = Marked(cfg.vocab_size, TP_SEQ, TP_BATCH)
    torch.cuda.synchronize()
    K.reset_launches()
    (params, losses), wall = host_s(torch, lambda: train_loop(
        cfg, mesh, pipe, TP_STEPS, log_every=0, lr=LM_TRAIN_LR))
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    marks[-1].synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    launches = {k: K.launches()[k] for k in TP_GRAD_KERNELS}
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    del params
    torch.cuda.empty_cache()
    out = {"losses": losses, "step_ms": step_ms, "wall_s": wall,
           "step_peak_bytes": peaks[1:], "launches": launches,
           "micro": TP_STEPS * cfg.n_layers}
    if rank == 0:
        params, out["one_device_losses"] = train_loop(
            cfg, None, TokenPipeline(cfg.vocab_size, TP_SEQ, TP_BATCH), TP_STEPS,
            log_every=0, lr=LM_TRAIN_LR)
        del params
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def tp_serve(torch, mesh, rank: int) -> dict:
    """A Server on the mesh answers TP_REQUESTS requests; then the prompts
    and the served tokens are fed through the TP decode step and, on rank
    0, through one device's: each served token must be one device's argmax
    wherever one device's top-2 gap exceeds twice the logits' difference
    (as lm_serve holds decoding against the forward)."""
    from repro_torch.launch import sharding
    from repro_torch.launch.serve import Server
    from repro_torch.models import model
    cfg = tp_qwen3_cfg()
    full = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    reqs = lm_requests(cfg, TP_REQUESTS, 3, 9, 16)
    srv = Server(cfg, mesh, slots=TP_REQUESTS, max_len=32, params=full, device="cuda")
    for r in reqs:
        srv.submit(r)
    done, t_serve = host_s(torch, lambda: {r.rid: r for r in srv.run()})
    check(len(done) == len(reqs), f"lm_tp serve: served {len(done)} of {len(reqs)}")
    tp_params, ac = srv.params, srv.ac
    steps_served = srv.steps
    del srv
    one = model.compute_params(cfg, full) if rank == 0 else None
    del full
    torch.cuda.empty_cache()
    n = len(reqs)
    cache = model.init_cache(cfg, n, 32, "cuda", ac)
    cache1 = model.init_cache(cfg, n, 32, "cuda") if rank == 0 else None
    decided = agree = 0
    worst_gap_err = 0.0
    with torch.no_grad():
        for t in range(max(len(r.prompt) + r.max_new - 1 for r in reqs)):
            feed = [(r.prompt + done[r.rid].out)[min(t, len(r.prompt) + r.max_new - 1)]
                    for r in reqs]
            toks = torch.tensor(feed, device="cuda")
            pos = torch.full((n,), t, device="cuda")
            lg, cache = model.decode_step(cfg, tp_params, cache, toks, pos, ac)
            if rank == 0:
                lg1, cache1 = model.decode_step(cfg, one, cache1, toks, pos)
                err = (lg.float() - lg1.float()).abs().amax(-1)
                gap = top2_gap(lg1)
                for j, r in enumerate(reqs):
                    k = t - (len(r.prompt) - 1)
                    if 0 <= k < len(done[r.rid].out):
                        if float(gap[j]) > 2 * float(err[j]):
                            decided += 1
                            agree += int(int(lg1[j].argmax()) == done[r.rid].out[k])
                        worst_gap_err = max(worst_gap_err, float(err[j]))
    out = {"requests": n, "steps": steps_served, "serve_s": t_serve,
           "ms_per_step": t_serve / steps_served * 1e3,
           "tokens": {r.rid: done[r.rid].out for r in reqs}}
    if rank == 0:
        out.update({"decided": decided, "agree": agree,
                    "tokens_total": sum(len(done[r.rid].out) for r in reqs),
                    "max_logit_err": worst_gap_err})
        check(decided > 0 and agree == decided,
              f"lm_tp serve: {agree} of {decided} decided tokens equal one device's")
    del cache, cache1, tp_params, one
    torch.cuda.empty_cache()
    return out


def lm_tp_world(rank: int, world: int) -> dict:
    """lm_tp on every rank of a (1, 2) gloo world that shares the card:
    Qwen3-0.6B trained (step 1 against one device, then train_loop) and
    served, and the Hymba cut's degrade paths against one device."""
    import torch
    rank_setup(torch)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 2))
    out = {"backend": torch.distributed.get_backend()}
    t = time.perf_counter()
    out["prefill"] = tp_prefill(torch, mesh, rank)
    out["qwen3_step"] = tp_step_vs_one(torch, "lm_tp qwen3", tp_qwen3_cfg(), mesh, rank)
    out["train"] = tp_train(torch, mesh, rank)
    out["serve"] = tp_serve(torch, mesh, rank)
    out["hymba_cut"] = tp_step_vs_one(
        torch, "lm_tp hymba cut", family_cfg("hymba-1.5b", n_layers=TP_CUT, grad_accum=1),
        mesh, rank)
    split = out["hymba_cut"]["split"]
    check(not split["heads"] and not split["vocab"] and split["ssm"] and split["mlp"],
          f"lm_tp hymba cut: splits {split}, want the attention and the vocabulary "
          f"replicated and the Mamba branch and the MLP split")
    out["s"] = time.perf_counter() - t
    return out


def lm_tp_predicted_peak() -> dict:
    """The dry run's prediction for one rank of lm_tp's training step (on
    meta, backend "ref"): arguments + the step's peak allocation."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    shape = ShapeSpec("lm_tp", "train", TP_SEQ, TP_BATCH)
    rec = dryrun.run_cell("qwen3-0.6b", shape, False, {"grad_accum": 1},
                          mesh_shape=(1, 2))
    check(rec["status"] == "ok", f"lm_tp dry run: {rec}")
    return rec


def lm_tp(torch, results) -> None:
    """Tensor parallelism on a (1, 2) world of two gloo ranks sharing the
    card (NCCL refuses two ranks on one card): lm_tp_world, with the dry
    run's memory prediction made in this process meanwhile."""
    import threading
    from repro_torch.launch.mesh import run_world
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    pred = {}
    th = threading.Thread(target=lambda: pred.update(lm_tp_predicted_peak()))
    th.start()
    ranks = run_world(lm_tp_world, 2, backend="gloo", timeout=600)
    th.join()
    check("memory" in pred, "lm_tp: the dry run's prediction failed")
    out = results["lm_tp"] = {"ranks": ranks, "dryrun": pred}
    predicted = pred["memory"]["argument_bytes"] + pred["memory"]["temp_bytes"]
    tokens = TP_BATCH * TP_SEQ
    for r, res in enumerate(ranks):
        tr = res["train"]
        ms = statistics.median(tr["step_ms"][1:])
        tr["ms"], tr["tokens_per_s"] = ms, tokens / (ms / 1e3)
        log(f"lm_tp rank {r}: Qwen3-0.6B, 28 layers, (1, 2) mesh, {TP_BATCH} x {TP_SEQ} "
            f"tokens a step: steps {[round(v, 1) for v in tr['step_ms']]} ms, median after "
            f"the first {ms:.1f} ms, {tr['tokens_per_s']:.0f} tokens/s of the (1, 2) mesh; "
            f"step peaks "
            f"{[round(b / 2 ** 30, 2) for b in tr['step_peak_bytes']]} GiB against the dry "
            f"run's {predicted / 2 ** 30:.2f} GiB (arguments "
            f"{pred['memory']['argument_bytes'] / 2 ** 30:.2f} + temporaries "
            f"{pred['memory']['temp_bytes'] / 2 ** 30:.2f}); launches {tr['launches']}; "
            f"losses {[round(v, 4) for v in tr['losses']]} [{results['device']}]")
    q, h, sv = ranks[0]["qwen3_step"], ranks[0]["hymba_cut"], ranks[0]["serve"]
    log(f"lm_tp step 1 vs one device: Qwen3-0.6B loss rel {q['loss_rel']:.3g} (tol "
        f"{TP_LOSS_TOL}), update rel {q['update_rel']:.3g}, worst leaf {q['update_worst']} "
        f"{q['update_worst_rel']:.3g}; Hymba {TP_CUT}-layer cut (splits {h['split']}) loss "
        f"rel {h['loss_rel']:.3g}, update rel {h['update_rel']:.3g}, worst leaf "
        f"{h['update_worst']} {h['update_worst_rel']:.3g} (tols {LM_UPDATE_REL_TOL} / "
        f"{LM_UPDATE_LEAF_REL_TOL})")
    pf = ranks[0]["prefill"]
    log(f"lm_tp prefill {TP_BATCH} x {TP_SEQ} on 2 ranks: {pf['s'] * 1e3:.1f} ms (first "
        f"call), flash_fwd {[r['prefill']['launches'] for r in ranks]} launches, last-position "
        f"logits vs one device rel {pf['rel']:.3g} (tol {LM_PREFILL_REL_TOL})")
    log(f"lm_tp serve: {sv['requests']} requests, {sv['steps']} steps, "
        f"{sv['ms_per_step']:.1f} ms/step on 2 ranks; {sv['agree']} of {sv['decided']} "
        f"decided tokens (of {sv['tokens_total']}) equal one device's argmax, max logit "
        f"difference {sv['max_logit_err']:.3g}")
    one = ranks[0]["train"]["one_device_losses"]
    log(f"lm_tp train_loop losses on one device {[round(v, 4) for v in one]}")
    out["predicted_peak_bytes"] = predicted
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo", f"lm_tp: rank {r} ran {res['backend']}")
        tr = res["train"]
        want = {"flash_fwd_stats": 2 * tr["micro"], "flash_bwd_dq": tr["micro"],
                "flash_bwd_dkv": tr["micro"]}
        check(tr["launches"] == want, f"lm_tp rank {r}: launches {tr['launches']}, "
                                      f"want {want}")
        check(res["prefill"]["launches"] == tp_qwen3_cfg().n_layers,
              f"lm_tp rank {r}: prefill launched flash_fwd {res['prefill']['launches']} "
              f"times")
        rel = [abs(a / b - 1) for a, b in zip(tr["losses"], one)]
        check(all(np.isfinite(tr["losses"])) and max(rel) <= TP_LOSSES_TOL,
              f"lm_tp rank {r}: losses {tr['losses']} vs one device {one}")
        results.setdefault("path_launches", {})[f"lm_tp rank {r}"] = tr["launches"]
    check(ranks[0]["train"]["losses"] == ranks[1]["train"]["losses"],
          "lm_tp: the ranks' losses differ")
    check(ranks[0]["serve"]["tokens"] == ranks[1]["serve"]["tokens"],
          "lm_tp: the ranks served different tokens")
    results["phase_s"]["lm_tp"] = time.perf_counter() - t_phase
    log(f"lm_tp {results['phase_s']['lm_tp']:.1f} s (rank 0 {ranks[0]['s']:.1f} s) "
        f"[{results['device']}]")


def run_path(torch, results, name: str, kernels, fn) -> dict:
    """Run one path with every launch count set to 0 just before it and read
    just after; fail if a kernel of the path was not launched.  Returns the
    counts of the path's own kernels."""
    from repro_torch import kernels as K
    t = time.perf_counter()
    K.reset_launches()
    fn()
    launches = K.launches()
    results["phase_s"][f"path {name}"] = time.perf_counter() - t
    results.setdefault("path_launches", {})[name] = launches
    log(f"{name} path launches {launches}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name} path")
    if not kernels:
        check(not any(launches.values()),
              f"the {name} path launched kernels: {launches}")
    return {k: launches[k] for k in kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--train-breakdown"]:
        return train_breakdown_child(torch, pathlib.Path(sys.argv[2]))
    if sys.argv[1:2] == ["--iterative-host"]:
        return iterative_host_child(torch, pathlib.Path(sys.argv[2]))
    # A tune cache of this run's own, and the heuristics everywhere but in
    # the autotune phase: a measured configuration must change no kernel
    # time or bit of this run's earlier phases or of a later run.
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_TORCH_TUNE_CACHE_PATH"] = os.path.join(tune_dir, "tune.json")
    os.environ["REPRO_TORCH_AUTOTUNE"] = "0"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    results = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
               "kernels": [], "phase_s": {}}
    try:
        return run_phases(torch, results)
    except BaseException:
        # what ran before the failure, for the time budget
        log("phases before the failure (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in results["phase_s"].items()))
        raise


def run_phases(torch, results) -> int:
    """main's phases: the build, the kernel cells and every path."""
    t_start = time.perf_counter()

    from repro_torch.kernels import build, tune

    only = phases = None
    if len(sys.argv) > 2 and sys.argv[1] == "--cells":
        only = sys.argv[2].split(",")
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        phases = sys.argv[2].split(",")
    t = time.perf_counter()
    if only is None:
        build.build_all(extra=[("fp_cone", "phases"), ("fp_modular", "phases")])
    else:
        build.build_all()
    results["build_s"] = time.perf_counter() - t
    log(f"build {results['build_s']:.1f} s")
    flash_build_report(torch, results)
    fp_build_report(results)
    bp_build_report(results)
    par_build_report(results)
    fan_build_report(results)
    fan_division_check(torch, results)
    if phases is not None:
        for name in phases:
            {"serve": serve_phase, "autotune": autotune_phase,
             "sharded": sharded_phase, "lm_train": lm_train_paths,
             "flash": flash_phase, "lm_families": lm_families,
             "lm_tp": lm_tp}[name](torch, results)
        tune.clear()
        outdir = ROOT / "chiprun_out"
        outdir.mkdir(exist_ok=True)
        (outdir / "chip_smoke_phases.json").write_text(
            json.dumps(results, indent=1, default=str))
        return 0
    if only is None:
        fp_division_check(torch, results)

    if only is None:
        train_breakdowns(torch, results)
    host_run = start_iterative_host() if only is None else None
    launches = projector_phases(torch, results, only, host_run)
    if only is not None:
        for row in results["kernels"]:
            log(json.dumps({k: row[k] for k in ("kernel", "cell", "dtype", "ms",
                                                "rel_err", "library_ms")}))
        outdir = ROOT / "chiprun_out"
        outdir.mkdir(exist_ok=True)
        (outdir / "chip_smoke_cells.json").write_text(json.dumps(results, indent=1))
        return 0
    train_paths(torch, results)
    flash_phase(torch, results)
    launches.update(lm_paths(torch, results))
    launches.update(lm_train_paths(torch, results))
    lm_families(torch, results)
    t = time.perf_counter()
    line_launches = nemotron_attn_layer(torch, results)
    results["phase_s"]["nemotron_attn_layer"] = time.perf_counter() - t
    sharded_phase(torch, results)
    lm_tp(torch, results)
    # last: a configuration measured here must reach no earlier phase
    serve_phase(torch, results)
    autotune_phase(torch, results)
    tune.clear()

    # each kernel at its own path's cell and dtype: the projectors' main
    # cells in f32, the attention kernels at Qwen3's shapes in its bf16
    own = {}
    for fam, F in families().items():
        if fam == "cone_packed":           # rows 3-4 on another geometry
            continue
        for i, kname in enumerate(F["names"]):
            cell = {"par": "main", "fan": "fan", "cone": "cone",
                    "modular": "helical"}[kname.split("_")[1]]
            own[kname] = (cell, "float32", F["source"], F["replaces"][i])
    for kname, replaces in FLASH_REPLACES.items():
        for suffix, cell in FLASH_LINE_CELLS.items():
            own[kname + suffix] = (cell, "bfloat16", FLASH_SOURCE, replaces)
    launches_by = {"": launches, "_hd192": line_launches}
    line = []
    for row in results["kernels"]:
        suffix = next((k for k, c in FLASH_LINE_CELLS.items() if c == row["cell"]), "")
        name = row["kernel"] + suffix
        if name not in own or own[name][:2] != (row["cell"], row["dtype"]):
            continue
        source, replaces = own[name][2:]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches_by[suffix].get(row["kernel"], 0),
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    check(sorted(e["name"] for e in line) == sorted(own),
          f"kernels line: {sorted(e['name'] for e in line)}, want {sorted(own)}")
    results["wall_s"] = time.perf_counter() - t_start
    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in results["phase_s"].items()))
    log(f"wall {results['wall_s']:.1f} s")
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "chip_smoke.json").write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
