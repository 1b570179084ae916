#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from the repository's sources,
   one nvcc per source, all started together;
3. kernels vs plain: hold each kernel against its plain PyTorch version on
   the card over a grid of shapes, dtypes, head dims (64, 96, 112, 128,
   192, 256) and masks (the flash forward, its odd-G route's two-tile
   CTA at G 1 and 3 among them, the flash backward's dQ and dK/dV kernels,
   in bf16 also against the plain version at their own rounding points,
   and its delta kernel, row by row, the streaming average,
   bitwise, the SSD intra-chunk forward and backward, whose bf16 wgmma
   route is also held to the plain versions at its rounding points and to
   its own bits from a second launch), and time each at the shape the
   main path gives it, beside its bound, its plain version and a library
   call where one computes the same function (the flash forward, whose
   bf16 route is the wgmma kernel, at both the prefill and the phase-1
   training shape, and at the prefill also with L2 flushed; the bf16 flash
   backward's dQ, dK/dV and delta kernels, the whole call and delta's
   plain chain at the phase-1 and phase-2 training shapes, beside the
   library's backward alone (and, for delta, a batched product); the
   same at granite-moe's phase 1 (D 64, G 3) and whisper-base's encoder
   at its train batch (non-causal over 1500 frames), where dq, dk and dv
   of its first 8 batches must also equal, bitwise, a launch on those
   batches alone; the same at
   gemma3-1b's shapes, head dim 256: its prefill in a global and in a local
   layer (window 512), its phase-1 forward and backward, and its phase-2
   backward: there ``kernel.flash_bwd`` runs delta and the dQ/dK/dV kernel
   (one launch for dq, dk and dv where one key tile and one query tile
   hold the sequence), held on its own grid cases (G 1, 2, 4, 8, masks,
   ragged rows, rows that see no key) with the dQ and dK/dV kernels beside
   it, run twice on gemma3's inputs bitwise, and timed beside them; the
   forward at deepseek-v2-lite's MLA prefill and phase-1 shape, head dim
   192, and
   granite-moe's, G 3; the backward at deepseek-v2-lite's phase-1 and
   phase-2 shapes, head dim 192, G 1: there too ``kernel.flash_bwd`` runs
   the dQ/dK/dV kernel (at D 192, G 1, persistent CTAs), held on its own
   grid cases with the pair beside it, run twice bitwise and on a batch
   slice bitwise at both shapes, and timed beside the pair; the forward
   and backward at
   zamba2-7b's shared block, head dim 112, G 1: its prefill and its two
   training phases; the same at minicpm3-4b's MLA, head dim 96, G 1; the
   forward at whisper-base's non-causal encoder (S 1500), at its serving
   and its train batch (there out and lse of the first 8 batches also
   bitwise against a launch on those batches alone), and cross attention
   (64 queries on 1500 frames), head dim 64, and its decoder's causal self
   attention at the train batch; the forward at qwen2-vl-72b's prefill
   (H 64, KVH 8, D 128: G 8);
   the bf16 SSD kernels at the serve prefill and phase 1 of mamba2-2.7b
   and of zamba2-7b, beside the f32 FMA kernels they replace);
4. full-width serve (internlm2-1.8b, random weights from a seed): a main
   path, with every kernel's launch count set to 0 just before it and read
   just after; then prefill logits with the kernel against the plain
   attention on the card (in f32) and against the f32 model (in bf16); a
   profiler window of a prefill and a decode step; then the compiled
   engine (``serve/compiled.py``) on the same model: 16 requests through
   8 slots, max_seq 1024, K 8, 64 tokens each, its K-step block replayed
   as one CUDA graph on the dense and the paged layout and run eagerly,
   bucket-length prompts token-exact against the ServingEngine, the
   graph's tokens against the eager ones, one flash forward a layer an
   admission on the bf16 route, the int8 pool's bytes a token against
   the dense bf16 cache's, a profiler window of one replay beside one
   ServingEngine step; the memory peak under 75 GB;
4b. live weight publishing on that engine (``phase_publish``), at full
   width, bf16 on f32 weights, 8 slots, max_seq 1024, K 8, the paged
   pool, ``warmup(dual=True)``: a main path counted as above, where a
   ``WeightPublisher`` folds two generations (the seed weights perturbed)
   into its ``StreamingAverage`` (the second fold on the swa_avg kernel)
   and publishes them mid-flight, the first at once, the second deferred
   until the generation-0 requests drain; every request equal to a
   single-generation graph engine's on its pinned weights, dual blocks
   run, one block read a decode call, no capture after the warm-up, the
   caller's weights unchanged, the peak under 75 GB; profiler windows of a
   dual and a single replay, the publish's own ms; then
   ``experiments/train_and_serve.py`` at smoke width, its audit a hard
   check;
5. full-width SWAP training (``repro_torch.launch.train`` with --full
   --workers 2 and the elastic phase 3): the training main path, counted
   the same way; every kernel of the path must launch in it, losses and
   accuracies must be finite, and the elastic average must agree with the
   plain mean of the same phase-2 models;
5b. supervised SWAP (``[supervise]``) at the same full width, built by the
   launcher's code with ``--supervise 2 --heartbeat-dir DIR
   --lost-workers 0`` and a NaN poisoning phase 2's first chunk
   (``FaultPlan``): one divergence rolled back and one dead worker dropped,
   both from the supervisor's host copy of phase 2's initial state; the
   survivor's phase-2 params and the phase-1 params bitwise those of
   phase 5, the flash launches of the three phase-2 attempts as the layer
   plan has them, the host copy's bytes and seconds, each restore's
   seconds, the peaks under 75 GB;
5c. SWAP across processes (``[dist]``): the launcher with phase 5's argv
   (phase 1 cut to 2 steps: gloo's all_reduce is slow on one card) and
   ``--mesh worker:2`` as two processes on the one card (this one rank
   0, a child rank 1, both allocators on expandable segments), gloo over
   loopback, internlm2-1.8b at full width and DIST_LAYERS: phase 1 data parallel over both, one worker a process
   in phase 2 with no collective, phase 3 gathered by broadcasts in worker
   order; both ranks' phase-1 params equal and within DIST_PHASE1_RTOL of
   the single-process launcher's phase 1; each worker and the elastic
   average bitwise the single-process port's from the same phase-1
   params; the recorder's collectives where the layout puts them; each
   rank's launches as the layer plan has them, on the bf16 route; each
   rank's peak and their sum under 75 GB; the gloo transfer rates;
6. smoke-width exactness in f32: continuous batching against
   single-request generation, token for token; the compiled engine's CPU
   test scenarios through its CUDA graph (``phase_compiled_exact``: equal
   to the ServingEngine and generate, paged = dense, the int8 trio, a
   3-page pool, an EOS inside a block with a slot reused, categorical
   sampling, MLA, MoE and M-RoPE decodes, each graph run equal to its
   eager run; a publish mid-decode through the dual graph for internlm2,
   mamba2, gemma3 and zamba2, each request equal to generate on its
   generation); whole-model gradients with
   the kernels against plain autograd; a whole SWAP run with the kernels
   against the same run on the plain versions;
7. phases 4-6 for gemma3-1b (the flash kernels at head dim 256; 22 local
   layers at window 512 and 4 global): serving at full width at batch 8,
   prompt 2048, one forward launch a layer a prefill; SWAP training at full
   width with the phase-1 batch cut to 128 (GEMMA_PHASE1_BATCH: 256 runs
   out of memory), the flash launches a step as the layer plan has them
   (a backward: delta and the dQ/dK/dV kernel, no dQ or dK/dV), all on the
   bf16 route,
   every phase's memory peak under 75 GB; the exactness checks on the gemma3
   smoke config at head dim 256, prompts and sequences past its window;
8. the MoE family and MLA, served: deepseek-v2-lite (MLA, the flash
   forward at head dim 192; 64 experts top-6; 15.7 B parameters) and
   granite-moe-3b-a800m (GQA at head dim 64; 40 experts top-8) at full
   width through phase 4's serving path, 27 and 32 forward launches a
   prefill, each with a profiler window of a prefill and a decode step
   and its memory peak under 75 GB; continuous batching token-exact on
   narrowed f32 configs at head dims the kernels take (``_narrow_moe``);
9. the MoE family and MLA, SWAP-trained at full width through the launcher
   as in phase 5: deepseek-v2-lite with its depth cut to 3 of 27 layers
   (DEEPSEEK_TRAIN_LAYERS; 4 run out of memory), the flash backward at head
   dim 192 (delta and the dQ/dK/dV kernel, no dQ or dK/dV), and
   granite-moe-3b-a800m cut to 12 of 32 layers
   (GRANITE_TRAIN_LAYERS; 23 fit, 24 peak over 75 GB), every flash launch
   on the
   bf16 wgmma route and as the layer plan has them; a profiler window of a
   phase-1 and a phase-2 step of each; one phase-1 step taken twice, its
   loss bitwise and its grads within MOE_REPEAT_TOL (not bitwise: the
   dispatch gather's backward adds in bf16 with atomics); and the f32
   exactness of phase 6 on the ``_narrow_moe`` configs, the plain run's
   expert choices replayed in the kernel run (``_fixed_routes``);
10. phases 4-6 again for mamba2-2.7b (the ssm family, on the SSD kernels):
   serving at full width (64 layers; also through the compiled engine,
   bucket-length prompts token-exact against the ServingEngine, one SSD
   forward a layer an admission on the bf16 route), SWAP training at full
   width with the
   depth cut to 16 layers (MAMBA_TRAIN_LAYERS: 64 layers do not fit the
   card, 62 ran out of memory in phase 2, 56 ran; 16 for the run's time
   limit), every SSD launch of both on the
   bf16 wgmma route, and the smoke exactness checks;
11. the hybrid family, zamba2-7b (81 mamba layers on the SSD kernels, the
   one shared attention block before each pattern unit of 6 on the flash
   kernels at head dim 112): served at full width on phase 4's path, 13
   flash and 81 SSD forwards a prefill, all on the bf16 wgmma route, the
   logits checks with both kernels switched (``[zamba2-serve]``);
   SWAP-trained through the launcher at full width with its depth cut to
   ZAMBA_TRAIN_LAYERS, every flash and SSD launch on the bf16 route and as
   the layer plan has them, every phase under 75 GB, a profiler window of
   a phase-1 and a phase-2 step (``[zamba2-train]``); and phase 6's f32
   exactness on a narrowed config at head dim 112 with a tail
   (``_narrow_zamba``);
12. minicpm3-4b (MLA at qk 64 + 32: the flash kernels at head dim 96, on
   D 128's tiles): served at full width and depth (62 layers) on phase 4's
   path, 62 forwards a prefill, all on the bf16 wgmma route
   (``[minicpm3-serve]``); SWAP-trained through the launcher at full width
   with its depth cut to MINICPM_TRAIN_LAYERS, every flash launch on the
   bf16 route and as the layer plan has them, every phase under 75 GB, a
   profiler window of a phase-1 and a phase-2 step (``[minicpm3-train]``);
   and phase 6's f32 exactness on ``_narrow_mla96`` (head dim 96);
13. whisper-base (the audio family: a non-causal encoder over 1500 stub
   frames, a decoder with causal self and non-causal cross attention, head
   dim 64): served at full width through ``launch.serve.generate`` with
   frames (8, 1500, 512) from the seed, batch 8, decoder prompt 64, both
   engines, 18 forwards a prefill on the bf16 route, the logits checks and
   a profiler window (``[whisper-serve]``); WHISPER_TRAIN_STEPS SGD steps
   of the LM train step at full width, batch WHISPER_TRAIN_BATCH, the
   flash forward, dQ and dK/dV launches as the layer plan has them, the
   peak under 75 GB (``[whisper-train]``); f32 on ``_narrow_whisper``,
   generation token-exact and the grads against the plain attention;
13b. qwen2-vl-72b (the vlm family: M-RoPE over (temporal, height, width)
   sections 16/24/24, stub patch embeddings in place of the first 256
   prompt tokens; 64 heads of 128 on 8 KV heads, G 8): served at full
   width with its depth cut to QWEN_VL_SERVE_LAYERS of 80 (72.7 B f32
   parameters fit no card) on phase 4's path with patch embeddings from the
   seed for ``generate`` and every logits route, the routes also at image
   grid positions whose three components differ, the engine's requests
   text, one forward a layer a prefill on the bf16 route
   (``[vlm-serve]``); M-RoPE on the card against an f64 host formula at
   such positions; QWEN_VL_TRAIN_STEPS SGD steps of the LM train step at
   full width with its depth cut to QWEN_VL_TRAIN_LAYERS, batches of 8 x
   512 tokens with patch embeddings from the seed, the flash forward, dQ
   and dK/dV launches at G 8 as the layer plan has them, the peak under
   75 GB (``[vlm-train]``; SWAP's state for 72.7 B parameters fits no
   card); and phase 6's f32 exactness on ``_narrow_vlm128`` (head dim 128,
   G 8), its grads on a batch with patch embeddings;
14. the paper-faithful CNN+BatchNorm path at the full width of cifar-cnn
   ``config()``: Table 1 (``repro_torch.experiments.table1_cifar10``,
   seed 0: small batch, large batch, SWAP before and after averaging) and
   Table 4's large-batch SWA row from Table 1's large-batch model, one main
   path counted as above (the SWA row folds its 8 samples on the swa_avg
   kernel: 25 leaves x 7 folds, bitwise equal to the plain refold); the
   phase-1/phase-2 step times, a profiler window of each, the
   augmentation's time, memory peaks; the prng device path on the card
   against the host path (bits bitwise, normal 4 ulp); with TF32 allowed
   around the card's calls, the full-width forward against the CPU in f32
   and the whole-model grads against the CPU in f32 and f64 on the card's
   branch (its ReLU masks and max choices replayed), each convolution's
   backward on its own inputs against f64; and a smoke-width SWAP with the
   elastic phase 3, bitwise equal to its plain refold;
15. the rest of the paper's experiments, one seed each, the CNN ones at the
   full width of cifar-cnn ``config()``: Table 2 (20 classes), Figure 1
   (the phase-2 curves), Figures 2/3 (the 9 x 9 plane with BN recomputed
   per point, the ASCII map, the three points), Figure 4 (the cosines),
   the worker ablation (W 1, 2, 4, 8), and Table 3 on its reference task
   (the internlm2 smoke config in f32, whose three flash kernels must
   launch); each a main path counted as above, every accuracy and cosine
   finite; the ablation (``phase_ablation``) and the rest
   (``phase_experiments``) each in a process of its own
   (``python3 chip_smoke.py --phase-child NAME OUT``), side by side and
   beside phase 17, their lines printed when they end;
16. the CNN step's bits may not depend on what the process did before:
   one full-width cifar-cnn forward and grads step in a fresh process and
   in one that first fills the card, in blocks that leave the allocator
   fragmented, to a small margin (``phase_cnn_processes``: the sha256 of
   loss, grads and new BN state bitwise; each convolution's scratch and
   kernels printed);
17. checkpoints and resume, the resuming run a new process
   (``python3 chip_smoke.py --resume-child ...``) on a copy of the
   snapshot directory with the snapshots after the cut deleted: Table 1's
   SWAP at the full width of cifar-cnn, and internlm2 smoke through the
   launcher (``--checkpoint-dir``, ``--checkpoint-every``,
   ``--elastic-deadline``), each cut once mid-phase-1 and once
   mid-phase-2, the four resuming processes side by side (the CNN's
   beside the launcher's uninterrupted run); the final params, BN state,
   stacked params, phase-1 log, step counts and accuracies bitwise the
   uninterrupted run's; each CNN
   snapshot's size and its load and save ms; the flash kernels and
   swa_avg launched in the resumed launcher runs.

The line before the last is one JSON object with each kernel's numbers
(the ``flash_attention_bwd_delta`` row: delta's kernel, which replaces no
Pallas kernel but the plain jnp delta of the reference's backward; the
``flash_attention_bwd_dqkv`` row: the dQ/dK/dV kernel at gemma3's phase 1,
its ``launches`` on gemma3's training path, ``pair_ms`` the dQ and dK/dV
kernels' times on the same inputs, ``phase2_shape`` at phase 2,
``deepseek_train_shape`` / ``deepseek_phase2_shape`` at head dim 192; the
backward rows' ``granite_train_shape`` and ``whisper_encoder_train_shape``:
their times at D 64, G 3 and G 1, non-causal, the latter without the
plain backward (``plain_ms`` null);
the swa_avg row's ``cnn_launches``: its launches on the CNN path; the
flash forward's and swa_avg's ``publish_launches``: on the live-publishing
path (``phase_publish``); the
flash rows' ``table3_launches``: on Table 3; ``resume_launches``: in the
two resumed launcher runs; ``gemma3_launches``: on gemma3's training path,
and the forward's on its serving path; ``gemma3_*`` shapes: the times at
head dim 256; the forward's ``deepseek_launches`` and ``granite_launches``:
on their serving paths, and ``deepseek_prefill`` / ``granite_prefill``: its
times at their prefill shapes, head dim 192 and 64; the backward rows'
``deepseek_train_shape`` / ``deepseek_phase2_shape``: their times at head
dim 192; ``deepseek_train_launches`` / ``granite_train_launches`` on the
flash and swa_avg rows: on those training paths (deepseek's backward on
delta and the dQ/dK/dV kernel); ``zamba2_launches`` on
every row: on zamba2-7b's training path and, for the two forwards, its
serving path; the flash rows' ``zamba2_*`` shapes: the times at head dim
112, the SSD rows' at zamba2's widths; ``minicpm3_launches`` on the flash
and swa_avg rows: on minicpm3-4b's training path and, for the forward,
its serving path, and the flash rows' ``minicpm3_*`` shapes: the times at
head dim 96; ``whisper_launches`` on the flash rows: on whisper-base's
train steps and, for the forward, its serving path, and the forward's
``whisper_encoder`` / ``whisper_cross`` / ``whisper_decoder_train_shape``
/ ``whisper_encoder_train_shape``: its times there; ``qwen2vl_launches``
on the flash rows: on qwen2-vl-72b's full-width train steps and, for the
forward, its full-width serving path, the forward's ``qwen2vl_prefill``
and the dQ, dK/dV and delta rows' ``qwen2vl_train_shape``: their times
there; the flash forward's ``bucket_prefill`` and the SSD forward's
``bucket_shape``: their times at the compiled engine's batch-1 bucket
of 512, and ``compiled_launches``: their launches on the compiled
engine's full-width paths, internlm2's and mamba2's); the line before
them gives the run's seconds; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s of
# the tensor cores by input type (f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}       # out, as the JAX tests
LSE_TOL = 1e-4
# dq/dk/dv against the plain backward's f32 math: f32 at the JAX kernel
# tests' 2e-4. In bf16 both read the same bf16 inputs and sum in f32; they
# differ by summation order, by where dq/dk/dv round to bf16, and by the
# bf16 kernels' hi + lo pairs for P and dS, so the bound is 1e-2 (relative
# to 1 + |value|, about 2 bf16 ulp). The f32 math forms S as the forward
# that wrote lse formed it (scores_as_forward: q * scale in bf16 for bf16
# inputs, as the bf16 forward kernel takes it): with S from q * scale in
# f32, P = exp(S - lse) is not that forward's softmax (its rows miss 1 by
# up to ~3e-3 at D 128) and the gradient is another function's
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# delta's kernel against its plain version (kernel.bwd_delta), row by row,
# relative to rowsum(|dO * O|): the same f32 products (exact for bf16
# inputs) summed in another order, ~1e-7 of that sum at D 256; a wrong
# chunk or lane moves a row by O(1)
DELTA_TOL = 1e-6

# bf16 kernels against the plain backward at their own rounding points
# (ref.flash_attention_bwd_ref(..., rounded=True)), fed the same lse: the
# two round the same f32 sums, which differ only by summation order and
# ex2.approx against expf (~1e-6 relative; a hi + lo pair keeps P and dS to
# 2^-16 wherever hi lands), so an output may land one bf16 ulp away, plus
# 2^-12 of the tensor's largest value for the f32 sums; and those flips are
# rare, so the relative L2 error stays under 1e-3. A wrong descriptor,
# fragment index or mask moves values by O(1).
BWD_ROUNDED_ABS, BWD_ROUNDED_L2 = 2.0 ** -12, 1e-3
# whole-model grads in f32, held leaf by leaf: max |err| / max |ref| at the
# JAX attention-grad tests' 5e-4, and the relative L2 at 1e-5 (leaves of a
# smoke LM are ~1e-2, and the kernel's grads differ from plain autograd by
# summation order only, ~1e-6)
GRAD_TOL, GRAD_L2_TOL = 5e-4, 1e-5
PREFILL_SHAPE = (8, 512, 512, 16, 8, 128)        # B, Sq, Skv, H, KVH, D
ENGINE_PROMPTS = (37, 200, 513, 128)             # ServingEngine requests
# the compiled engine (serve/compiled.py) at full width: internlm2-1.8b,
# 16 requests through 8 slots, max_seq 1024, K 8, 64 new tokens each;
# prompts at bucket lengths (token-exact against the ServingEngine) and
# between them (padded to the next bucket; their agreement is reported)
COMPILED_SLOTS, COMPILED_MAX_SEQ, COMPILED_BLOCK = 8, 1024, 8
COMPILED_NEW = 64
COMPILED_PROMPTS = (64, 128, 256, 512) * 3 + (37, 200, 300, 700)
# its prefills at batch 1 and bucket lengths: the doubling buckets of
# max_seq 1024 and 96, a bucket not a multiple of 64; the S-512 one timed
BUCKET_PROMPTS = (16, 64, 96, 512, 1024)
BUCKET_PREFILL_SHAPE = (1, 512, 512, 16, 8, 128)
# live weight publishing on that engine (``phase_publish``): 8 generation-0
# requests, half of them long, then a queue of 16 that the later
# generations take; every prompt at a bucket length
PUBLISH_FIRST = tuple(zip((64, 128, 256, 512) * 2, (16,) * 4 + (64,) * 4))
PUBLISH_QUEUE = tuple(zip((64, 128, 256, 512) * 4, (32,) * 16))
# the generations: the seed weights times 1 + PUBLISH_EPS * N(0, 1)
PUBLISH_EPS = 0.2
# SWAP phase 1 of internlm2-1.8b at the launcher's batch and length
TRAIN_SHAPE = (256, 64, 64, 16, 8, 128)          # B, Sq, Skv, H, KVH, D
TRAIN_ARGV = ["--full", "--workers", "2", "--phase1-steps", "4",
              "--phase2-steps", "4", "--elastic-deadline", "30",
              "--device", "cuda"]
# supervised SWAP: that run under a supervisor with 2 retries, worker 0
# never beating (the heartbeat directory is added at run time), and a NaN
# poisoning the phase-2 chunk that holds step 1 (SUPERVISE_NAN_STEP)
SUPERVISE_ARGV = TRAIN_ARGV + ["--supervise", "2", "--lost-workers", "0"]
SUPERVISE_NAN_STEP = 1
# SWAP across two processes on the one card: TRAIN_ARGV with phase 1 cut
# to 2 steps (a gloo all_reduce of a rank's f32 grads runs at 0.5-0.9
# GB/s here: 6.55 GB a step at 20 layers took 7.5-12 s), on the layout
# worker:2 (one worker a process), gloo (NCCL refuses two ranks on one
# card); each rank adds --coordinator and --process-id at run time
DIST_TRAIN_ARGV = TRAIN_ARGV + ["--phase1-steps", "2"]
DIST_ARGV = DIST_TRAIN_ARGV + ["--mesh", "worker:2", "--num-processes", "2",
                               "--dist-backend", "gloo"]
# internlm2-1.8b's depth in [dist]: two processes share the card, and at
# all 24 layers each peaks at 39.39 GB in phase 3 (three f32 copies of the
# params: phase 1's, its worker's and the average; and the eval's logits),
# 78.79 GB together, over PEAK_LIMIT_GB; at 20 layers 35.37 GB a rank
DIST_LAYERS = 20
# phase 1 over two ranks against one process's (relative L2 of the
# params): the mean of two half-batch gradients, summed in another order,
# measured at 2.1e-05; both ranks reading shard 0 (the mean over half the
# batch, the ranks still equal) measured at 3.3e-03
DIST_PHASE1_RTOL = 2e-4
MAMBA = "mamba2-2.7b"
# PERF.md's line for a training phase's device memory peak: above it a
# configuration is cut further
PEAK_LIMIT_GB = 75.0
# gemma3-1b: head dim 256, local layers at a window of 512; its serving
# prefill (batch 8, prompt 2048, where the window binds) and its SWAP
# phase 1 at the launcher's sequence of 64 and the batch its run takes
GEMMA = "gemma3-1b"
GEMMA_WINDOW = 512
GEMMA_PREFILL_SHAPE = (8, 2048, 2048, 4, 1, 256)
GEMMA_PROMPT = 2048
GEMMA_PHASE1_BATCH = 128
GEMMA_TRAIN_SHAPE = (GEMMA_PHASE1_BATCH, 64, 64, 4, 1, 256)
GEMMA_PHASE2_SHAPE = (32,) + GEMMA_TRAIN_SHAPE[1:]   # phase 2's batch of 32
GEMMA_TRAIN_ARGV = ["--arch", GEMMA, "--phase1-batch",
                    str(GEMMA_PHASE1_BATCH)] + TRAIN_ARGV
# the MoE family served at full width: deepseek-v2-lite (MLA, 27 layers of
# 64 experts top-6; its flash forward at qk's head dim 192, H = KVH 16)
# and granite-moe-3b-a800m (GQA 24/8 at head dim 64, 40 experts top-8),
# each at batch 8, prompt 512
DEEPSEEK = "deepseek-v2-lite"
DEEPSEEK_PREFILL_SHAPE = (8, 512, 512, 16, 16, 192)
GRANITE = "granite-moe-3b-a800m"
GRANITE_PREFILL_SHAPE = (8, 512, 512, 24, 8, 64)
# their SWAP phase 1 at the launcher's batch and length (phase 2: batch 32)
DEEPSEEK_TRAIN_SHAPE = (256, 64, 64, 16, 16, 192)
DEEPSEEK_PHASE2_SHAPE = (32,) + DEEPSEEK_TRAIN_SHAPE[1:]
GRANITE_TRAIN_SHAPE = (256, 64, 64, 24, 8, 64)
# The depths they are SWAP-trained at (launcher, W 2, elastic phase 3),
# each the largest whose every phase peaks under PEAK_LIMIT_GB (NVIDIA H100
# 80GB HBM3, 700.00 W).
# deepseek-v2-lite: 0.42 B parameters + 0.565 B a layer; at 3 layers the
# peaks were 39.13 / 60.90 / 69.36 GB, and at 4 phase 2's eval ran out of
# memory (a 6.25 GiB allocation for the f32 logits, with 63.10 GiB
# allocated and 10.16 GiB reserved but free in pieces). granite-moe:
# 0.15 B + 0.1007 B a layer; phase 3 peaked at 65.54 GB at 20 layers,
# 74.00 GB at 23 and 76.82 GB at 24 (2.82 GB a layer), so 32 layers would
# need ~99 GB. granite-moe is trained at 12 of the 23 that fit, for the
# run's time limit.
DEEPSEEK_TRAIN_LAYERS = 3
GRANITE_TRAIN_LAYERS = 12
# One MoE phase-1 step at full width taken twice from the same params and
# tokens: its forward has no atomics, so the loss repeats bitwise; the
# dispatch gather's backward adds each token's K expert grads in bf16 with
# atomics, so the grads do not, and a leaf's max |diff| / max |grad| came
# to 1.274e-02 and 1.323e-02 (deepseek-v2-lite), 2.632e-02 and 2.734e-02
# (granite-moe) in two runs (NVIDIA H100 80GB HBM3, 700.00 W). A race or
# a read of unwritten memory in a backward kernel moves a leaf by O(1).
MOE_REPEAT_TOL = 0.1
# SSD kernels against their plain versions: max |err| / max |ref|, the JAX
# SSD tests' 1e-4. Both compute in f32 from the same (f32 or bf16) inputs,
# so bf16 inputs are held to the same bound.
SSD_TOL = 1e-4
# the bf16 route (wgmma) against the plain versions at its own rounding
# points (ops._intra_chunk(..., rounded=True)), per output, max |err| / max
# |ref|: the two take the same hi + lo splits and differ by f32 summation
# order only, while a wrong descriptor, fragment index or mask moves
# outputs by O(1). On the CPU (ssd_rounding.py), f32 order moves the
# contract's outputs, f32 against f64 of the same contract, by up to
# 1.42e-5 in the forward (states) and 1.58e-5 in dx, dB, dC: those are held
# to 2e-5 and 4e-5. ddt and dA pass through the reverse cumsum of dcum over
# L, whose terms cancel (3.55e-5 and 2.73e-5 on the CPU; on an H100 ddt
# came 6.47e-5 from the rounded version and 6.40e-5 from the f32 math at
# L 256), so they keep SSD_TOL.
SSD_ROUNDED_TOL = {"y": 2e-5, "states": 2e-5, "cum": 2e-5, "dx": 4e-5,
                   "dB": 4e-5, "dC": 4e-5, "ddt": SSD_TOL, "dA": SSD_TOL}
# (B, S, H, P, G, N, chunk): mamba2-2.7b's serving prefill (batch 8, prompt
# 512) and its SWAP phase 1 (batch 256, the launcher's sequence of 64)
SSD_SERVE_SHAPE = (8, 512, 80, 64, 1, 128, 256)
SSD_TRAIN_SHAPE = (256, 64, 80, 64, 1, 128, 64)
# mamba2-2.7b's prefill in the compiled engine: batch 1, bucket 512
SSD_BUCKET_SHAPE = (1, 512, 80, 64, 1, 128, 256)
# 64 layers of mamba2-2.7b are 2.83 B parameters. On an H100 the training
# run's phase-3 peak was 53.10 GB at 40 layers and 68.54 GB at 56, 0.965 GB
# a layer, so 64 layers would need ~76.3 GB, over the 75 GB line of
# PERF.md. 62 layers (~74.3 GB by that slope) ran out of device memory all
# the same: a 6.25 GiB allocation of phase 2's update failed with 61.56 GiB
# allocated and 15.08 GiB reserved but free in pieces. 56 is the deepest
# that ran. The run's time limit cut it to 32 (the launcher's 12 steps took
# 27.9 s at 56 layers; ~39 GB by that slope), then to 16 (15.7 s at 32)
MAMBA_TRAIN_LAYERS = 16
# zamba2-7b, the hybrid family: 81 mamba layers (13 pattern units of 6 and
# a tail of 3), ONE shared attention block (32 heads of 112, G 1, with its
# MLP) before each unit; served at full depth, batch 8, prompt 512
ZAMBA = "zamba2-7b"
ZAMBA_PREFILL_SHAPE = (8, 512, 512, 32, 32, 112)
# its SWAP phase 1 at the launcher's batch and length (phase 2: batch 32)
ZAMBA_TRAIN_SHAPE = (256, 64, 64, 32, 32, 112)
# (B, S, H, P, G, N, chunk): its mamba blocks' SSD at the serving prefill
# and at phase 1
ZAMBA_SSD_SERVE_SHAPE = (8, 512, 112, 64, 1, 64, 256)
ZAMBA_SSD_TRAIN_SHAPE = (256, 64, 112, 64, 1, 64, 64)
# The depth it is SWAP-trained at (launcher, W 2, elastic phase 3): the
# deepest of 30, 27 and 24 layers whose every phase peaks under
# PEAK_LIMIT_GB. On an NVIDIA H100 80GB HBM3 at 700.00 W, at 30 layers
# phase 2's update ran out of memory (a 5.84 GiB allocation, with 62.08 GiB
# allocated and 14.18 GiB reserved but free); at 27 the phases peaked at
# 73.16 / 66.06 / 55.26 GB (phase 3 at 75.58 while it still held phase 2's
# optimizer state); at 24 at 70.34 / 60.45 / 69.03. 27 is 4 pattern units
# and the tail of 3, which the full config has too. For the run's time
# limit it is trained at 15: 2 pattern units and the tail of 3.
ZAMBA_TRAIN_LAYERS = 15
# minicpm3-4b: MLA at qk 64 + 32 (the flash head dim 96, v 64 padded to
# 96), 40 heads (G 1), 62 layers; served at full depth, batch 8, prompt 512
MINICPM = "minicpm3-4b"
MINICPM_PREFILL_SHAPE = (8, 512, 512, 40, 40, 96)
# its SWAP phase 1 at the launcher's batch and length (phase 2: batch 32)
MINICPM_TRAIN_SHAPE = (256, 64, 64, 40, 40, 96)
# The depth it is SWAP-trained at (launcher, W 2, elastic phase 3): the
# deepest whose every phase peaks under PEAK_LIMIT_GB. 62.67 M parameters a
# layer and 376 M of untied embeddings; phase 1 binds (the saved MLA
# activations of 256 x 64 tokens and the f32 logits), 1.50 GB a layer. On
# an NVIDIA H100 80GB HBM3 at 700.00 W the phases peaked at 60.34 / 54.89 /
# 41.39 GB at 28 layers, 66.34 / 61.43 / 45.40 at 32, 72.35 / 67.97 / 49.41
# at 36, 73.85 / 69.61 / 50.42 at 37 and 75.36 / 71.25 / 51.43 at 38 (over
# the line), one process a depth. 37 fits; 19 (about half) keeps the whole
# script inside its time limit beside the live-publishing phase.
MINICPM_TRAIN_LAYERS = 19
# whisper-base, the audio family: 6 encoder layers over 1500 stub frames
# (non-causal), 6 decoder layers (causal self attention, then non-causal
# cross attention over the encoder output), 8 heads of 64 (G 1); served at
# batch 8 with decoder prompts of 64 (its decoder context is 448)
WHISPER = "whisper-base"
WHISPER_PROMPT = 64
WHISPER_ENCODER_SHAPE = (8, 1500, 1500, 8, 8, 64)     # non-causal
WHISPER_CROSS_SHAPE = (8, WHISPER_PROMPT, 1500, 8, 8, 64)   # non-causal
WHISPER_DECODER_SHAPE = (8, WHISPER_PROMPT, WHISPER_PROMPT, 8, 8, 64)
# its train step at decoder S 64 with frames (B, 1500, 512): the largest of
# 256, 128 and 64 whose peak stays under PEAK_LIMIT_GB. On an NVIDIA H100
# 80GB HBM3 at 700.00 W, B 256 ran out of memory (a 750 MiB allocation with
# 76.84 GiB allocated: the encoder, not rematerialized, as in the
# reference, keeps every layer's activations over 1500 frames); B 128
# peaked at 51.21 GB and B 64 at 26.38.
WHISPER_TRAIN_BATCH = 128
WHISPER_TRAIN_STEPS = 3
# its encoder's attention at that batch (non-causal over 1500 frames)
WHISPER_ENCODER_TRAIN_SHAPE = (WHISPER_TRAIN_BATCH,) + WHISPER_ENCODER_SHAPE[1:]
# qwen2-vl-72b, the vlm family: 64 heads of 128 on 8 KV heads (G 8),
# M-RoPE, 256 stub vision tokens; served at batch 8, prompt 512 (the
# first 256 places the patch embeddings')
QWEN_VL = "qwen2-vl-72b"
QWEN_VL_PREFILL_SHAPE = (8, 512, 512, 64, 8, 128)
# its serving depth at full width: f32 params are 9.96 GB of embeddings and
# head and 3.51 GB a layer (72.70 B in all, 291 GB), so the depth is cut.
# On an NVIDIA H100 80GB HBM3 at 700.00 W, 16 layers peaked at 69.88 and
# 70.35 GB in two runs (init, the bf16 casts and the engine included); 17
# would come to ~73.9 GB, within 1.1 GB of PEAK_LIMIT_GB
QWEN_VL_SERVE_LAYERS = 16
# its train step at full width: SGD with momentum keeps f32 params, grads
# and momentum, 12 bytes a parameter, so the depth is cut to
# QWEN_VL_TRAIN_LAYERS (4.25 B parameters, ~51 GB before the activations
# and the bf16 casts; a third layer would add ~12 GB); batches of
# QWEN_VL_TRAIN_BATCH sequences of 512 tokens, the first 256 places stub
# patch embeddings from the seed
QWEN_VL_TRAIN_LAYERS = 2
QWEN_VL_TRAIN_BATCH = 8
QWEN_VL_TRAIN_STEPS = 3
QWEN_VL_TRAIN_SHAPE = (QWEN_VL_TRAIN_BATCH, 512, 512, 64, 8, 128)
# the CNN's f32 forward (against the CPU's), its whole-model grads on one
# branch and its convolutions' backward (against f32 and f64), max |err| /
# max |ref| per output: f32 sums in other orders (~1e-6 to ~3e-5); TF32
# convolutions would put them ~1e-3 apart
CNN_FWD_TOL, CNN_GRAD_TOL = 1e-5, 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def _require_card():
    """Fail without a card or without the repository; put ``src`` on the
    path and the card's f32 products in full f32."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    # f32 products in full f32 on the card (no TF32), for the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_device():
    import torch
    _require_card()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    print(card, flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    builds = {"flash_fwd": kernel.build, "flash_bwd": kernel.build_bwd,
              "swa_avg": swa_kernel.build,
              "ssd": ssd_kernel.build}     # ssd_fwd and ssd_bwd, together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = {name: pool.submit(fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in done.items()}
    done.update(zip(("ssd_fwd", "ssd_bwd"), done.pop("ssd")))
    print(f"[build] {len(done)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, built in done.items():
        print(f"[build] {name}: {built.path.name}, nvcc "
              f"{built.seconds:.2f} s")
        for line in built.log.splitlines():
            if ("registers" in line or "smem" in line or "spill" in line
                    or "Function properties" in line):
                print(f"[build]   {line.strip()}")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version, and its times
# ---------------------------------------------------------------------------


def _qkv(shape, dtype, seed):
    import torch
    B, Sq, Skv, H, KVH, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return mk(B, Sq, H, D), mk(B, Skv, KVH, D), mk(B, Skv, KVH, D)


def _visible_pairs(Sq, Skv, causal, window, q_offset):
    import torch
    qpos = torch.arange(Sq) + q_offset
    kpos = torch.arange(Skv)
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return int(mask.sum())


def _cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _grid():
    from repro_torch.kernels.flash_attention.kernel import FWD_HEAD_DIMS
    cases = []
    for dtype in ("float32", "bfloat16"):
        for D in FWD_HEAD_DIMS:
            for G in (1, 2, 4):
                for causal, window in ((True, 0), (True, 16), (False, 0)):
                    cases.append(((2, 67, 67, 4, 4 // G, D), dtype, causal,
                                  window, 0))
        # granite-moe's odd group (24 query heads on 8 KV heads), ragged
        for causal in (True, False):
            cases.append(((2, 67, 67, 6, 2, 64), dtype, causal, 0, 0))
        for D in FWD_HEAD_DIMS:
            cases += [
                ((2, 1, 64, 8, 4, D), dtype, True, 0, 63),       # decode row
                ((1, 33, 129, 4, 2, D), dtype, True, 0, 96),     # q_offset
                ((1, 33, 129, 4, 2, D), dtype, False, 0, 0),     # ragged Skv
                ((1, 40, 40, 4, 1, D), dtype, True, 16, 0),      # window
                ((1, 48, 48, 4, 2, D), dtype, True, 0, -8),      # empty rows
                ((1, 200, 200, 8, 2, D), dtype, True, 48, 0),    # tile skip
            ]
        # gemma3's window of 512 where it binds: ragged S, and a chunk of
        # queries after a cached prefix (Sq != Skv, q_offset)
        cases += [((1, 700, 700, 4, 1, 256), dtype, True, GEMMA_WINDOW, 0),
                  ((1, 100, 700, 4, 1, 256), dtype, True, GEMMA_WINDOW, 600)]
        # the bf16 route's odd-G CTA (two 64-row tiles of one head) at G 1
        # and 3: odd tile counts (a lone last tile), a window splitting
        # the two tiles' KV ranges at both ends, a chunk after a cached
        # prefix, Sq <= 64 (one warpgroup), rows that see no key
        for D in (64, 96, 112, 192):
            for H, KVH in ((2, 2), (6, 2)):
                for S in (65, 129, 191):
                    for causal in (True, False):
                        cases.append(((1, S, S, H, KVH, D), dtype, causal, 0,
                                      0))
                cases += [((1, 200, 200, H, KVH, D), dtype, True, 48, 0),
                          ((1, 200, 200, H, KVH, D), dtype, True, 100, 0),
                          ((1, 97, 129, H, KVH, D), dtype, True, 0, 96),
                          ((1, 33, 129, H, KVH, D), dtype, True, 0, 96),
                          ((2, 64, 64, H, KVH, D), dtype, True, 0, 0),
                          ((1, 130, 130, H, KVH, D), dtype, True, 0, -8)]
    # the shapes the main paths give the kernel: generate's batched
    # prefill, the engine's batch-1 prefills, and the training steps of
    # phase 1 (batch 256) and phase 2 (batch 32 per worker); gemma3's
    # prefill in a global and a local layer, and its two training phases
    cases.append((PREFILL_SHAPE, "bfloat16", True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S, 16, 8, 128), "bfloat16", True, 0, 0))
    cases.append((TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    for window in (0, GEMMA_WINDOW):
        cases.append((GEMMA_PREFILL_SHAPE, "bfloat16", True, window, 0))
    cases.append((GEMMA_TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + GEMMA_TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    # deepseek-v2-lite's (D 192, G 1) and granite-moe's (D 64, G 3) two
    # training phases
    for shape in (DEEPSEEK_TRAIN_SHAPE, GRANITE_TRAIN_SHAPE):
        cases.append((shape, "bfloat16", True, 0, 0))
        cases.append(((32,) + shape[1:], "bfloat16", True, 0, 0))
    # deepseek-v2-lite's MLA prefill at head dim 192 (v padded to qk's
    # 192) and granite-moe's at 64 (G 3), batched and through the engine,
    # in bf16 and (the f32 logits check) f32
    for shape in (DEEPSEEK_PREFILL_SHAPE, GRANITE_PREFILL_SHAPE):
        for dtype in ("bfloat16", "float32"):
            cases.append((shape, dtype, True, 0, 0))
        for S in ENGINE_PROMPTS:
            cases.append(((1, S, S) + shape[3:], "bfloat16", True, 0, 0))
    # zamba2-7b's shared block (D 112, G 1): its prefill, batched (bf16 and,
    # for the f32 logits check, f32) and through the engine, and its two
    # training phases
    for dtype in ("bfloat16", "float32"):
        cases.append((ZAMBA_PREFILL_SHAPE, dtype, True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S) + ZAMBA_PREFILL_SHAPE[3:], "bfloat16", True,
                      0, 0))
    cases.append((ZAMBA_TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + ZAMBA_TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    # minicpm3-4b's MLA (D 96, G 1): its prefill, batched (bf16 and, for the
    # f32 logits check, f32) and through the engine, and its two training
    # phases
    for dtype in ("bfloat16", "float32"):
        cases.append((MINICPM_PREFILL_SHAPE, dtype, True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S) + MINICPM_PREFILL_SHAPE[3:], "bfloat16",
                      True, 0, 0))
    cases.append((MINICPM_TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + MINICPM_TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    # whisper-base (D 64, G 1): the encoder and the cross attention, both
    # non-causal, and the decoder's causal prefill, in bf16 and f32
    for dtype in ("bfloat16", "float32"):
        for shape in (WHISPER_ENCODER_SHAPE, WHISPER_CROSS_SHAPE):
            cases.append((shape, dtype, False, 0, 0))
        cases.append((WHISPER_DECODER_SHAPE, dtype, True, 0, 0))
    # the bf16 routes of the pipelined loop and of the query tiles fastest
    # (appended, so every earlier case
    # keeps its seed): D 64's pipelined loop over many KV tiles,
    # non-causal, Skv 1500 and 700 (not multiples of 64 or 128), at G 1
    # and 2; D 256 at G 4, causal, Sq 200, with and without a window of 100
    for shape in ((1, 65, 1500, 2, 2, 64), (2, 130, 700, 2, 2, 64),
                  (2, 130, 700, 4, 2, 64)):
        cases.append((shape, "bfloat16", False, 0, 0))
    for window in (0, 100):
        cases.append(((1, 200, 200, 4, 1, 256), "bfloat16", True, window, 0))
    # qwen2-vl-72b (D 128, G 8; appended too): its prefill, batched (bf16
    # and, for the f32 logits check, f32) and through the engine
    for dtype in ("bfloat16", "float32"):
        cases.append((QWEN_VL_PREFILL_SHAPE, dtype, True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S) + QWEN_VL_PREFILL_SHAPE[3:], "bfloat16",
                      True, 0, 0))
    # the compiled engine's batch-1 prefills at bucket lengths (appended
    # too): the real rows first, the padding after them
    for S in BUCKET_PROMPTS:
        cases.append(((1, S, S) + PREFILL_SHAPE[3:], "bfloat16", True, 0, 0))
    return cases


def phase_kernel():
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    worst, worst_d = {}, {}
    # the main paths' (shape, window): their errors go to the JSON line
    path_err = dict.fromkeys(((PREFILL_SHAPE, 0), (TRAIN_SHAPE, 0),
                              (GEMMA_PREFILL_SHAPE, 0),
                              (GEMMA_PREFILL_SHAPE, GEMMA_WINDOW),
                              (GEMMA_TRAIN_SHAPE, 0),
                              (DEEPSEEK_PREFILL_SHAPE, 0),
                              (GRANITE_PREFILL_SHAPE, 0),
                              (DEEPSEEK_TRAIN_SHAPE, 0),
                              (GRANITE_TRAIN_SHAPE, 0),
                              (ZAMBA_PREFILL_SHAPE, 0),
                              (ZAMBA_TRAIN_SHAPE, 0),
                              ((32,) + ZAMBA_TRAIN_SHAPE[1:], 0),
                              (MINICPM_PREFILL_SHAPE, 0),
                              (MINICPM_TRAIN_SHAPE, 0),
                              (WHISPER_ENCODER_SHAPE, 0),
                              (WHISPER_CROSS_SHAPE, 0),
                              (QWEN_VL_PREFILL_SHAPE, 0),
                              (BUCKET_PREFILL_SHAPE, 0)))
    for i, (shape, dtype, causal, window, q_offset) in enumerate(_grid()):
        D = shape[-1]
        q, k, v = _qkv(shape, getattr(torch, dtype), seed=i)
        kw = dict(causal=causal, window=window, scale=None,
                  q_offset=q_offset)
        out, lse = kernel.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = ops._blockwise_fwd(q, k, v, chunk=512, **kw)
        check(out.dtype == q.dtype and out.shape == q.shape
              and lse.shape == q.shape[:3], f"case {i}: output shape/dtype")
        check(bool(torch.isfinite(out).all()), f"case {i}: non-finite out")
        err = (out.float() - ref_out.float()).abs()
        bound = TOL[dtype] * (1 + ref_out.float().abs())
        check(bool((err <= bound).all()),
              f"case {i} {shape} {dtype} causal={causal} window={window} "
              f"q_offset={q_offset}: out max err {err.max().item():.3e}")
        lerr = (lse - ref_lse).abs()
        check(bool((lerr <= LSE_TOL * (1 + ref_lse.abs())).all()),
              f"case {i} {shape} {dtype}: lse max err {lerr.max().item():.3e}")
        if q_offset < 0:   # rows that see no key: out = 0 and lse = 0
            dead = slice(0, -q_offset)
            check(bool((out[:, dead] == 0).all() and (lse[:, dead] == 0).all()),
                  f"case {i}: fully masked rows are not out=0, lse=0")
        worst[dtype] = max(worst.get(dtype, 0.0), err.max().item())
        worst_d[D] = max(worst_d.get(D, 0.0), err.max().item())
        if (shape, window) in path_err and dtype == "bfloat16":
            path_err[shape, window] = err.max().item()
    print(f"[kernel] {len(_grid())} cases match the plain version; max |out "
          f"err| f32 {worst['float32']:.3e} bf16 {worst['bfloat16']:.3e}; "
          f"by head dim " + ", ".join(f"D {d} {e:.3e}"
                                      for d, e in sorted(worst_d.items())))

    # times at the main paths' shapes: the internlm2-1.8b prefill and its
    # phase-1 training step (48 launches a step with remat); gemma3-1b's
    # prefill in a global and a local layer, and its phase-1 step
    prefill = _fwd_times(PREFILL_SHAPE, "prefill", seed=1234, cold=True)
    train = _fwd_times(TRAIN_SHAPE, "phase-1 training", seed=1235)
    g_prefill = _fwd_times(GEMMA_PREFILL_SHAPE, "gemma3 prefill, global",
                           seed=1236, cold=True)
    g_local = _fwd_times(GEMMA_PREFILL_SHAPE, "gemma3 prefill, local",
                         seed=1236, window=GEMMA_WINDOW)
    g_train = _fwd_times(GEMMA_TRAIN_SHAPE, "gemma3 phase-1 training",
                         seed=1237)
    # deepseek-v2-lite's MLA prefill at head dim 192 (one warpgroup a CTA
    # at G 1) and granite-moe's at 64 (G 3)
    d_prefill = _fwd_times(DEEPSEEK_PREFILL_SHAPE, "deepseek prefill, MLA",
                           seed=1238, cold=True)
    gr_prefill = _fwd_times(GRANITE_PREFILL_SHAPE, "granite prefill",
                            seed=1239)
    d_train = _fwd_times(DEEPSEEK_TRAIN_SHAPE, "deepseek phase-1 training",
                         seed=1240)
    gr_train = _fwd_times(GRANITE_TRAIN_SHAPE, "granite phase-1 training",
                          seed=1241)
    # zamba2-7b's shared block at head dim 112 (D 128's tiles, G 1): its
    # prefill and its two training phases
    z_phase2 = (32,) + ZAMBA_TRAIN_SHAPE[1:]
    z_prefill = _fwd_times(ZAMBA_PREFILL_SHAPE, "zamba2 prefill, shared block",
                           seed=1242, cold=True)
    z_train = _fwd_times(ZAMBA_TRAIN_SHAPE, "zamba2 phase-1 training",
                         seed=1243)
    z_train2 = _fwd_times(z_phase2, "zamba2 phase-2 training", seed=1244)
    # minicpm3-4b's MLA at head dim 96 (D 128's tiles, G 1): its prefill
    # and phase 1; whisper-base's encoder and cross attention (D 64, G 1,
    # non-causal, Skv 1500)
    m_prefill = _fwd_times(MINICPM_PREFILL_SHAPE, "minicpm3 prefill, MLA",
                           seed=1245, cold=True)
    m_train = _fwd_times(MINICPM_TRAIN_SHAPE, "minicpm3 phase-1 training",
                         seed=1246)
    w_enc = _fwd_times(WHISPER_ENCODER_SHAPE, "whisper encoder", seed=1247,
                       causal=False)
    w_cross = _fwd_times(WHISPER_CROSS_SHAPE, "whisper cross", seed=1248,
                         causal=False)
    # the encoder at the train batch: six of these a train step
    w_enc_train = _fwd_times(WHISPER_ENCODER_TRAIN_SHAPE,
                             "whisper encoder, train batch", seed=1250,
                             causal=False)
    # its exponentials against the special-function units: one a visible
    # (query, key) pair
    B, Sq, Skv, H = WHISPER_ENCODER_TRAIN_SHAPE[:4]
    q, k, v = _qkv(WHISPER_ENCODER_TRAIN_SHAPE, torch.bfloat16, seed=1250)
    w_enc_train.update(_mufu_bound(
        lambda: kernel.flash_fwd(q, k, v, causal=False), B * H * Sq * Skv,
        "whisper encoder, train batch, forward"))
    del q, k, v
    _fwd_batch_slice(WHISPER_ENCODER_TRAIN_SHAPE, "whisper encoder")
    # and its decoder's causal self attention at the train batch (D 64, G 1)
    w_dec_shape = (WHISPER_TRAIN_BATCH,) + WHISPER_DECODER_SHAPE[1:]
    w_dec = _fwd_times(w_dec_shape, "whisper decoder, train batch",
                       seed=1249)
    # qwen2-vl-72b's prefill: D 128 at G 8, the head-pair split
    q_prefill = _fwd_times(QWEN_VL_PREFILL_SHAPE, "qwen2-vl prefill",
                           seed=1251, cold=True)
    # the compiled engine's prefill: one prompt at batch 1, bucket 512
    b_prefill = _fwd_times(BUCKET_PREFILL_SHAPE,
                           "internlm2 bucket prefill, batch 1", seed=1252,
                           cold=True)
    sys.stdout.flush()
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": None, "max_abs_err": path_err[PREFILL_SHAPE, 0],
        **prefill,
        "train_shape": {"max_abs_err": path_err[TRAIN_SHAPE, 0], **train},
        "gemma3_prefill": {
            "max_abs_err": path_err[GEMMA_PREFILL_SHAPE, 0], **g_prefill},
        "gemma3_prefill_local": {
            "max_abs_err": path_err[GEMMA_PREFILL_SHAPE, GEMMA_WINDOW],
            **g_local},
        "gemma3_train_shape": {
            "max_abs_err": path_err[GEMMA_TRAIN_SHAPE, 0], **g_train},
        "deepseek_prefill": {
            "max_abs_err": path_err[DEEPSEEK_PREFILL_SHAPE, 0], **d_prefill},
        "granite_prefill": {
            "max_abs_err": path_err[GRANITE_PREFILL_SHAPE, 0], **gr_prefill},
        "deepseek_train_shape": {
            "max_abs_err": path_err[DEEPSEEK_TRAIN_SHAPE, 0], **d_train},
        "granite_train_shape": {
            "max_abs_err": path_err[GRANITE_TRAIN_SHAPE, 0], **gr_train},
        "zamba2_prefill": {
            "max_abs_err": path_err[ZAMBA_PREFILL_SHAPE, 0], **z_prefill},
        "zamba2_train_shape": {
            "max_abs_err": path_err[ZAMBA_TRAIN_SHAPE, 0], **z_train},
        "zamba2_phase2_shape": {
            "max_abs_err": path_err[z_phase2, 0], **z_train2},
        "minicpm3_prefill": {
            "max_abs_err": path_err[MINICPM_PREFILL_SHAPE, 0], **m_prefill},
        "minicpm3_train_shape": {
            "max_abs_err": path_err[MINICPM_TRAIN_SHAPE, 0], **m_train},
        "whisper_encoder": {
            "max_abs_err": path_err[WHISPER_ENCODER_SHAPE, 0], **w_enc},
        "whisper_cross": {
            "max_abs_err": path_err[WHISPER_CROSS_SHAPE, 0], **w_cross},
        "whisper_decoder_train_shape": w_dec,
        "whisper_encoder_train_shape": w_enc_train,
        "qwen2vl_prefill": {
            "max_abs_err": path_err[QWEN_VL_PREFILL_SHAPE, 0], **q_prefill},
        "bucket_prefill": {
            "max_abs_err": path_err[BUCKET_PREFILL_SHAPE, 0], **b_prefill},
    }


def _device_ms(fn, iters: int, flush: bool = False) -> float:
    """Mean device time of fn over iters launches. The launches are queued
    behind a ~50 ms sleep kernel, so that the host's cost of issuing fn
    (tens of microseconds of Python a call, more than a short kernel takes)
    does not show between the events. With flush, the 50 MB L2 is
    overwritten (a 256 MB write) before each launch and each launch is
    timed alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    event = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)        # GPU clock cycles
    if not flush:
        start, end = event(), event()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    events = [(event(), event()) for _ in range(iters)]
    for start, end in events:
        scrub.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _fwd_times(shape, label, seed, cold=False, window=0, causal=True):
    """The bf16 forward's device time at one shape, warm (and, with cold,
    with L2 flushed), beside its bound, its plain version and SDPA, timed
    the same way. With a window, SDPA takes it as a boolean mask, which
    its flash backend does not take: the yardstick is then another
    backend's."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    B, Sq, Skv, H, KVH, D = shape
    q, k, v = _qkv(shape, torch.bfloat16, seed=seed)
    run = lambda: kernel.flash_fwd(q, k, v, causal=causal, window=window)
    ms = _device_ms(run, 50)
    plain_ms = _cuda_ms(lambda: ops._blockwise_fwd(
        q, k, v, causal=causal, window=window, scale=None, q_offset=0,
        chunk=512), 5)
    # yardstick only, never called by the port: one fused library call on
    # the same function (K/V heads repeated beforehand, outside the timing)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    if window:
        pos = torch.arange(Sq, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    else:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
    lib_ms = _device_ms(sdpa, 50)
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + B * Sq * H * 4
    flops = 4 * D * B * H * _visible_pairs(Sq, Skv, causal, window, 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    mask_name = (f"window {window}" if window
                 else "causal" if causal else "non-causal")
    times = {"shape": f"B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 {mask_name}",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms}
    line = (f"[kernel] {label} shape {times['shape']}: kernel {ms:.4f} ms, "
            f"bound {max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} "
            f"MB, {flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms")
    if cold:
        times["ms_l2_flushed"] = _device_ms(run, 30, flush=True)
        times["library_ms_l2_flushed"] = _device_ms(sdpa, 30, flush=True)
        line += (f"; L2 flushed: kernel {times['ms_l2_flushed']:.4f} ms, "
                 f"library {times['library_ms_l2_flushed']:.4f} ms")
    print(line)
    return times


def _bwd_grid():
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    cases = []
    for dtype in ("float32", "bfloat16"):
        for D in BWD_HEAD_DIMS:
            for G in (1, 2, 4):
                for causal, window in ((True, 0), (True, 16), (False, 0)):
                    cases.append(((2, 67, 67, 4, 4 // G, D), dtype, causal,
                                  window, 0))
            cases += [
                ((1, 33, 129, 4, 2, D), dtype, True, 0, 96),     # q_offset
                ((1, 33, 129, 8, 2, D), dtype, False, 0, 0),     # ragged Skv
                ((1, 48, 48, 4, 2, D), dtype, True, 0, -8),      # empty rows
                ((1, 200, 200, 8, 2, D), dtype, True, 48, 0),    # tile skip
                ((2, 131, 131, 4, 1, D), dtype, True, 0, -5),    # odd, empty
            ]
        # gemma3's window of 512 where it binds, as in the forward's grid
        cases += [((1, 700, 700, 4, 1, 256), dtype, True, GEMMA_WINDOW, 0),
                  ((1, 100, 700, 4, 1, 256), dtype, True, GEMMA_WINDOW, 600)]
        # granite-moe's odd group (24 query heads on 8 KV heads), ragged
        for causal in (True, False):
            cases.append(((2, 67, 67, 6, 2, 64), dtype, causal, 0, 0))
    # the shapes the training paths give it: phase 1 and phase 2 of
    # internlm2, gemma3, deepseek-v2-lite (MLA, D 192, G 1), granite-moe and
    # zamba2-7b (D 112, G 1)
    for shape in (TRAIN_SHAPE, GEMMA_TRAIN_SHAPE, DEEPSEEK_TRAIN_SHAPE,
                  GRANITE_TRAIN_SHAPE, ZAMBA_TRAIN_SHAPE,
                  MINICPM_TRAIN_SHAPE):
        cases.append((shape, "bfloat16", True, 0, 0))
        cases.append(((32,) + shape[1:], "bfloat16", True, 0, 0))
    # whisper-base's train step: the encoder's and the cross attention's
    # non-causal backward over 1500 frames, and the decoder's causal one
    for shape, causal in ((WHISPER_ENCODER_SHAPE, False),
                          (WHISPER_CROSS_SHAPE, False),
                          (WHISPER_DECODER_SHAPE, True)):
        cases.append((shape, "bfloat16", causal, 0, 0))
    # qwen2-vl-72b's train step (D 128, G 8), and its heads at S 64
    cases += [(QWEN_VL_TRAIN_SHAPE, "bfloat16", True, 0, 0),
              ((2, 64, 64, 64, 8, 128), "bfloat16", True, 0, 0)]
    # the dQ/dK/dV kernel's route (D 256, Sq and Skv <= 64; kernel.
    # takes_dqkv): G 1, 2, 4 under each mask at S 64, G 8; ragged Sq with
    # a window, a chunk after a cached prefix, rows that see no key, Sq <
    # Skv
    for G in (1, 2, 4):
        for causal, window in ((True, 0), (True, 16), (False, 0)):
            cases.append(((2, 64, 64, 4, 4 // G, 256), "bfloat16", causal,
                          window, 0))
    cases += [((1, 64, 64, 8, 1, 256), "bfloat16", True, 0, 0),
              ((1, 37, 37, 4, 2, 256), "bfloat16", True, 16, 0),
              ((2, 37, 37, 8, 2, 256), "bfloat16", False, 0, 0),
              ((1, 33, 64, 4, 1, 256), "bfloat16", True, 0, 31),
              ((1, 48, 48, 4, 1, 256), "bfloat16", True, 0, -8),
              ((2, 33, 64, 4, 1, 256), "bfloat16", False, 0, 0)]
    # its route at D 192 (G 1, any scale; deepseek-v2-lite's MLA): each
    # mask at S 64; ragged Sq with a window, a chunk after a cached prefix,
    # rows that see no key, Sq < Skv, Sq > Skv; and 640 (batch, head) items,
    # several a persistent CTA, ragged and non-causal. G 2 at S 64 keeps the
    # pair
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        cases.append(((2, 64, 64, 4, 4, 192), "bfloat16", causal, window, 0))
    cases.append(((2, 64, 64, 4, 2, 192), "bfloat16", True, 0, 0))
    cases += [((1, 37, 37, 4, 4, 192), "bfloat16", True, 16, 0),
              ((1, 33, 64, 4, 4, 192), "bfloat16", True, 0, 31),
              ((1, 48, 48, 4, 4, 192), "bfloat16", True, 0, -8),
              ((2, 33, 64, 4, 4, 192), "bfloat16", False, 0, 0),
              ((1, 64, 33, 4, 4, 192), "bfloat16", False, 0, 0),
              ((40, 37, 37, 16, 16, 192), "bfloat16", False, 0, 0)]
    return cases


def _rel_err(got, want):
    return ((got.float() - want.float()).abs()
            / (1 + want.float().abs())).max().item()


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits; 0 at 0)."""
    import torch
    m, e = torch.frexp(x.float())
    return torch.ldexp((m != 0).float(), e - 8)


def _bwd_case(i):
    """Case i of the backward grid on the card: (args of the kernels' call
    (q, k, v, out, lse, dO), the mask keywords, the plain version's f32
    math, and in bf16 the plain version at the kernels' rounding points,
    else None), all on the lse of the kernel's forward."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    shape, dtype, causal, window, q_offset = _bwd_grid()[i]
    q, k, v = _qkv(shape, getattr(torch, dtype), seed=100 + i)
    do = _qkv(shape, getattr(torch, dtype), seed=200 + i)[0]
    kw = dict(causal=causal, window=window, scale=None, q_offset=q_offset)
    out, lse = kernel.flash_fwd(q, k, v, **kw)
    args = (q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(*args, scores_as_forward=True, **kw)
    want_r = None if dtype == "float32" else ref.flash_attention_bwd_ref(
        *args, rounded=True, **kw)
    return args, kw, want, want_r


def _bwd_errors(got, want, want_r):
    """Per output: max |err|/(1+|ref|) against the f32 math, and against
    the rounded plain version (bf16 only) the worst ratio to its elementwise
    bound (1 bf16 ulp + BWD_ROUNDED_ABS max|ref|) and the relative L2."""
    import torch
    errs = {}
    for name, g, w, wr in zip(("dq", "dk", "dv"), got, want,
                              want_r or (None,) * 3):
        e = {"rel": _rel_err(g, w)}
        if wr is not None:
            d = (g.float() - wr.float()).abs()
            bound = _bf16_ulp(wr) + BWD_ROUNDED_ABS * wr.float().abs().max()
            e["ratio"] = (d / bound).max().item()
            e["l2"] = (torch.linalg.vector_norm(d)
                       / torch.linalg.vector_norm(wr.float())).item()
        errs[name] = e
    return errs


def _bwd_ok(errs, dtype):
    return all(e["rel"] <= BWD_TOL[dtype] and e.get("ratio", 0) <= 1
               and e.get("l2", 0) <= BWD_ROUNDED_L2 for e in errs.values())


def phase_kernel_bwd():
    import torch
    from repro_torch.kernels.flash_attention import kernel
    worst, worst_r, train_err = {}, {"ratio": 0.0, "l2": 0.0}, {}
    n_fused = 0    # cases on the dQ/dK/dV kernel's route
    worst_d = {}
    worst_delta = 0.0
    for i, (shape, dtype, causal, window, q_offset) in enumerate(_bwd_grid()):
        args, kw, want, want_r = _bwd_case(i)
        got = kernel.flash_bwd(*args, **kw)
        # delta's kernel against its plain version, relative to each row's
        # rowsum(|dO * O|): the two sum the same f32 products in other orders
        _, _, _, out, _, do = args
        delta = kernel.flash_bwd_delta(do, out)
        torch.cuda.synchronize()
        d_err = ((delta - kernel.bwd_delta(do, out)).abs()
                 / (do.float() * out.float()).abs().sum(-1).clamp_min(
                     torch.finfo(torch.float32).tiny)).max().item()
        check(d_err <= DELTA_TOL,
              f"bwd case {i} {shape} {dtype}: delta's kernel {d_err:.3e} "
              f"from the plain version (limit {DELTA_TOL})")
        worst_delta = max(worst_delta, d_err)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"bwd case {i}: {name} shape/dtype")
            check(bool(torch.isfinite(g).all()),
                  f"bwd case {i}: non-finite {name}")
        errs = _bwd_errors(got, want, want_r)
        check(_bwd_ok(errs, dtype),
              f"bwd case {i} {shape} {dtype} causal={causal} window={window}"
              f" q_offset={q_offset}: {errs} (limits {BWD_TOL[dtype]} "
              f"against the f32 math; in bf16 ratio 1 and relative L2 "
              f"{BWD_ROUNDED_L2} against the rounded plain version)")
        for e in errs.values():
            worst[dtype] = max(worst.get(dtype, 0.0), e["rel"])
            worst_d[shape[-1]] = max(worst_d.get(shape[-1], 0.0), e["rel"])
            for key in worst_r:
                worst_r[key] = max(worst_r[key], e.get(key, 0.0))
        if q_offset < 0:   # rows that see no key: dq = 0
            check(bool((got[0][:, :-q_offset] == 0).all()),
                  f"bwd case {i}: fully masked rows have dq != 0")
        # where flash_bwd took the dQ/dK/dV kernel, the dQ and dK/dV kernels
        # on the same inputs, held to the same bounds
        q, k, v, _, lse, _ = args
        pair = None
        if kernel.takes_dqkv(q.dtype, shape[1], shape[2], shape[3],
                             shape[4], shape[5]):
            n_fused += 1
            pair = (kernel.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    *kernel.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
            pair_errs = _bwd_errors(pair, want, want_r)
            check(_bwd_ok(pair_errs, dtype),
                  f"bwd case {i} {shape}: the dQ and dK/dV kernels beside "
                  f"the dQ/dK/dV kernel's route: {pair_errs}")
        if shape in (TRAIN_SHAPE, GEMMA_TRAIN_SHAPE, GEMMA_PHASE2_SHAPE,
                     DEEPSEEK_TRAIN_SHAPE, DEEPSEEK_PHASE2_SHAPE,
                     ZAMBA_TRAIN_SHAPE,
                     (32,) + ZAMBA_TRAIN_SHAPE[1:], MINICPM_TRAIN_SHAPE,
                     (32,) + MINICPM_TRAIN_SHAPE[1:], QWEN_VL_TRAIN_SHAPE):
            train_err[shape] = {
                n: (g.float() - w.float()).abs().max().item()
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            train_err[shape]["delta"] = (
                delta - kernel.bwd_delta(do, out)).abs().max().item()
            if pair is not None:
                train_err[shape]["pair"] = {
                    n: (g.float() - w.float()).abs().max().item()
                    for n, g, w in zip(("dq", "dk", "dv"), pair, want)}
    print(f"[kernel-bwd] {len(_bwd_grid())} cases match the plain version's "
          f"f32 math; max |err|/(1+|ref|) f32 {worst['float32']:.3e} (limit "
          f"{BWD_TOL['float32']}), bf16 {worst['bfloat16']:.3e} (limit "
          f"{BWD_TOL['bfloat16']}); bf16 against the plain version at the "
          f"kernels' rounding points: worst {worst_r['ratio']:.3f} of the "
          f"bound (1 bf16 ulp + {BWD_ROUNDED_ABS:.2e} max|ref|), relative L2 "
          f"{worst_r['l2']:.3e} (limit {BWD_ROUNDED_L2}); worst by head dim "
          + ", ".join(f"D {d} {e:.3e}" for d, e in sorted(worst_d.items()))
          + f"; delta's kernel within {worst_delta:.3e} of rowsum(|dO * O|) "
          f"of the plain version (limit {DELTA_TOL}); {n_fused} cases on the "
          f"dQ/dK/dV kernel, where the dQ and dK/dV kernels are held to the "
          f"same bounds beside it")

    # the dQ/dK/dV kernel sums in a fixed order with no atomics: two
    # launches on gemma3's and deepseek's inputs give the same bits, at
    # phase 1 and phase 2, and a batch gets the bits of a launch on it
    # alone (at D 256 a CTA a (batch, KV head); at D 192 each (batch, head)
    # whole in whichever persistent CTA takes it)
    for shape, label in ((GEMMA_TRAIN_SHAPE, "gemma3 phase-1"),
                         (GEMMA_PHASE2_SHAPE, "gemma3 phase-2"),
                         (DEEPSEEK_TRAIN_SHAPE, "deepseek phase-1, MLA"),
                         (DEEPSEEK_PHASE2_SHAPE, "deepseek phase-2, MLA")):
        _dqkv_twice(shape)
        _bwd_batch_slice(shape, label, causal=True)

    # times at the phase-1 training shape (the JSON rows) and phase 2's;
    # gemma3's phase 1 at the batch its run takes, and its phase 2 (there
    # flash_bwd runs the dQ/dK/dV kernel; the dQ and dK/dV kernels are timed
    # beside it); deepseek-v2-lite's phase 1 and phase 2 at MLA's head dim
    # 192; zamba2-7b's at 112
    phase1 = _bwd_times(TRAIN_SHAPE, "phase-1")
    phase2 = _bwd_times((32,) + TRAIN_SHAPE[1:], "phase-2")
    g_phase1 = _bwd_times(GEMMA_TRAIN_SHAPE, "gemma3 phase-1")
    g_phase2 = _bwd_times(GEMMA_PHASE2_SHAPE, "gemma3 phase-2")
    d_shape2 = DEEPSEEK_PHASE2_SHAPE
    d_phase1 = _bwd_times(DEEPSEEK_TRAIN_SHAPE, "deepseek phase-1, MLA")
    d_phase2 = _bwd_times(d_shape2, "deepseek phase-2, MLA")
    # zamba2-7b's shared block at head dim 112, G 1
    z_shape2 = (32,) + ZAMBA_TRAIN_SHAPE[1:]
    z_phase1 = _bwd_times(ZAMBA_TRAIN_SHAPE, "zamba2 phase-1")
    z_phase2 = _bwd_times(z_shape2, "zamba2 phase-2")
    # minicpm3-4b's MLA at head dim 96, G 1
    m_shape2 = (32,) + MINICPM_TRAIN_SHAPE[1:]
    m_phase1 = _bwd_times(MINICPM_TRAIN_SHAPE, "minicpm3 phase-1, MLA")
    m_phase2 = _bwd_times(m_shape2, "minicpm3 phase-2, MLA")
    # granite-moe's phase 1 (D 64, G 3) and whisper-base's encoder at its
    # train batch (D 64, G 1, non-causal over 1500 frames)
    gr_phase1 = _bwd_times(GRANITE_TRAIN_SHAPE, "granite phase-1")
    w_phase1 = _bwd_times(WHISPER_ENCODER_TRAIN_SHAPE, "whisper encoder",
                          causal=False, plain=False)
    # qwen2-vl-72b's train step (D 128, G 8)
    q_step = _bwd_times(QWEN_VL_TRAIN_SHAPE, "qwen2-vl train step")
    # the backward's exponentials: dQ and dK/dV each recompute P
    B, Sq, Skv, H = WHISPER_ENCODER_TRAIN_SHAPE[:4]
    q, k, v = _qkv(WHISPER_ENCODER_TRAIN_SHAPE, torch.bfloat16, seed=4331)
    do = _qkv(WHISPER_ENCODER_TRAIN_SHAPE, torch.bfloat16, seed=4332)[0]
    out, lse = kernel.flash_fwd(q, k, v, causal=False)
    mufu = _mufu_bound(
        lambda: kernel.flash_bwd(q, k, v, out, lse, do, causal=False),
        2 * B * H * Sq * Skv, "whisper encoder, train batch, backward "
                              "(dQ and dK/dV)", iters=60)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        w_phase1[name] = {**w_phase1[name], "sm_clock_mhz":
                          mufu["sm_clock_mhz"], "exps": mufu["exps"] // 2,
                          "mufu_bound_ms": mufu["mufu_bound_ms"] / 2}
    del q, k, v, do, out, lse
    _bwd_batch_slice(WHISPER_ENCODER_TRAIN_SHAPE, "whisper encoder")

    def errs(shape, name):
        e = train_err[shape]
        if name.endswith("delta"):
            return e["delta"]
        if name.endswith("dqkv"):
            return max(e["dq"], e["dk"], e["dv"])
        # where flash_bwd takes the dQ/dK/dV kernel, the pair's own errors
        e = e.get("pair", e)
        return e["dq"] if name.endswith("dq") else max(e["dk"], e["dv"])

    # the dQ/dK/dV kernel's row: its times at gemma3's phase 1 and phase 2
    # (D 256) and deepseek's (D 192), with the dQ and dK/dV kernels' (the
    # route it replaces there) from the same run
    fused = "flash_attention_bwd_dqkv"
    pair_ms = {key: t["flash_attention_bwd_dq"]["ms"]
               + t["flash_attention_bwd_dkv"]["ms"]
               for key, t in (("train", g_phase1), ("phase2", g_phase2),
                              ("d_train", d_phase1), ("d_phase2", d_phase2))}
    dqkv_row = {"name": fused, "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_bwd_sm90.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:202",
                "replaces_note": "and kernel.py:232 (_fa_bwd_dkv_kernel), "
                                 "both where one key tile and one query "
                                 "tile hold the sequence at head dim 256 "
                                 "and, at G 1, at head dim 192",
                "launches": None,
                "max_abs_err": errs(GEMMA_TRAIN_SHAPE, fused),
                **g_phase1[fused], "pair_ms": pair_ms["train"],
                "phase2_shape": {"max_abs_err": errs(GEMMA_PHASE2_SHAPE,
                                                     fused),
                                 **g_phase2[fused],
                                 "pair_ms": pair_ms["phase2"]},
                "deepseek_train_shape": {
                    "max_abs_err": errs(DEEPSEEK_TRAIN_SHAPE, fused),
                    **d_phase1[fused], "pair_ms": pair_ms["d_train"]},
                "deepseek_phase2_shape": {
                    "max_abs_err": errs(d_shape2, fused), **d_phase2[fused],
                    "pair_ms": pair_ms["d_phase2"]}}
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       + ("flash_bwd.cu" if name.endswith("delta")
                          else "flash_bwd_sm90.cu"),
             "replaces": f"src/repro/kernels/flash_attention/kernel.py:{line}",
             **({"replaces_note": "no Pallas kernel: the plain jnp delta "
                                  "inside flash_attention_pallas_bwd"}
                if name.endswith("delta") else {}),
             "launches": None, "max_abs_err": errs(TRAIN_SHAPE, name),
             **phase1[name], "phase2_shape": phase2[name],
             "gemma3_train_shape": {
                 "max_abs_err": errs(GEMMA_TRAIN_SHAPE, name),
                 **g_phase1[name]},
             "gemma3_phase2_shape": {
                 "max_abs_err": errs(GEMMA_PHASE2_SHAPE, name),
                 **g_phase2[name]},
             "deepseek_train_shape": {
                 "max_abs_err": errs(DEEPSEEK_TRAIN_SHAPE, name),
                 **d_phase1[name]},
             "deepseek_phase2_shape": {
                 "max_abs_err": errs(d_shape2, name), **d_phase2[name]},
             "zamba2_train_shape": {
                 "max_abs_err": errs(ZAMBA_TRAIN_SHAPE, name),
                 **z_phase1[name]},
             "zamba2_phase2_shape": {
                 "max_abs_err": errs(z_shape2, name), **z_phase2[name]},
             "minicpm3_train_shape": {
                 "max_abs_err": errs(MINICPM_TRAIN_SHAPE, name),
                 **m_phase1[name]},
             "minicpm3_phase2_shape": {
                 "max_abs_err": errs(m_shape2, name), **m_phase2[name]},
             "granite_train_shape": gr_phase1[name],
             "whisper_encoder_train_shape": w_phase1[name],
             "qwen2vl_train_shape": {
                 "max_abs_err": errs(QWEN_VL_TRAIN_SHAPE, name),
                 **q_step[name]}}
            for name, line in (("flash_attention_bwd_dq", 202),
                               ("flash_attention_bwd_dkv", 232),
                               ("flash_attention_bwd_delta", 288))] + [
                dqkv_row]


def _dqkv_twice(shape):
    """The dQ/dK/dV kernel launched twice on the same inputs at ``shape``:
    dq, dk and dv bitwise equal."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    q, k, v = _qkv(shape, torch.bfloat16, seed=4341)
    do = _qkv(shape, torch.bfloat16, seed=4342)[0]
    out, lse = kernel.flash_fwd(q, k, v)
    delta = kernel.flash_bwd_delta(do, out)
    first = kernel.flash_bwd_dqkv(q, k, v, do, lse, delta)
    again = kernel.flash_bwd_dqkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        check(torch.equal(a, b),
              f"dQ/dK/dV kernel at {shape}: a second launch on the same "
              f"inputs gives another {name} (max |diff| "
              f"{(a.float() - b.float()).abs().max().item():.3e})")
    print(f"[kernel-bwd] dQ/dK/dV kernel at {shape}, causal: dq, dk, dv of "
          f"two launches on the same inputs bitwise equal", flush=True)


def _bwd_batch_slice(shape, label, batch=8, causal=False):
    """The bf16 backward at ``shape`` (by default non-causal; the whole
    grid: at whisper's encoder train shape 24576 CTAs a kernel) against the
    same call on its first ``batch`` batches alone, bitwise. Its kernels
    sum in a fixed order with no atomics, so what a CTA writes depends on
    neither its place in the grid nor the order the grid runs in; the plain
    version cannot run at whisper's shape (its (B, H, S, S) f32 tensors),
    and the B-8 encoder case of the grid holds the values against it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    q, k, v = _qkv(shape, torch.bfloat16, seed=4331)
    do = _qkv(shape, torch.bfloat16, seed=4332)[0]
    out, lse = kernel.flash_fwd(q, k, v, causal=causal)
    full = kernel.flash_bwd(q, k, v, out, lse, do, causal=causal)
    part = kernel.flash_bwd(*(t[:batch] for t in (q, k, v, out, lse, do)),
                            causal=causal)
    torch.cuda.synchronize()
    for name, f, g in zip(("dq", "dk", "dv"), full, part):
        check(bool(torch.isfinite(f).all()),
              f"{label} at {shape}: non-finite {name}")
        check(torch.equal(f[:batch], g),
              f"{label} at {shape}: {name} of the first {batch} batches "
              f"differs from a launch on those batches alone (max |diff| "
              f"{(f[:batch].float() - g.float()).abs().max().item():.3e})")
    mask = "causal" if causal else "non-causal"
    print(f"[kernel-bwd] {label} at {shape}, {mask}: dq, dk, dv of the "
          f"first {batch} batches equal, bitwise, a launch on those batches "
          f"alone", flush=True)


MUFU_PER_CLOCK = 16 * 132     # ex2 results a clock: 16 an SM, 132 SMs


def _mufu_bound(run, exps: int, label: str, iters: int = 200) -> dict:
    """The least time the card's special-function units (MUFU) take for
    ``exps`` exponentials, at the SM clock that ``nvidia-smi`` reads while
    ``iters`` launches of ``run`` are still queued (the card busy)."""
    import torch
    for _ in range(iters):
        run()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    mhz = float(smi.stdout.split()[0])
    ms = exps / (MUFU_PER_CLOCK * mhz * 1e6) * 1e3
    print(f"[kernel] {label}: MUFU bound {ms:.4f} ms ({exps:.4g} exps at "
          f"{mhz:.0f} MHz, the SM clock under this load)", flush=True)
    return {"mufu_bound_ms": ms, "sm_clock_mhz": mhz, "exps": exps}


def _fwd_batch_slice(shape, label, batch=8):
    """The bf16 forward at ``shape`` (non-causal) against the same call on
    its first ``batch`` batches alone, bitwise: the forward twin of
    ``_bwd_batch_slice``. What a CTA writes depends on neither its place in
    the grid nor the order the grid runs in; the plain version cannot run
    at that shape, and the B-8 encoder case of the grid holds the values
    against it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    q, k, v = _qkv(shape, torch.bfloat16, seed=4333)
    full = kernel.flash_fwd(q, k, v, causal=False)
    part = kernel.flash_fwd(q[:batch], k[:batch], v[:batch], causal=False)
    torch.cuda.synchronize()
    for name, f, g in zip(("out", "lse"), full, part):
        check(bool(torch.isfinite(f).all()),
              f"{label} at {shape}: non-finite {name}")
        check(torch.equal(f[:batch], g),
              f"{label} at {shape}: {name} of the first {batch} batches "
              f"differs from a launch on those batches alone (max |diff| "
              f"{(f[:batch].float() - g.float()).abs().max().item():.3e})")
    print(f"[kernel] {label} at {shape}, non-causal: out and lse of the "
          f"first {batch} batches equal, bitwise, a launch on those "
          f"batches alone", flush=True)


def _bwd_times(shape, label, causal=True, plain=True):
    """Device times of the bf16 dQ, dK/dV and delta kernels, of the whole
    ``kernel.flash_bwd`` call (delta, dQ, dK/dV) and of delta's plain
    version (``kernel.bwd_delta``), each behind the sleep kernel, beside
    their bounds, the plain backward (left out with ``plain=False``: at
    whisper's encoder train shape its (B, H, S, S) f32 tensors take tens of
    GB), the library's fused attention backward timed alone (one forward
    with its graph kept, then the backward again and again) and, for
    delta, one library call that computes it (a batched product with f32
    output)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    B, Sq, Skv, H, KVH, D = shape
    q, k, v = _qkv(shape, torch.bfloat16, seed=4321)
    do = _qkv(shape, torch.bfloat16, seed=4322)[0]
    out, lse = kernel.flash_fwd(q, k, v, causal=causal)
    delta = kernel.flash_bwd_delta(do, out)
    dq_ms = _device_ms(lambda: kernel.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   causal=causal), 50)
    dkv_ms = _device_ms(lambda: kernel.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     causal=causal), 50)
    bwd_ms = _device_ms(lambda: kernel.flash_bwd(q, k, v, out, lse, do,
                                                 causal=causal), 50)
    fused = kernel.takes_dqkv(q.dtype, Sq, Skv, H, KVH, D)
    dqkv_ms = _device_ms(lambda: kernel.flash_bwd_dqkv(
        q, k, v, do, lse, delta, causal=causal), 50) if fused else None
    delta_ms = _device_ms(lambda: kernel.flash_bwd_delta(do, out), 50)
    delta_plain_ms = _device_ms(lambda: kernel.bwd_delta(do, out), 50)
    # yardstick only, never called by the port: delta as one library call
    rows = B * Sq * H
    delta_lib_ms = _device_ms(lambda: torch.bmm(
        do.view(rows, 1, D), out.view(rows, D, 1), out_dtype=torch.float32),
        50)
    plain_ms = _cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal), 5) if plain else None
    # yardstick only, never called by the port: the library's fused
    # attention backward alone, on K/V with their heads repeated beforehand
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    kt.requires_grad_()
    vt.requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    o = sdpa(qt, kt, vt, is_causal=causal)
    lib_ms = _device_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), 50)
    del o
    mask = "causal" if causal else "non-causal"
    pairs = _visible_pairs(Sq, Skv, causal, 0, 0) * B * H
    elt = 2                                            # bf16
    read = (q.numel() * 2 + k.numel() + v.numel()) * elt \
        + 2 * B * Sq * H * 4                       # q, dO, k, v, lse, delta
    times = {}
    for name, ms, nbytes, flops, p_ms, l_ms in (
            ("flash_attention_bwd_dq", dq_ms, read + q.numel() * elt,
             6 * D * pairs, plain_ms, lib_ms),
            ("flash_attention_bwd_dkv", dkv_ms, read + 2 * k.numel() * elt,
             8 * D * pairs, plain_ms, lib_ms),
            # dQ/dK/dV: S, dP, dV, dK and dQ, 2 D each a visible pair
            *((("flash_attention_bwd_dqkv", dqkv_ms,
                read + (q.numel() + 2 * k.numel()) * elt, 10 * D * pairs,
                plain_ms, lib_ms),) if fused else ()),
            # delta: read dO and O, write delta
            ("flash_attention_bwd_delta", delta_ms,
             2 * do.numel() * elt + rows * 4, 2 * D * rows, delta_plain_ms,
             delta_lib_ms)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        which = ("plain" if name.endswith("delta")
                 else "plain (dq, dk, dv together)")
        lib = ("library bmm, f32 out" if name.endswith("delta") else
               "library backward alone (dq, dk, dv together)")
        print(f"[kernel-bwd] {label} {name} at B{B} S{Sq} H{H} KVH{KVH} D{D} "
              f"bf16 {mask}: kernel {ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), {which} "
              f"{'not timed' if p_ms is None else f'{p_ms:.4f} ms'}, {lib} "
              f"{l_ms:.4f} ms")
        times[name] = {"shape": f"B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 {mask}",
                       "ms": ms, "plain_ms": p_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "library_ms": l_ms}
    # the whole backward: read q, out, dO, k, v, lse; write dq, dk, dv
    nbytes = 4 * (q.numel() + k.numel()) * elt + B * Sq * H * 4
    t_whole = max(nbytes / HBM_BYTES_PER_S,
                  10 * D * pairs / PEAK_FLOPS["bfloat16"]) * 1e3
    print(f"[kernel-bwd] {label} kernel.flash_bwd (delta, dQ, dK/dV): "
          f"{bwd_ms:.4f} ms, bound {t_whole * 1e3:.2f} us ({nbytes / 1e6:.1f}"
          f" MB), library backward alone {lib_ms:.4f} ms "
          f"({bwd_ms / lib_ms:.2f}x); delta's kernel {delta_ms:.4f} ms, its "
          f"plain chain {delta_plain_ms:.4f} ms", flush=True)
    for t in times.values():
        t.update(flash_bwd_ms=bwd_ms, flash_bwd_bound_ms=t_whole,
                 flash_bwd_library_ms=lib_ms)
    return times


def phase_swa_avg():
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.swa_avg import kernel, ref
    from repro_torch.models.model import Model
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (0, 1, 7):
            for size in (1, 8191, 8193, 92544 * 2048):   # last: the embedding
                g = torch.Generator(device="cuda").manual_seed(size + n)
                avg = torch.randn(size, generator=g, device="cuda").to(dtype)
                w = torch.randn(size, generator=g, device="cuda")
                got = kernel.running_average(avg, w, n)
                torch.cuda.synchronize()
                want = ref.running_average_ref(avg, w, n)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                check(torch.equal(got.view(bits), want.view(bits)),
                      f"swa_avg {dtype} n={n} size={size}: not bitwise "
                      f"equal to the plain version")
                n_cases += 1
    # the cifar-cnn config() tree: 25 f32 leaves, 64 to 589,824 elements
    from repro_torch.models import cnn
    cnn_cfg = registry.get_config("cifar-cnn")
    g = torch.Generator(device="cuda").manual_seed(11)
    trees = [cnn.init_cnn(g, cnn_cfg)[0] for _ in range(2)]
    for n in (0, 1, 7):
        for avg, w in zip(_leaves(trees[0]), _leaves(trees[1])):
            got = kernel.running_average(avg, w, n)
            torch.cuda.synchronize()
            want = ref.running_average_ref(avg, w, n)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"swa_avg cifar-cnn leaf {tuple(avg.shape)} n={n}: not "
                  f"bitwise equal to the plain version")
            n_cases += 1
    print(f"[swa_avg] {n_cases} cases bitwise equal to the plain version "
          f"(the cifar-cnn tree's {len(list(_leaves(trees[0])))} leaves "
          f"among them)")

    # times on the full-width internlm2-1.8b parameter tree (f32)
    model = Model(registry.get_config("internlm2-1.8b"))
    g = torch.Generator(device="cuda").manual_seed(7)
    avg = list(_leaves(model.init(g)))
    w = list(_leaves(model.init(g)))
    numel = sum(t.numel() for t in avg)

    def fold_kernel():
        for a, x in zip(avg, w):
            kernel.running_average(a, x, 1, out=a)

    def fold_plain():
        for a, x in zip(avg, w):
            a.copy_(ref.running_average_ref(a, x, 1))

    ms = _cuda_ms(fold_kernel, 5)
    plain_ms = _cuda_ms(fold_plain, 3)
    lib_ms = _cuda_ms(lambda: torch._foreach_lerp_(avg, w, 0.5), 5)
    nbytes = 3 * 4 * numel
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * numel / PEAK_FLOPS["float32"] * 1e3
    print(f"[swa_avg] full-width tree, {len(avg)} leaves, {numel} f32: "
          f"kernel {ms:.4f} ms ({len(avg)} launches), bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.2f} GB), plain "
          f"{plain_ms:.4f} ms, library _foreach_lerp_ {lib_ms:.4f} ms",
          flush=True)
    del avg, w
    torch.cuda.empty_cache()
    return {
        "name": "swa_avg", "route": "cuda",
        "source": "src/repro_torch/kernels/swa_avg/csrc/swa_avg.cu",
        "replaces": "src/repro/kernels/swa_avg/kernel.py:24",
        "launches": None, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms}


def _ssd_inputs(shape, dtype, seed):
    """x, dt, A, Bm, Cm as the JAX SSD tests draw them; x, Bm and Cm in
    ``dtype``, dt and A in f32."""
    import torch
    B, S, H, P, G, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = mk(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(mk(B, S, H))
    A = -torch.exp(mk(H))
    return x, dt, A, mk(B, S, G, N).to(dtype), mk(B, S, G, N).to(dtype)


def _ssd_cotangents(shape, chunk, seed):
    import torch
    B, S, H, P, G, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return mk(B, S, H, P), mk(B, S // chunk, H, P, N), mk(B, S, H)


def _scaled_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ssd_grid():
    """(B, S, H, P, G, N), chunk, dtype: every L in 1..256 the main paths
    give the kernels (1, engine prompts 37 and 200, training 64, the full
    chunk 256), with 1 to 3 chunks, 1 or 2 groups, both (P, N); then the
    bf16 route's widths (N 128, mamba2-2.7b; N 64, the zamba2-7b mamba
    blocks) with groups of 20 and 16 heads: 20 is not a multiple of the
    head blocks (8 forward, 16 / 8 / 5 / 4 backward), 16 is; and zamba2's
    own, 112 heads in one group."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for P, N in ((64, 128), (32, 16)):
            for G in (1, 2):
                for k, L in enumerate((1, 37, 64, 200, 256)):
                    nc = 1 + (k + G + P // 32) % 3
                    cases.append(((2, L * nc, 4, P, G, N), L, dtype))
    for N, H, G in ((128, 20, 1), (128, 32, 2), (64, 4, 1), (64, 4, 2),
                    (64, 20, 1), (64, 32, 2), (64, 112, 1)):
        for k, L in enumerate((1, 37, 64, 200, 256)):
            nc = 1 + (k + H) % 2
            cases.append(((2, L * nc, H, 64, G, N), L, "bfloat16"))
    return cases


def _ssd_work(shape, chunk, elt, bwd: bool):
    """(bytes, flops) the function must move and do: each input read once,
    each output written once; the pairs j <= i of each chunk. What depends
    on B and C alone is counted once per group, the rest once per head: the
    C.B^T scores, and in the backward the dC and dB products, taken on
    dG o seg summed over the group's heads (dC and dB are per group)."""
    B, S, H, P, G, N = shape
    nc = S // chunk
    pairs = chunk * (chunk + 1) // 2
    inputs = (B * S * H * P + 2 * B * S * G * N) * elt + (B * S * H + H) * 4
    if not bwd:
        out = (B * S * H * P + B * nc * H * P * N + B * S * H) * 4
        # per group C.B^T; per head y = (scores o seg) (dt x) and the state
        flops = B * nc * (G * pairs * 2 * N
                          + H * (pairs * 2 * P + 2 * P * N * chunk))
        return inputs + out, flops
    cots = (B * S * H * P + B * nc * H * P * N + B * S * H) * 4
    out = (B * S * H * P + B * S * H + H + 2 * B * S * G * N) * 4
    # per group C.B^T, dC and dB; per head dG, d_dx, the sum of dG o seg
    # over the group and the state terms (B dS^T, x dS)
    flops = B * nc * (G * pairs * 6 * N
                      + H * (pairs * (4 * P + 1) + 4 * P * N * chunk))
    return inputs + cots + out, flops


def _bound(nbytes, flops):
    """The SSD work's least time on the card, (ms, what binds): the bf16
    route runs its products on the tensor cores, so the function's flops
    count at the bf16 rate, and the bytes bind at every main-path shape."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_ssd():
    import torch
    from repro_torch.kernels.ssd import kernel, ops
    worst, worst_r, n_route = {}, {}, 0
    names = ("y", "states", "cum", "dx", "ddt", "dA", "dB", "dC")
    for i, (shape, L, dtype) in enumerate(_ssd_grid()):
        args = _ssd_inputs(shape, getattr(torch, dtype), seed=300 + i)
        cots = _ssd_cotangents(shape, L, seed=400 + i)
        sm90 = kernel.sm90_route(args[0], args[3])
        before = kernel.ssd_fwd.launches_sm90, kernel.ssd_bwd.launches_sm90
        got = kernel.ssd_fwd(*args, chunk=L)
        got_b = kernel.ssd_bwd(*args, *cots, chunk=L)
        torch.cuda.synchronize()
        check((kernel.ssd_fwd.launches_sm90 - before[0],
               kernel.ssd_bwd.launches_sm90 - before[1]) == (sm90, sm90),
              f"ssd case {i} {shape} {dtype}: took the wrong route")
        want = ops._intra_chunk(*args, L)
        want_b = ops._intra_chunk_bwd(*args, *cots, L)
        for name, g, w in zip(names, got + got_b, want + want_b):
            check(g.shape == w.shape and g.dtype == torch.float32,
                  f"ssd case {i}: {name} shape/dtype")
            check(bool(torch.isfinite(g).all()),
                  f"ssd case {i}: non-finite {name}")
            err = _scaled_err(g, w)
            check(err <= SSD_TOL, f"ssd case {i} {shape} L={L} {dtype}: "
                                  f"{name} error {err:.3e} > {SSD_TOL}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        if not sm90:
            continue
        # the bf16 route: against the plain versions at its rounding
        # points, and the same bits from a second launch (no atomics)
        n_route += 1
        want_r = (ops._intra_chunk(*args, L, rounded=True)
                  + ops._intra_chunk_bwd(*args, *cots, L, rounded=True))
        again = (kernel.ssd_fwd(*args, chunk=L)
                 + kernel.ssd_bwd(*args, *cots, chunk=L))
        for name, g, w, a in zip(names, got + got_b, want_r, again):
            err = _scaled_err(g, w)
            check(err <= SSD_ROUNDED_TOL[name],
                  f"ssd case {i} {shape} L={L}: {name} error {err:.3e} "
                  f"against the rounded plain version > "
                  f"{SSD_ROUNDED_TOL[name]}")
            worst_r[name] = max(worst_r.get(name, 0.0), err)
            check(torch.equal(g, a), f"ssd case {i} {shape} L={L}: {name} "
                                     f"differs between two launches")
    # ragged S through the scan: padding, chunk chaining and, in f32, the
    # Function's grads (bf16 leaves would get bf16-rounded grads, which two
    # paths that differ in the last f32 bits may round one bf16 step apart)
    for S, chunk in ((83, 32), (513, 256)):
        shape = (2, S, 4, 64, 2, 128)
        for dtype in ("float32", "bfloat16"):
            x, dt, A, Bm, Cm = _ssd_inputs(shape, getattr(torch, dtype),
                                           seed=S)
            D = torch.randn(4, device="cuda")
            outs = {}
            for impl in ("kernel", "reference"):
                ts = [t.detach().clone().requires_grad_(dtype == "float32")
                      for t in (x, dt, A, Bm, Cm, D)]
                with torch.set_grad_enabled(dtype == "float32"):
                    y, st = ops.ssd_scan(*ts, chunk=chunk, impl=impl)
                outs[impl] = [y, st]
                if dtype == "float32":
                    loss = (y ** 2).mean() + (st ** 2).mean()
                    outs[impl] += torch.autograd.grad(loss, ts)
            for name, g, w in zip(("y", "state", "dx", "ddt", "dA", "dB",
                                   "dC", "dD"), *outs.values()):
                err = _scaled_err(g, w)
                check(err <= SSD_TOL, f"ssd_scan S={S} chunk={chunk} "
                                      f"{dtype}: {name} error {err:.3e}")
                worst[dtype] = max(worst[dtype], err)
    print(f"[ssd] {len(_ssd_grid())} kernel cases (fwd and bwd) and 4 ragged "
          f"scans (f32 with grads) match the plain versions; max |err|/max "
          f"|ref| "
          f"f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} (limit "
          f"{SSD_TOL}); the {n_route} cases of the bf16 wgmma route against "
          f"the plain versions at its rounding points, worst per output: "
          + ", ".join(f"{k} {v:.2e} (limit {SSD_ROUNDED_TOL[k]:.0e})"
                      for k, v in worst_r.items())
          + "; bitwise equal from launch to launch")

    # times at the main paths' shapes: the bf16 route's kernel and the f32
    # FMA kernel it replaces (fma=True, same inputs), each behind the sleep
    # kernel, beside the bound, the plain version and, for PERF.md's
    # history, the f32 CUDA-core figure of the same work
    times = {}
    for name, shape7, bwd, where in (
            ("ssd_fwd", SSD_SERVE_SHAPE, False, "serve prefill"),
            ("ssd_fwd", SSD_TRAIN_SHAPE, False, "training phase 1"),
            ("ssd_bwd", SSD_TRAIN_SHAPE, True, "training phase 1"),
            ("ssd_fwd", SSD_BUCKET_SHAPE, False,
             "bucket prefill, batch 1"),
            ("ssd_fwd", ZAMBA_SSD_SERVE_SHAPE, False, "zamba2 serve prefill"),
            ("ssd_fwd", ZAMBA_SSD_TRAIN_SHAPE, False,
             "zamba2 training phase 1"),
            ("ssd_bwd", ZAMBA_SSD_TRAIN_SHAPE, True,
             "zamba2 training phase 1")):
        *shape, chunk = shape7
        args = _ssd_inputs(tuple(shape), torch.bfloat16, seed=7)
        if bwd:
            cots = _ssd_cotangents(tuple(shape), chunk, seed=8)
            run = lambda fma=False: kernel.ssd_bwd(*args, *cots, chunk=chunk,
                                                   fma=fma)
            plain = lambda: ops._intra_chunk_bwd(*args, *cots, chunk)
        else:
            run = lambda fma=False: kernel.ssd_fwd(*args, chunk=chunk,
                                                   fma=fma)
            plain = lambda: ops._intra_chunk(*args, chunk)
        before = getattr(kernel, name).launches_sm90
        got = run()
        check(getattr(kernel, name).launches_sm90 == before + 1,
              f"{name} at the {where} shape did not take the bf16 route")
        want = plain()
        errs = [_scaled_err(g, w) for g, w in zip(got, want)]
        check(max(errs) <= SSD_TOL, f"{name} at the {where} shape: error "
                                    f"{max(errs):.3e}")
        max_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
        del got, want
        ms = _device_ms(run, 20)
        old_ms = _device_ms(lambda: run(fma=True), 5)
        ms_again = _device_ms(run, 20)
        plain_ms = _cuda_ms(plain, 3)
        nbytes, flops = _ssd_work(tuple(shape), chunk, 2, bwd)
        bound_ms, bound_by = _bound(nbytes, flops)
        f32_ms = flops / PEAK_FLOPS["float32"] * 1e3
        B, S, H, P, G, N = shape
        print(f"[ssd] {name} at the {where} shape B{B} S{S} H{H} P{P} G{G} "
              f"N{N} L{chunk} bf16: wgmma kernel {ms:.4f} / {ms_again:.4f} "
              f"ms, f32 FMA kernel {old_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
              f"GFLOP; at the f32 CUDA-core rate {f32_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library none (no PyTorch call computes "
              f"it); max |err| {max_abs:.3e}", flush=True)
        times[name, where] = {
            "shape": f"B{B} S{S} H{H} P{P} G{G} N{N} L{chunk} bf16",
            "max_abs_err": max_abs, "ms": min(ms, ms_again),
            "old_fma_ms": old_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_f32_cuda_cores_ms": max(nbytes / HBM_BYTES_PER_S * 1e3,
                                           f32_ms),
            "library_ms": None}
        del args
        torch.cuda.empty_cache()
    # the forward's row is taken at the serve prefill, with the training
    # shape beside it; the backward's at the training shape
    src = "src/repro_torch/kernels/ssd/csrc/"
    serve = times["ssd_fwd", "serve prefill"]
    return [
        {"name": "ssd_fwd", "route": "cuda",
         "source": src + "ssd_fwd_sm90.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:29", "launches": None,
         **{k: v for k, v in serve.items() if k != "shape"},
         "shape": serve["shape"],
         "train_shape": dict(times["ssd_fwd", "training phase 1"],
                             launches=None),
         "bucket_shape": times["ssd_fwd", "bucket prefill, batch 1"],
         "zamba2_serve_shape": times["ssd_fwd", "zamba2 serve prefill"],
         "zamba2_train_shape": times["ssd_fwd", "zamba2 training phase 1"]},
        {"name": "ssd_bwd", "route": "cuda",
         "source": src + "ssd_bwd_sm90.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:61", "launches": None,
         **times["ssd_bwd", "training phase 1"],
         "zamba2_train_shape": times["ssd_bwd", "zamba2 training phase 1"]}]


# ---------------------------------------------------------------------------
# phase 4: full-width serve
# ---------------------------------------------------------------------------


def _describe(cfg) -> str:
    """The widths that decide the kernels' shapes, for a phase's first
    line."""
    if cfg.attention == "mla":
        m = cfg.mla
        attn = (f"MLA heads {cfg.n_heads} x qk {m.qk_nope_head_dim}+"
                f"{m.qk_rope_head_dim} (flash head dim "
                f"{m.qk_nope_head_dim + m.qk_rope_head_dim}), v "
                f"{m.v_head_dim}, latent {m.kv_lora_rank}")
    elif cfg.family == "ssm":
        attn = f"head dim {cfg.head_dim}"
    else:
        attn = f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}"
    if cfg.moe:
        attn += (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff "
                 f"{cfg.moe.d_ff}, capacity factor "
                 f"{cfg.moe.capacity_factor}")
    if cfg.mrope_sections:
        attn += (f", M-RoPE sections {'/'.join(map(str, cfg.mrope_sections))}"
                 f", {cfg.n_vision_tokens} stub vision tokens")
    if cfg.is_encoder_decoder:
        attn += (f"; encoder of {cfg.n_encoder_layers} layers over "
                 f"{cfg.encoder_seq} frames (non-causal), cross attention "
                 f"in every decoder layer")
    if cfg.family == "hybrid":
        s = cfg.ssm
        attn = (f"one shared block of {attn} before every "
                f"{cfg.shared_attn_every} mamba layers; SSD heads "
                f"{s.expand * cfg.d_model // s.head_dim}x{s.head_dim}, state "
                f"{s.d_state}, groups {s.n_groups}, chunk {s.chunk_size}")
    return attn


def _serve_profile(card, tag, label, step, tokens):
    """One torch.profiler window of ``step`` (after one untraced call):
    device ms by category (the flash forward, matmuls, dtype casts and
    other copies, everything else), the busy and idle share of the
    window."""
    import torch
    from repro_torch.launch import profile_train as prof
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as trace:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_cat, by_kernel = {}, {}
    for evt in trace.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = prof._time_us(evt, ("self_device_time_total",
                                 "self_cuda_time_total")) / 1e3
        cat = prof._category(evt.key)
        if cat == "other" and "copy" in evt.key:
            cat = "copy (casts)"
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + ms
    busy = sum(by_cat.values())
    cats = ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_cat.items()))
    top = "; ".join(f"{k[:90]} {v:.2f}" for k, v in sorted(
        by_kernel.items(), key=lambda kv: -kv[1])[:8])
    print(f"[{tag}] profile of one {label} ({tokens} tokens) on {card}: "
          f"window {window_ms:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {1 - busy / window_ms:.3f}; device ms by category: "
          f"{cats}; top kernels: {top}", flush=True)
    return window_ms, busy


@contextlib.contextmanager
def _fixed_routes(routes, replay: bool):
    """Within the block, ``moe.route`` appends each call's experts to
    ``routes`` or, with ``replay``, takes the experts of the recorded calls
    in their order and recomputes only their gates (renormalized over k)
    from this call's probs."""
    from repro_torch.models import moe
    real = moe.route
    calls = iter(routes)

    def route(params, x, cfg):
        probs, gates, idx = real(params, x, cfg)
        if not replay:
            routes.append(idx)
            return probs, gates, idx
        idx = next(calls)
        gates = probs.gather(-1, idx)
        return probs, gates / gates.sum(dim=-1, keepdim=True), idx

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def phase_serve(card: str, arch="internlm2-1.8b", S=512, engine=True,
                tag="serve", cfg=None, compiled=False):
    """``arch`` at full width (``cfg``: its full config, or one of it cut
    in depth) on the serving main path: generate's two
    engines at batch 8, prompt S, and with ``engine`` the ServingEngine's
    requests through 2 slots; then the prefill logits' checks, a profiler
    window of one prefill and one decode step, and the device memory peak
    of the phase (params included) against PEAK_LIMIT_GB. The flash
    forward launches once an attention block a prefill, every launch on the
    bf16 wgmma route; in the hybrid family (zamba2) that is once a pattern
    unit (its shared block), the SSD forward once a mamba layer (all on the
    bf16 route too), and the logits' checks switch both kernels; in the
    audio family (whisper) once an encoder layer and twice a decoder layer
    (self and cross attention), every prefill and model taking the same
    stub frames (batch, encoder_seq, d_model) made from the seed; in the
    vlm family (qwen2-vl) generate and every logits route take the same
    stub patch embeddings (batch, n_vision_tokens, d_model) from the seed,
    and the logits routes also image grid positions (``_grid_positions``)
    whose three M-RoPE components differ; the engine's requests are text.
    With ``compiled``, the compiled engine's full-width run follows on the
    same model and params (``_compiled_serve``), inside the phase's memory
    peak. Returns every kernel's launches on the main path (and under
    "compiled" the flash forward's on the compiled engine's)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or registry.get_config(arch)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    B, T = 8, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda")
    extras = ({"frames": torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                     generator=g, device="cuda")}
              if cfg.is_encoder_decoder else {})
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.randn(
            (B, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device="cuda")
    routes_extras = dict(extras)
    if cfg.mrope_sections:
        routes_extras["positions"] = _grid_positions(B, S,
                                                     cfg.n_vision_tokens)
    lengths, n_new, max_seq = ENGINE_PROMPTS, 16, 1024
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (L,), generator=g, device="cuda"),
        max_new_tokens=n_new) for i, L in enumerate(lengths)] if engine else []
    n_layers = cfg.n_layers
    hybrid = cfg.family == "hybrid"
    n_attn = (model.n_units if hybrid       # attention blocks
              else cfg.n_encoder_layers + 2 * n_layers
              if cfg.is_encoder_decoder else n_layers)
    windows = sorted({k.window for k in model.unit_kinds + model.tail_kinds})
    print(f"[{tag}] {cfg.name}: {n_layers} layers, d_model {cfg.d_model}, "
          f"{_describe(cfg)}, windows {windows}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B f32",
          flush=True)

    generate(model, params, prompts, 2, extras,
             engine="compiled")                              # warm-up
    # --- the main path, with the launch counts read around it ---
    _reset_launches()
    out_loop, st_loop = generate(model, params, prompts, T, extras,
                                 engine="loop")
    out_comp, st_comp = generate(model, params, prompts, T, extras,
                                 engine="compiled")
    if engine:
        serving = ServingEngine(model, params, max_batch=2, max_seq=max_seq)
        t0 = time.perf_counter()
        with torch.inference_mode():
            done = serving.run(reqs)
        torch.cuda.synchronize()
        t_engine = time.perf_counter() - t0
    counted = _launch_counts()
    launches = {name: fn.launches for name, fn in counted.items()}
    on_sm90 = {name: fn.launches_sm90 for name, fn in counted.items()
               if hasattr(fn, "launches_sm90")}
    # -------------------------------------------------------------

    check(out_loop.shape == (B, T) and torch.equal(out_loop, out_comp),
          f"{arch}: loop and compiled engines disagree at full width")
    check(bool(((out_loop >= 0) & (out_loop < cfg.vocab_size)).all()),
          f"{arch}: generated token ids out of range")
    for st in (st_loop, st_comp):
        print(f"[{tag}] generate engine={st['engine']} batch {B} prompt {S} "
              f"new {T} on {card}: prefill {st['prefill_s'] * 1e3:.2f} ms "
              f"({st['prefill_tokens_per_s']:.1f} prompt tok/s), decode "
              f"{st['decode_s'] * 1e3:.2f} ms "
              f"({st['decode_tokens_per_s']:.1f} tok/s)")
    for r in reqs:
        check(r.done and len(done[r.rid]) == n_new,
              f"engine request {r.rid} (prompt {r.prompt.shape[0]}) ended "
              f"with {len(done[r.rid])} of {n_new} tokens")
    n_prefills = 2 + len(reqs)
    if engine:
        print(f"[{tag}] ServingEngine: {len(reqs)} requests (prompts "
              f"{list(lengths)}) through 2 slots, max_seq {max_seq}: "
              f"{n_new} tokens each in {t_engine:.2f} s")
    fwd = launches["flash_attention_fwd"]
    print(f"[{tag}] flash_attention_fwd launches on the main path: "
          f"{fwd} for {n_prefills} prefills of {n_attn} attention blocks")
    # one launch an attention block a prefill (exactly, without the engine)
    check(fwd >= n_attn * n_prefills
          and (engine or fwd == n_attn * n_prefills),
          f"{arch}: kernel launched {fwd} times for {n_prefills} "
          f"prefills of {n_attn} attention blocks")
    check(on_sm90["flash_attention_fwd"] == fwd,
          f"{arch}: only {on_sm90['flash_attention_fwd']} of {fwd} flash "
          f"forwards on the serving path took the bf16 wgmma route")
    if hybrid:
        ssd = launches["ssd_fwd"]
        print(f"[{tag}] ssd_fwd launches on the main path: {ssd} for "
              f"{n_prefills} prefills of {n_layers} mamba layers; on the "
              f"bf16 wgmma route: flash_attention_fwd "
              f"{on_sm90['flash_attention_fwd']}, ssd_fwd "
              f"{on_sm90['ssd_fwd']}")
        check(ssd >= n_layers * n_prefills,
              f"{arch}: ssd_fwd launched {ssd} times, fewer than "
              f"{n_layers} a prefill")
        for name in ("flash_attention_fwd", "ssd_fwd"):
            check(on_sm90[name] == launches[name],
                  f"{arch}: only {on_sm90[name]} of {launches[name]} {name} "
                  f"launches on the serving path took the bf16 wgmma route")

    # prefill logits, kernel against the plain attention on the card. The
    # limit of 1e-2 is held in f32 compute, where the kernel is the only
    # difference. In bf16, 24 layers of bf16 rounding put any two paths that
    # are not bitwise equal ~1.4e-2 apart (the plain version and the naive
    # oracle too), so there the kernel is held to the f32 model instead: no
    # further from it than the plain version is, within 10%.
    # An MoE model's five prefills take the experts that the first (f32,
    # kernel) chose, token by token and layer by layer (``_fixed_routes``):
    # top-k routing is discrete, and at full width with random weights a
    # bf16 path routes many tokens elsewhere than the f32 model does (on
    # an H100, with free routing and no drops, the bf16 prefill logits of
    # deepseek-v2-lite and granite-moe came 0.35 to 1.09 relative L2 from
    # the f32 model's, the kernel's and the plain version's alike; at smoke
    # width, where capacity drops cascade, the JAX reference's own came
    # 0.86), so the check would weigh routing flips, not attention. With the routes fixed (and so the same tokens
    # dropped), the paths differ by rounding only.
    logits = {}
    routes = []
    for i, (dtype, impl) in enumerate((
            ("float32", "kernel"), ("float32", "reference"),
            ("float32", "naive"), ("bfloat16", "kernel"),
            ("bfloat16", "reference"))):
        # the hybrid family switches the SSD with the attention (the naive
        # oracle takes the plain SSD)
        ssd = ({"ssd_impl": "reference" if impl == "naive" else impl}
               if hybrid else {})
        m = Model(dataclasses.replace(cfg, dtype=dtype, attention_impl=impl,
                                      **ssd))
        with torch.inference_mode(), _fixed_routes(routes, replay=i > 0):
            logits[dtype, impl] = m.prefill(params, prompts,
                                            **routes_extras)[0].float()
    if cfg.moe:
        print(f"[{tag}] logits checks with the routes of the f32 kernel "
              f"prefill fixed: {len(routes)} MoE layers")

    def rel(a, b):
        return (torch.linalg.vector_norm(logits[a] - logits[b])
                / torch.linalg.vector_norm(logits[b])).item()

    truth = ("float32", "naive")
    r32 = rel(("float32", "kernel"), ("float32", "reference"))
    r16 = rel(("bfloat16", "kernel"), ("bfloat16", "reference"))
    e_k = rel(("bfloat16", "kernel"), truth)
    e_r = rel(("bfloat16", "reference"), truth)
    print(f"[{tag}] prefill logits, kernel vs plain attention: relative L2 "
          f"error {r32:.3e} in f32 (limit 1e-2), {r16:.3e} in bf16")
    print(f"[{tag}] bf16 prefill logits against the f32 model with naive "
          f"attention: kernel {e_k:.3e}, plain {e_r:.3e} (limit 1.1x plain); "
          f"f32 kernel {rel(('float32', 'kernel'), truth):.3e}", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          f"{arch}: non-finite prefill logits")
    check(r32 <= 1e-2, f"{arch}: f32 prefill logits differ: relative L2 "
                       f"{r32:.3e}")
    check(e_k <= 1.1 * e_r,
          f"{arch}: bf16 kernel prefill is further from the f32 model "
          f"({e_k:.3e}) than the plain version ({e_r:.3e})")
    del logits
    with torch.inference_mode():
        _serve_profile(card, tag, f"prefill of {B} x {S}",
                       lambda: model.prefill(params, prompts, **extras),
                       B * S)
        _, cache = model.prefill(params, prompts, cache_len=S + 1, **extras)
        tok = prompts[:, -1:]
        _serve_profile(card, tag, f"decode step at batch {B}",
                       lambda: model.decode(params, cache, tok, S), B)
        del cache
    if compiled:
        launches["compiled"] = _compiled_serve(card, model, params, tag)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] device memory peak of the phase: {peak:.2f} GB "
          f"(torch.cuda.max_memory_allocated, params included; limit "
          f"{PEAK_LIMIT_GB} GB)", flush=True)
    check(peak <= PEAK_LIMIT_GB, f"{arch}: serving memory peak {peak:.2f} "
                                 f"GB over {PEAK_LIMIT_GB} GB")
    del params
    torch.cuda.empty_cache()
    return launches


def _serve_requests(engine, reqs):
    """``engine.run(reqs)`` under inference mode, timed on the host clock
    to a synchronize: (tokens by rid, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = engine.run(reqs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _first_difference(a, b):
    """'equal', or the index of the first token where a and b differ."""
    if a == b:
        return "equal"
    return next((f"differ from token {i}" for i, (x, y) in enumerate(zip(
        a, b)) if x != y), f"lengths {len(a)} and {len(b)}")


def _compiled_serve(card, model, params, tag):
    """The compiled serving engine (``serve/compiled.py``) at full width,
    bf16, on ``model`` and ``params`` (internlm2-1.8b): COMPILED_PROMPTS
    through COMPILED_SLOTS slots, max_seq COMPILED_MAX_SEQ, K
    COMPILED_BLOCK, COMPILED_NEW tokens each, on the dense and the paged
    layout (K-step blocks replayed as one CUDA graph) and the dense one's
    K-step function run eagerly on the card; the per-step ServingEngine on
    the same requests; an engine with the paged int8 pool, built and not
    run (the f32 checks run the int8 layouts). Checks: bucket-length
    prompts token-exact against the ServingEngine on both bf16 layouts;
    the graph's tokens equal to the eager K-step function's for every
    request; one block read a decode call; one flash forward a layer an
    admission, all on the bf16 route; the int8 pool fewer bytes a token
    than the dense bf16 cache. Prints how far the padded prompts agree,
    each run's rate and a profiler window of one replay beside one
    ServingEngine step at the same batch. Returns the flash forward's
    launches on the dense graph's run."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.serve import (CompiledServingEngine, Request,
                                   ServingEngine, default_buckets)
    cfg = model.cfg
    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=g,
                             device="cuda") for L in COMPILED_PROMPTS]
    buckets = set(default_buckets(COMPILED_MAX_SEQ))
    B, K = COMPILED_SLOTS, COMPILED_BLOCK

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=COMPILED_NEW)
                for i, p in enumerate(prompts)]

    n_gen = len(prompts) * COMPILED_NEW
    oracle, t_oracle = _serve_requests(
        ServingEngine(model, params, max_batch=B, max_seq=COMPILED_MAX_SEQ),
        reqs())
    print(f"[{tag}] compiled engine, {len(prompts)} requests (prompts "
          f"{sorted(set(COMPILED_PROMPTS))}) through {B} slots, max_seq "
          f"{COMPILED_MAX_SEQ}, K {K}, {COMPILED_NEW} new tokens each; "
          f"ServingEngine: {t_oracle:.2f} s, {n_gen / t_oracle:.1f} tok/s",
          flush=True)
    runs, fwd_dense = {}, None
    for name, kw in (("dense", dict(kv_layout="dense")),
                     ("paged", dict(kv_layout="paged")),
                     ("dense eager", dict(kv_layout="dense",
                                          cuda_graph=False))):
        eng = CompiledServingEngine(model, params, max_batch=B,
                                    max_seq=COMPILED_MAX_SEQ,
                                    decode_block=K, **kw)
        t0 = time.perf_counter()
        eng.warmup()                 # a prefill a bucket; the capture
        t_warm = time.perf_counter() - t0
        _reset_launches()
        out, secs = _serve_requests(eng, reqs())
        fwd, fwd90 = kernel.flash_fwd.launches, kernel.flash_fwd.launches_sm90
        st = eng.stats
        check(eng.graphed == ("eager" not in name),
              f"compiled {name}: graphed is {eng.graphed}")
        check(st["decode_transfers"] == st["decode_calls"] > 0,
              f"compiled {name}: {st['decode_transfers']} block reads for "
              f"{st['decode_calls']} decode calls")
        check(fwd == cfg.n_layers * st["admissions"] and fwd90 == fwd,
              f"compiled {name}: {fwd} flash forwards ({fwd90} bf16 route) "
              f"for {st['admissions']} admissions of {cfg.n_layers} layers")
        check(all(len(out[i]) == COMPILED_NEW for i in out),
              f"compiled {name}: a request ended short")
        per_token = eng.cache_bytes() / (
            eng.n_pages * eng.page_size if eng.kv_layout == "paged"
            else B * COMPILED_MAX_SEQ)
        print(f"[{tag}] compiled {name}: {secs:.2f} s, {n_gen / secs:.1f} "
              f"tok/s (warmup and capture {t_warm:.2f} s); "
              f"{st['decode_calls']} decode calls, {st['decode_transfers']} "
              f"block reads, {st['admissions']} admissions, "
              f"{st['prefill_compiles']} buckets; flash forwards {fwd} "
              f"({fwd90} bf16 route); cache {eng.cache_bytes() / 1e9:.3f} "
              f"GB, {per_token / 1e3:.1f} KB a token", flush=True)
        runs[name] = (out, per_token)
        if name == "dense":
            fwd_dense = fwd
            graph_eng = eng
        else:
            del eng
        torch.cuda.empty_cache()
    for i, L in enumerate(COMPILED_PROMPTS):
        if L in buckets:
            for name in ("dense", "paged"):
                check(runs[name][0][i] == oracle[i],
                      f"compiled {name}: request {i} (bucket-length prompt "
                      f"{L}) differs from the ServingEngine: "
                      f"{_first_difference(runs[name][0][i], oracle[i])}")
        graph, eager = runs["dense"][0][i], runs["dense eager"][0][i]
        check(graph == eager,
              f"request {i} (prompt {L}): the graph's tokens differ from "
              f"the eager K-step function's: "
              f"{_first_difference(graph, eager)}")
    padded = {f"{i} (prompt {L})": _first_difference(runs["dense"][0][i],
                                                     oracle[i])
              for i, L in enumerate(COMPILED_PROMPTS) if L not in buckets}
    int8 = CompiledServingEngine(model, params, max_batch=B,
                                 max_seq=COMPILED_MAX_SEQ, decode_block=K,
                                 kv_layout="paged", kv_cache_dtype="int8")
    int8_token = int8.cache_bytes() / (int8.n_pages * int8.page_size)
    check(int8_token < runs["dense"][1]
          and int8.cache_bytes() < graph_eng.cache_bytes(),
          f"the int8 pool ({int8_token:.0f} B a token) is not below the "
          f"dense bf16 cache ({runs['dense'][1]:.0f} B a token)")
    del int8
    print(f"[{tag}] compiled: bucket-length prompts token-exact against the "
          f"ServingEngine (dense and paged bf16); the graph's tokens equal "
          f"the eager K-step function's for all {len(prompts)} requests; "
          f"padded prompts against the ServingEngine: {padded}; the paged "
          f"int8 pool {int8_token / 1e3:.1f} KB a token against the dense "
          f"bf16 cache's {runs['dense'][1] / 1e3:.1f}", flush=True)
    # one replay (K steps at batch B) beside one ServingEngine step at the
    # same batch, both with every slot decoding
    with torch.inference_mode():
        g_ms, g_busy = _serve_profile(
            card, tag, f"compiled decode block (graph replay, {K} steps) at "
            f"batch {B}", graph_eng._graphs[0].replay, B * K)
        serving = ServingEngine(model, params, max_batch=B,
                                max_seq=COMPILED_MAX_SEQ)
        for i in range(B):
            serving.submit(Request(rid=i, prompt=prompts[i],
                                   max_new_tokens=COMPILED_MAX_SEQ))
        s_ms, s_busy = _serve_profile(
            card, tag, f"ServingEngine step at batch {B}", serving.step, B)
    print(f"[{tag}] decode ms a generated token at batch {B}: compiled "
          f"graph {g_ms / (B * K):.4f} (idle {1 - g_busy / g_ms:.3f}), "
          f"ServingEngine {s_ms / B:.4f} (idle {1 - s_busy / s_ms:.3f}); "
          f"compiled phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del graph_eng, serving
    torch.cuda.empty_cache()
    return fwd_dense


def _perturbed(params, seed):
    """The generation ``seed`` publishes: each leaf of ``params`` times
    1 + PUBLISH_EPS * N(0, 1), from a generator seeded with ``seed``."""
    import torch
    from repro_torch.optim.api import tree_map
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda x: x * (1 + PUBLISH_EPS * torch.randn(
        x.shape, generator=g, device=x.device)), params)


def _bits(params) -> int:
    """A sum of every leaf's bit patterns (f32 leaves read as int32): any
    write into ``params`` moves it."""
    import torch
    return sum(int(x.view(torch.int32).sum(dtype=torch.int64))
               for x in _leaves(params))


def phase_publish(card: str):
    """Live weight publishing (``serve/compiled.py``'s ``publish``,
    ``serve/publish.py``'s ``WeightPublisher``) at internlm2-1.8b's full
    width, bf16 compute on f32 master weights, through the CUDA graphs: 8
    slots, max_seq COMPILED_MAX_SEQ, K COMPILED_BLOCK, the default layout
    (the paged pool), ``warmup(dual=True)``. The main path: PUBLISH_FIRST's
    8 requests on generation 0 and PUBLISH_QUEUE's 16 waiting; after the
    first step a ``WeightPublisher`` hook folds generation 1 (``_perturbed``
    seed 1) into its ``StreamingAverage`` and publishes it (applied at
    once); after the second step it folds seed 2 (the swa_avg kernel) and
    publishes the average as generation 2 while the long generation-0
    requests are in flight (deferred, applied as they drain). Checks:
    every request's tokens equal a single-generation graph engine's (same
    slots and K) on the weights it is pinned to, and the long
    generation-0 requests differ on generation 1's (the pinning matters);
    dual blocks ran; one block read a decode call; no capture after the
    warm-up (three: a graph a buffer and the dual one); the caller's
    generation-0 tensors unchanged (``_bits``) and sharing no storage with
    the engine's buffers; 24 bf16 flash forwards an admission and one
    swa_avg launch a leaf on the path; the peak under 75 GB. Prints the
    dual and the single replay's profiles (ms a generated token, idle
    share) and the publish's own ms. Returns the launches on the path."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    from repro_torch.models.model import Model
    from repro_torch.serve import (CompiledServingEngine, Request,
                                   WeightPublisher)
    from repro_torch.train.loop import init_train_state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config("internlm2-1.8b")
    model = Model(cfg)
    p0 = model.init(torch.Generator(device="cuda").manual_seed(0))
    bits0 = _bits(p0)
    n_leaves = len(list(_leaves(p0)))
    B, K, max_seq = COMPILED_SLOTS, COMPILED_BLOCK, COMPILED_MAX_SEQ
    g = torch.Generator(device="cuda").manual_seed(11)
    plan = PUBLISH_FIRST + PUBLISH_QUEUE
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=g,
                             device="cuda") for L, _ in plan]

    def reqs(ids, offset=0):
        return [Request(rid=offset + i, prompt=prompts[i],
                        max_new_tokens=plan[i][1]) for i in ids]

    eng = CompiledServingEngine(model, p0, max_batch=B, max_seq=max_seq,
                                decode_block=K)
    t0 = time.perf_counter()
    eng.warmup(dual=True)
    t_warm = time.perf_counter() - t0
    caps = eng._captures
    check(caps == 3 and eng.kv_layout == "paged",
          f"publish: warmup(dual=True) captured {caps} graphs on the "
          f"{eng.kv_layout} layout, not 3 on the paged one")
    pub = WeightPublisher([eng], ensemble=False)

    def epoch(seed, step):
        q = _perturbed(p0, seed)
        t0 = time.perf_counter()
        gen = pub.on_epoch(init_train_state({"params": q, "state": {}},
                                            opt_state={}, step=step), step)
        torch.cuda.synchronize()
        return gen, (time.perf_counter() - t0) * 1e3

    served = reqs(range(len(plan)))
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for r in served:
            eng.submit(r)
        eng.step()
        gen1, ms1 = epoch(1, 100)                  # buffer 1 is free
        applied1 = eng.generation
        eng.step()
        gen2, ms2 = epoch(2, 200)                  # buffer 0 is pinned
        deferred2 = eng.generation
        while eng.active or eng.waiting:
            eng.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, fwd90 = kernel.flash_fwd.launches, kernel.flash_fwd.launches_sm90
    swa = swa_kernel.running_average.launches
    st = dict(eng.stats)
    gens = [r.generation for r in served]
    n_gen = sum(len(r.generated) for r in served)
    print(f"[publish] internlm2-1.8b full width, bf16 on f32 weights, "
          f"{len(plan)} requests through {B} slots, max_seq {max_seq}, K "
          f"{K}, {eng.kv_layout} layout: {secs:.2f} s, {n_gen / secs:.1f} "
          f"tok/s (warmup(dual=True) {t_warm:.2f} s, {caps} captures); "
          f"generations {gens}; published {gen1} (applied: generation "
          f"{applied1}; on_epoch {ms1:.2f} ms) and {gen2} (generation "
          f"{deferred2} still served; on_epoch {ms2:.2f} ms); {st}; flash "
          f"forwards {fwd} ({fwd90} bf16 route), swa_avg {swa}", flush=True)
    check(gen1 == 1 and applied1 == 1,
          f"publish: generation 1 not applied at once ({gen1}, "
          f"{applied1})")
    check(gen2 == 2 and deferred2 == 1 and eng.generation == 2,
          f"publish: generation 2 not deferred then applied ({gen2}, "
          f"{deferred2}, {eng.generation})")
    check(set(gens) == {0, 1, 2} and all(r.done for r in served),
          f"publish: requests on generations {sorted(set(gens))}")
    check(st["dual_decode_calls"] > 0
          and st["decode_transfers"] == st["decode_calls"] > 0
          and st["publish_swaps"] == 2,
          f"publish: dual blocks, block reads or swaps off: {st}")
    check(fwd == cfg.n_layers * st["admissions"] and fwd90 == fwd,
          f"publish: {fwd} flash forwards ({fwd90} bf16 route) for "
          f"{st['admissions']} admissions of {cfg.n_layers} layers")
    check(swa == n_leaves, f"publish: {swa} swa_avg launches for the one "
                           f"fold of {n_leaves} leaves")
    launches = {"flash_attention_fwd": fwd, "swa_avg": swa}
    # the dual and the single block's replays, every slot decoding; then
    # the publish alone on the idle engine (a copy into the other buffer)
    with torch.inference_mode():
        d_ms, d_busy = _serve_profile(
            card, "publish", f"dual-generation decode block (graph replay, "
            f"{K} steps, two evaluations a step) at batch {B}",
            eng._graphs["dual"].replay, B * K)
        s_ms, s_busy = _serve_profile(
            card, "publish", f"single-generation decode block (graph "
            f"replay, {K} steps) at batch {B}",
            eng._graphs[eng._latest].replay, B * K)
        avg = pub.average.value()
        pub_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(eng.publish(avg) is True, "publish: an idle publish "
                                            "deferred")
            torch.cuda.synchronize()
            pub_ms.append((time.perf_counter() - t0) * 1e3)
    peak_pub = torch.cuda.max_memory_allocated() / 1e9
    print(f"[publish] decode ms a generated token at batch {B} on {card}: "
          f"dual block {d_ms / (B * K):.4f} (idle {1 - d_busy / d_ms:.3f}), "
          f"single block {s_ms / (B * K):.4f} (idle "
          f"{1 - s_busy / s_ms:.3f}); dual / single {d_ms / s_ms:.3f}; "
          f"publish (copy of {n_leaves} f32 leaves into the free buffer) "
          f"{', '.join(f'{t:.2f}' for t in pub_ms)} ms; peak so far "
          f"{peak_pub:.2f} GB", flush=True)
    check(eng._captures == caps,
          f"publish: {eng._captures - caps} captures after the warm-up")
    owned = {x.data_ptr() for buf in eng._buffers for x in _leaves(buf)}
    check(not owned & {x.data_ptr() for x in _leaves(p0)},
          "publish: an engine buffer shares storage with the caller's "
          "generation-0 tensors")
    # each generation's requests on a single-generation graph engine built
    # on its weights (generation 2's: the average as published); generation
    # 1's also runs the long generation-0 requests, which must come out
    # otherwise there
    weights = {0: p0, 1: _perturbed(p0, 1), 2: avg}
    del eng, pub, avg
    torch.cuda.empty_cache()
    longest = max(n for _, n in PUBLISH_FIRST)
    long0 = [i for i, (_, n) in enumerate(PUBLISH_FIRST) if n == longest]
    moved = 0
    for gen in (0, 1, 2):
        ids = [i for i, r in enumerate(served) if r.generation == gen]
        ref = CompiledServingEngine(model, weights[gen], max_batch=B,
                                    max_seq=max_seq, decode_block=K)
        ref.warmup()
        extra = reqs(long0, offset=1000) if gen == 1 else []
        with torch.inference_mode():
            out = ref.run(reqs(ids) + extra)
        for i in ids:
            check(out[i] == served[i].generated,
                  f"publish: request {i} (generation {gen}, prompt "
                  f"{plan[i][0]}) differs from the single-generation "
                  f"engine: {_first_difference(served[i].generated, out[i])}")
        moved += sum(out[r.rid] != served[r.rid - 1000].generated
                     for r in extra)
        del ref
        torch.cuda.empty_cache()
    check(moved > 0, "publish: generation 1 gives the long generation-0 "
                     "requests their own tokens: the check is blind")
    check(_bits(p0) == bits0, "publish: the caller's generation-0 tensors "
                              "changed")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[publish] every request equal to a single-generation graph "
          f"engine's on its pinned weights ({len(plan)} requests over "
          f"generations 0, 1, 2; {moved} of {len(long0)} long generation-0 "
          f"requests otherwise on generation 1); the caller's weights "
          f"unchanged; device memory peak {peak:.2f} GB (limit "
          f"{PEAK_LIMIT_GB}); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check(peak <= PEAK_LIMIT_GB, f"publish: memory peak {peak:.2f} GB over "
                                 f"{PEAK_LIMIT_GB} GB")
    del weights, p0
    torch.cuda.empty_cache()
    launches["train_and_serve"] = _train_and_serve()
    return launches


def _train_and_serve():
    """``experiments/train_and_serve.py`` at smoke width on the card (its
    defaults: SWAP phase 2 publishing at each epoch boundary into a graph
    engine serving between chunks); its end-of-run audit (every request
    against ``generate`` on its generation reloaded from the publish
    directory) is a hard check. Returns the launches of its run."""
    import tempfile
    from repro_torch.experiments import train_and_serve
    t0 = time.perf_counter()
    _reset_launches()
    with tempfile.TemporaryDirectory() as d:
        out = train_and_serve.main(["--device", "cuda", "--publish-dir", d])
    launches = {k: fn.launches for k, fn in _launch_counts().items()}
    st = out["engine"].stats
    done = [r for r in out["served"] if r.done]
    check(out["checked"] == len(done) == len(out["served"]) > 0
          and st["dual_decode_calls"] > 0 and out["engine"].graphed
          and out["engine"]._captures == 3,
          f"train_and_serve: {out['checked']} of {len(out['served'])} "
          f"requests audited, {st}, {out['engine']._captures} captures")
    print(f"[publish] experiments/train_and_serve.py (smoke width): "
          f"{out['checked']} requests audited over {out['publisher'].generation} "
          f"generations, {st['dual_decode_calls']} dual blocks, 3 captures; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def phase_mamba_serve(card: str):
    """mamba2-2.7b at full width (64 layers) on the serving main path;
    returns the SSD forward's launches on it."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.ssd import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    torch.cuda.empty_cache()
    cfg = registry.get_config(MAMBA)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    B, S, T = 8, 512, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda")
    lengths, n_new, max_seq = ENGINE_PROMPTS, 16, 1024
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (L,), generator=g, device="cuda"),
        max_new_tokens=n_new) for i, L in enumerate(lengths)]
    s = cfg.ssm
    print(f"[mamba-serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, SSD heads {s.expand * cfg.d_model // s.head_dim}x"
          f"{s.head_dim}, state {s.d_state}, groups {s.n_groups}, chunk "
          f"{s.chunk_size}, vocab {cfg.vocab_size}, {cfg.dtype}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B f32",
          flush=True)

    generate(model, params, prompts, 2, engine="compiled")   # warm-up
    # --- the main path, with the launch counts read around it ---
    _reset_launches()
    out_loop, st_loop = generate(model, params, prompts, T, engine="loop")
    out_comp, st_comp = generate(model, params, prompts, T,
                                 engine="compiled")
    engine = ServingEngine(model, params, max_batch=2, max_seq=max_seq)
    t0 = time.perf_counter()
    with torch.inference_mode():
        done = engine.run(reqs)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    launches = kernel.ssd_fwd.launches
    launches_sm90 = kernel.ssd_fwd.launches_sm90
    # -------------------------------------------------------------

    check(out_loop.shape == (B, T) and torch.equal(out_loop, out_comp),
          "mamba2: loop and compiled engines disagree at full width")
    check(bool(((out_loop >= 0) & (out_loop < cfg.vocab_size)).all()),
          "mamba2: generated token ids out of range")
    for st in (st_loop, st_comp):
        print(f"[mamba-serve] generate engine={st['engine']} batch {B} "
              f"prompt {S} new {T} on {card}: prefill "
              f"{st['prefill_s'] * 1e3:.2f} ms "
              f"({st['prefill_tokens_per_s']:.1f} prompt tok/s), decode "
              f"{st['decode_s'] * 1e3:.2f} ms "
              f"({st['decode_tokens_per_s']:.1f} tok/s)")
    for r in reqs:
        check(r.done and len(done[r.rid]) == n_new,
              f"mamba2 engine request {r.rid} (prompt {r.prompt.shape[0]}) "
              f"ended with {len(done[r.rid])} of {n_new} tokens")
    n_prefills = 2 + len(reqs)
    print(f"[mamba-serve] ServingEngine: {len(reqs)} requests (prompts "
          f"{list(lengths)}) through 2 slots: {n_new} tokens each in "
          f"{t_engine:.2f} s")
    print(f"[mamba-serve] ssd_fwd launches on the main path: {launches} for "
          f"{n_prefills} prefills of {cfg.n_layers} layers")
    check(launches >= cfg.n_layers * n_prefills,
          f"ssd_fwd launched {launches} times, fewer than {cfg.n_layers} per "
          f"prefill")
    print(f"[mamba-serve] of them on the bf16 wgmma route: {launches_sm90}")
    check(launches_sm90 == launches,
          f"only {launches_sm90} of {launches} ssd_fwd launches on the "
          f"full-width serving path took the bf16 wgmma route")

    # prefill logits, kernel against the plain SSD on the card: in f32,
    # where the kernel is the only difference (limit 1e-2 relative L2, as
    # for the dense path; the two sum in another order); in bf16, no
    # further from the f32 model with the plain SSD than the plain version
    # is, within 10% (as the dense path's check holds its kernel)
    logits = {}
    for dtype, impl in (("float32", "kernel"), ("float32", "reference"),
                        ("bfloat16", "kernel"), ("bfloat16", "reference")):
        m = Model(dataclasses.replace(cfg, dtype=dtype, ssd_impl=impl))
        with torch.inference_mode():
            logits[dtype, impl] = m.prefill(params, prompts)[0].float()

    def rel(a, b):
        return (torch.linalg.vector_norm(logits[a] - logits[b])
                / torch.linalg.vector_norm(logits[b])).item()

    truth = ("float32", "reference")
    r32 = rel(("float32", "kernel"), truth)
    r16 = rel(("bfloat16", "kernel"), ("bfloat16", "reference"))
    e_k = rel(("bfloat16", "kernel"), truth)
    e_r = rel(("bfloat16", "reference"), truth)
    print(f"[mamba-serve] prefill logits, kernel vs plain SSD: relative L2 "
          f"{r32:.3e} in f32 (limit 1e-2), {r16:.3e} in bf16; bf16 against "
          f"the f32 model: kernel {e_k:.3e}, plain {e_r:.3e} (limit 1.1x "
          f"plain)", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "mamba2: non-finite prefill logits")
    check(r32 <= 1e-2, f"mamba2 f32 prefill logits differ: {r32:.3e}")
    check(e_k <= 1.1 * e_r,
          f"mamba2 bf16 kernel prefill is further from the f32 model "
          f"({e_k:.3e}) than the plain version ({e_r:.3e})")
    del logits
    compiled = _compiled_mamba(card, model, params)
    del params
    torch.cuda.empty_cache()
    return launches, compiled


def _compiled_mamba(card, model, params):
    """mamba2-2.7b at full width through the compiled engine (dense SSM
    caches, the K-step block as a CUDA graph): prompts at bucket lengths,
    token-exact against the ServingEngine, and two padded to a bucket
    (their agreement reported); one SSD forward a layer an admission, all
    on the bf16 route. Returns the SSD forward's launches."""
    import torch
    from repro_torch.kernels.ssd import kernel
    from repro_torch.serve import (CompiledServingEngine, Request,
                                   ServingEngine, default_buckets)
    cfg = model.cfg
    t0 = time.perf_counter()
    lengths, n_new, slots = (64, 128, 256, 512, 100, 300), 16, 4
    g = torch.Generator(device="cuda").manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=g,
                             device="cuda") for L in lengths]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=n_new)
                for i, p in enumerate(prompts)]

    eng = CompiledServingEngine(model, params, max_batch=slots,
                                max_seq=COMPILED_MAX_SEQ, decode_block=8)
    eng.warmup()
    _reset_launches()
    got, secs = _serve_requests(eng, reqs())
    ssd, ssd90 = kernel.ssd_fwd.launches, kernel.ssd_fwd.launches_sm90
    st = eng.stats
    check(eng.graphed and eng.kv_layout == "dense",
          f"mamba2 compiled: graphed {eng.graphed}, layout {eng.kv_layout}")
    check(st["decode_transfers"] == st["decode_calls"] > 0,
          "mamba2 compiled: more block reads than decode calls")
    check(ssd == cfg.n_layers * st["admissions"] and ssd90 == ssd,
          f"mamba2 compiled: {ssd} SSD forwards ({ssd90} bf16 route) for "
          f"{st['admissions']} admissions of {cfg.n_layers} layers")
    del eng
    want, t_oracle = _serve_requests(
        ServingEngine(model, params, max_batch=slots,
                      max_seq=COMPILED_MAX_SEQ), reqs())
    buckets = set(default_buckets(COMPILED_MAX_SEQ))
    for i, L in enumerate(lengths):
        if L in buckets:
            check(got[i] == want[i],
                  f"mamba2 compiled: request {i} (bucket-length prompt {L}) "
                  f"differs from the ServingEngine: "
                  f"{_first_difference(got[i], want[i])}")
    padded = {f"{i} (prompt {L})": _first_difference(got[i], want[i])
              for i, L in enumerate(lengths) if L not in buckets}
    print(f"[mamba-serve] compiled engine, {len(lengths)} requests (prompts "
          f"{list(lengths)}) through {slots} slots, K 8, {n_new} new tokens "
          f"each on {card}: {secs:.2f} s against the ServingEngine's "
          f"{t_oracle:.2f} s; {st['decode_calls']} decode calls, "
          f"{st['decode_transfers']} block reads; ssd_fwd {ssd} launches "
          f"({ssd90} bf16 route) for {st['admissions']} admissions; "
          f"bucket-length prompts token-exact against the ServingEngine; "
          f"padded: {padded}; {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return ssd


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: smoke-width serving exactness
# ---------------------------------------------------------------------------


def phase_exact(arch="internlm2-1.8b", cfg=None, lengths=(9, 17, 5, 12, 8)):
    """ServingEngine against single-request generate on ``cfg`` (f32; the
    arch's smoke config by default), token for token."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    model = Model(cfg or registry.get_smoke_config(arch))        # f32
    g = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(g)
    prompts = [torch.randint(0, model.cfg.vocab_size, (L,), generator=g,
                             device="cuda") for L in lengths]
    engine = ServingEngine(model, params, max_batch=2, max_seq=64)
    with torch.inference_mode():
        got = engine.run([Request(rid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want, _ = generate(model, params, p[None], 6)
        check(got[i] == want[0].tolist(),
              f"smoke request {i}: engine {got[i]} != generate "
              f"{want[0].tolist()}")
    print(f"[exact] f32 {model.cfg.name} ({_describe(model.cfg)}): "
          f"ServingEngine tokens equal single-request generate for "
          f"{len(prompts)} requests (prompts {list(lengths)}) through 2 "
          f"slots")


def phase_compiled_exact():
    """The compiled engine's CPU-test scenarios on the card in f32 at smoke
    width, the K-step block replayed as a CUDA graph: compiled engine =
    ServingEngine = single-request generate for internlm2 and mamba2 (5
    requests, prompts 9/17/5/12/8, 2 slots, K 4); paged = dense for
    internlm2, gemma3 (head dim 256) and zamba2 (``_narrow_zamba``); paged
    int8 = dense int8 = the int8 ServingEngine; a 3-page pool that makes
    admissions wait for pages; an EOS inside a block with one slot reused
    by three requests; categorical sampling; and the families whose decode
    has its own ops, each against the ServingEngine: MLA
    (``_narrow_mla96``), MoE with MLA and with GQA (``_narrow_moe``, at
    bucket-length prompts: a padded prompt changes an MoE layer's
    capacity, in the reference too) and M-RoPE (``_narrow_vlm128``). Every
    graph run also equals the same engine's K-step function run eagerly
    on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve import CompiledServingEngine, Request, ServingEngine

    t0 = time.perf_counter()
    lengths, n_new = (9, 17, 5, 12, 8), 6
    cfgs = {"internlm2-1.8b": registry.get_smoke_config("internlm2-1.8b"),
            MAMBA: registry.get_smoke_config(MAMBA),
            GEMMA: dataclasses.replace(registry.get_smoke_config(GEMMA),
                                       head_dim=256),
            ZAMBA: _narrow_zamba(), MINICPM: _narrow_mla96(),
            DEEPSEEK: _narrow_moe(DEEPSEEK), GRANITE: _narrow_moe(GRANITE),
            QWEN_VL: _narrow_vlm128()}
    params_of = {}

    def setup(arch, **over):
        """(f32 model with ``over``, the arch's params, made once)."""
        if arch not in params_of:
            g = torch.Generator(device="cuda").manual_seed(1)
            params_of[arch] = Model(cfgs[arch]).init(g)
        return (Model(dataclasses.replace(cfgs[arch], **over)),
                params_of[arch])

    def prompts(arch, lens=lengths, seed=2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randint(0, cfgs[arch].vocab_size, (L,), generator=g,
                              device="cuda") for L in lens]

    def reqs(ps, n=n_new, eos=None):
        return [Request(rid=i, prompt=p, max_new_tokens=n,
                        eos_id=None if eos is None else eos[i])
                for i, p in enumerate(ps)]

    def compiled(arch, ps, *, over=None, n=n_new, eos=None, **kw):
        """Tokens of the graph run, after checking them against the eager
        run of the same engine; and the graph engine."""
        model, params = setup(arch, **(over or {}))
        outs = []
        for graph in (True, False):
            kw2 = dict(max_batch=2, max_seq=64, decode_block=4)
            kw2.update(kw)
            eng = CompiledServingEngine(model, params, cuda_graph=graph,
                                        **kw2)
            with torch.inference_mode():
                outs.append((eng.run(reqs(ps, n, eos)), eng))
            st = eng.stats
            check(eng.graphed == graph and st["decode_transfers"]
                  == st["decode_calls"],
                  f"compiled {arch} {kw}: graphed {eng.graphed}, "
                  f"{st['decode_transfers']} block reads for "
                  f"{st['decode_calls']} decode calls")
        check(outs[0][0] == outs[1][0],
              f"compiled {arch} {kw}: graph {outs[0][0]} != eager "
              f"{outs[1][0]}")
        return outs[0]

    def oracle(arch, ps, *, over=None, n=n_new, eos=None, **kw):
        model, params = setup(arch, **(over or {}))
        with torch.inference_mode():
            return ServingEngine(model, params, **kw).run(reqs(ps, n, eos))

    for arch in ("internlm2-1.8b", MAMBA):
        ps = prompts(arch)
        got, _ = compiled(arch, ps)
        check(got == oracle(arch, ps, max_batch=2, max_seq=64),
              f"compiled {arch}: differs from the ServingEngine")
        model, params = setup(arch)
        for i, p in enumerate(ps):
            want, _ = generate(model, params, p[None], n_new)
            check(got[i] == want[0].tolist(),
                  f"compiled {arch}: request {i} differs from generate")
    for arch in ("internlm2-1.8b", GEMMA, ZAMBA):
        ps = prompts(arch)
        paged, eng = compiled(arch, ps, kv_layout="paged", page_size=16)
        dense, _ = compiled(arch, ps, kv_layout="dense")
        check(eng.kv_layout == "paged" and paged == dense,
              f"compiled {arch}: paged {paged} != dense {dense}")
    ps = prompts("internlm2-1.8b", (9, 14, 6), seed=3)
    p8, _ = compiled("internlm2-1.8b", ps, kv_layout="paged",
                     kv_cache_dtype="int8")
    d8, _ = compiled("internlm2-1.8b", ps, kv_layout="dense",
                     kv_cache_dtype="int8")
    o8 = oracle("internlm2-1.8b", ps, over={"kv_cache_dtype": "int8"},
                max_batch=2, max_seq=64)
    check(p8 == d8 == o8, "compiled int8: paged, dense and the ServingEngine "
                          "differ")
    ps = prompts("internlm2-1.8b")
    tiny, eng = compiled("internlm2-1.8b", ps, kv_layout="paged",
                         page_size=16, n_pages=3)
    waits = eng.stats["admit_page_waits"]
    check(waits > 0 and tiny == oracle("internlm2-1.8b", ps, max_batch=2,
                                       max_seq=64)
          and len(eng._free_pages) == 2,
          f"compiled 3-page pool: {waits} page waits, tokens or pages off")
    # an EOS inside the first block of request 0, three requests through
    # one slot
    ps = prompts("internlm2-1.8b", (8, 10, 7), seed=5)
    model, params = setup("internlm2-1.8b")
    ref, _ = generate(model, params, ps[0][None], 6)
    ref = ref[0].tolist()
    stop = next(j for j in range(1, len(ref)) if ref[j] not in ref[:j])
    eos = [ref[stop], None, None]
    got, _ = compiled("internlm2-1.8b", ps, n=10, eos=eos, max_batch=1,
                      max_seq=32)
    want = oracle("internlm2-1.8b", ps, n=10, eos=eos, max_batch=1,
                  max_seq=32)
    check(got == want and got[0] == ref[:stop + 1],
          f"compiled EOS mid-block with slot reuse: {got} != {want}")
    # the decodes with their own ops: MLA's absorbed latent attention, the
    # MoE dispatch, M-RoPE positions
    for arch, lens in ((MINICPM, lengths), (DEEPSEEK, (16, 32, 16, 32, 16)),
                       (GRANITE, (16, 32, 16, 32, 16)), (QWEN_VL, lengths)):
        ps = prompts(arch, lens)
        got, eng = compiled(arch, ps)
        check(got == oracle(arch, ps, max_batch=2, max_seq=64),
              f"compiled {arch} ({eng.kv_layout}): differs from the "
              f"ServingEngine")
    # categorical sampling in the graph: the key split and the Gumbel noise
    # on the card, graph against eager from the same key
    samples, _ = compiled("internlm2-1.8b", prompts("internlm2-1.8b"),
                          sample="categorical", temperature=0.8)
    # a publish mid-decode through the graphs: A on generation 0 is
    # mid-decode when generation 1 lands, B is admitted after it
    for arch in ("internlm2-1.8b", MAMBA, GEMMA, ZAMBA):
        model, p0 = setup(arch)
        p1 = model.init(torch.Generator(device="cuda").manual_seed(3))
        pa, pb = prompts(arch, (9, 7))
        eng = CompiledServingEngine(model, p0, max_batch=2, max_seq=64,
                                    decode_block=4)
        eng.warmup(dual=True)
        a, b = (Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate((pa, pb)))
        with torch.inference_mode():
            eng.submit(a)
            eng.step()
            swapped = eng.publish(p1)
            eng.submit(b)
            while eng.active or eng.waiting:
                eng.step()
        want = {(p, k): generate(model, w, p[None], 12)[0][0].tolist()
                for p in (pa, pb) for k, w in enumerate((p0, p1))}
        st = eng.stats
        check(swapped is True and (a.generation, b.generation) == (0, 1)
              and a.generated == want[pa, 0] != want[pa, 1]
              and b.generated == want[pb, 1],
              f"compiled {arch}: a mid-decode publish through the graph "
              f"gave A {a.generated} (generation 0 {want[pa, 0]}), B "
              f"{b.generated} (generation 1 {want[pb, 1]})")
        check(st["dual_decode_calls"] > 0 and eng._captures == 3
              and st["decode_transfers"] == st["decode_calls"],
              f"compiled {arch} publish: {st}, {eng._captures} captures")
    print(f"[exact] compiled engine (K-step block as one CUDA graph), f32 "
          f"smoke: equal to the ServingEngine and generate (internlm2, "
          f"mamba2), paged = dense (internlm2, gemma3 at head dim 256, "
          f"zamba2 at 112), equal to the ServingEngine (minicpm3's MLA, "
          f"deepseek's and granite's MoE, qwen2-vl's M-RoPE), paged int8 = "
          f"dense int8 = the int8 "
          f"ServingEngine, a 3-page pool ({waits} page waits), an EOS "
          f"inside a block with one slot reused, categorical sampling "
          f"({sum(len(v) for v in samples.values())} tokens); every graph "
          f"run equal to its eager K-step run; a publish mid-decode through "
          f"the dual graph (internlm2, mamba2, gemma3, zamba2), each request "
          f"equal to generate on its generation; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5: SWAP training at full width
# ---------------------------------------------------------------------------


def _rel_l2(a_tree, b_tree) -> float:
    import torch
    num = den = 0.0
    for a, b in zip(_leaves(a_tree), _leaves(b_tree)):
        num += torch.linalg.vector_norm((a.float() - b.float())).item() ** 2
        den += torch.linalg.vector_norm(b.float()).item() ** 2
    return (num / den) ** 0.5


def _launch_counts():
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    return {"flash_attention_fwd": kernel.flash_fwd,
            "flash_attention_bwd_dq": kernel.flash_bwd_dq,
            "flash_attention_bwd_dkv": kernel.flash_bwd_dkv,
            "flash_attention_bwd_delta": kernel.flash_bwd_delta,
            "flash_attention_bwd_dqkv": kernel.flash_bwd_dqkv,
            "swa_avg": swa_kernel.running_average,
            "ssd_fwd": ssd_kernel.ssd_fwd,
            "ssd_bwd": ssd_kernel.ssd_bwd}


def _reset_launches():
    """Every kernel wrapper's launch counts to 0 (all routes, and the SSD
    wrappers' bf16 route alone)."""
    for fn in _launch_counts().values():
        fn.launches = 0
        if hasattr(fn, "launches_sm90"):
            fn.launches_sm90 = 0


DENSE_TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv", "flash_attention_bwd_delta",
                       "swa_avg")
# gemma3-1b's and deepseek-v2-lite's training paths: their backwards (D 256
# and D 192 at G 1, S 64) run delta and the dQ/dK/dV kernel, and the dQ and
# dK/dV kernels not at all
FUSED_TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_delta",
                       "flash_attention_bwd_dqkv", "swa_avg")
MAMBA_TRAIN_KERNELS = ("ssd_fwd", "ssd_bwd", "swa_avg")


def _blocks(model) -> Dict[str, Tuple[int, int]]:
    """The blocks of a forward that run the flash kernels (attention) and
    the SSD kernels (mamba), each (all of them, those inside a
    rematerialized pattern unit): in the hybrid family the shared
    attention block runs once in each unit, and no tail layer is
    rematerialized."""
    cfg = model.cfg
    in_units = model.n_units * len(model.unit_kinds) if cfg.remat else 0
    if cfg.family == "hybrid":
        return {"flash": (model.n_units, model.n_units if cfg.remat else 0),
                "ssd": (cfg.n_layers, in_units)}
    if cfg.family == "ssm":
        return {"ssd": (cfg.n_layers, in_units)}
    return {"flash": (cfg.n_layers, in_units)}


def phase_train(card: str, argv=TRAIN_ARGV, cfg=None,
                required=DENSE_TRAIN_KERNELS, tag="train", sm90_only=(),
                fused_bwd=False, on_result=None):
    """The launcher's own run (``train.main(argv, cfg=cfg)``) as a main
    path (``on_result``, if given, is called with its results dict before
    it is dropped): every kernel in ``required`` must launch in it, every
    launch of a
    kernel in ``sm90_only`` must take its bf16 wgmma route, and where the
    flash or SSD kernels are required they must launch as the layer plan
    has them (``_blocks``): a (worker) step runs 1 forward and its backward
    (the flash delta with dQ and dK/dV, or with ``fused_bwd`` delta and the
    dQ/dK/dV kernel and no dQ or dK/dV; or the SSD backward) a block, and
    a second forward in each block of a rematerialized pattern unit; an
    eval batch 1 forward a block. Every phase's memory peak must stay under
    PEAK_LIMIT_GB."""
    import math
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.averaging import average_stacked
    from repro_torch.launch import train
    from repro_torch.models.model import Model

    torch.cuda.empty_cache()
    cut = f" (cfg: {cfg.n_layers} layers)" if cfg is not None else ""
    print(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}{cut}",
          flush=True)
    # --- the main path, with every launch count read around it ---
    _reset_launches()
    res = train.main(argv, cfg=cfg)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _launch_counts().items()}
    on_sm90 = {name: fn.launches_sm90 for name, fn in _launch_counts().items()
               if name in sm90_only}
    # -------------------------------------------------------------
    print(f"[{tag}] launches on the training path: {launches}")
    for name in required:
        check(launches[name] > 0,
              f"{name} was not launched on the {tag} path")
    if sm90_only:
        print(f"[{tag}] of them on the bf16 wgmma route: {on_sm90}")
    for name, n in on_sm90.items():
        check(n == launches[name],
              f"only {n} of {launches[name]} {name} launches on the {tag} "
              f"path took the bf16 wgmma route")
    values = ([e[k] for e in res["phase1_log"] for k in ("loss", "accuracy")]
              + res["worker_test_accs"]
              + [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                                  "after_avg_test_acc", "phase1_train_acc")])
    check(all(math.isfinite(x) for x in values),
          f"non-finite loss or accuracy: {values}")
    check(res["phase2_live_workers"] == 2, "elastic phase 3 dropped a worker")
    args = train.build_parser().parse_args(argv)
    p1, p2, W = res["phase1_steps"], res["phase2_steps"], args.workers
    mcfg = cfg or (registry.get_config(args.arch) if args.full
                   else registry.get_smoke_config(args.arch))
    steps = p1 + W * p2
    for family, (n, remat) in _blocks(Model(mcfg)).items():
        names = FLASH_KERNELS if family == "flash" else ("ssd_fwd", "ssd_bwd")
        if names[0] not in required:
            continue
        per_step = n + remat
        fwd = launches[names[0]]
        # the backward's launches a block: the flash route's kernels once
        # (delta, then dQ and dK/dV or the dQ/dK/dV kernel), the others 0
        route = (("flash_attention_bwd_dqkv",) if fused_bwd else
                 ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
        bwd = {k: n if family == "ssd" or k in route
               or k.endswith("delta") else 0 for k in names[1:]}
        evals, rem = divmod(fwd - per_step * steps, n)
        print(f"[{tag}] {family} launches a (worker) step over {steps} "
              f"steps: forward {per_step}, "
              + ", ".join(f"{k} {launches[k] / steps:g}" for k in bwd)
              + f"; and {evals} eval forwards of {n} blocks")
        check(all(launches[k] == b * steps for k, b in bwd.items())
              and evals >= 0 and rem == 0,
              f"{family} launches {fwd}/"
              f"{ {k: launches[k] for k in bwd} } on the {tag} path are not "
              f"{per_step}/{bwd} a step of {steps}, with whole eval forwards")
    rel = _rel_l2(res["final_bundle"]["params"],
                  average_stacked(res["stacked_params"]))
    print(f"[{tag}] elastic average (swa_avg kernel) against the plain mean "
          f"of the same phase-2 models: relative L2 {rel:.3e} (limit 1e-6)")
    check(rel <= 1e-6, f"elastic average differs from the plain mean: {rel}")
    st = res["device"]
    b1, b2, L = args.phase1_batch, args.phase2_batch, args.seq_len
    tok1 = p1 * b1 * L / st["phase1_train_s"]
    tok2 = p2 * W * b2 * L / st["phase2_train_s"]
    print(f"[{tag}] on {card}: phase 1 {p1} steps of {b1}x{L} tokens, "
          f"{st['phase1_train_s'] / p1 * 1e3:.1f} ms/step ({tok1:.0f} tok/s); "
          f"phase 2 {p2} steps of {W} workers x {b2}x{L} tokens, "
          f"{st['phase2_train_s'] / p2 * 1e3:.1f} ms/step ({tok2:.0f} tok/s); "
          f"phase 3 {res['phase3_time'] * 1e3:.1f} ms")
    peaks = [st[f"phase{i}_peak_gb"] for i in (1, 2, 3)]
    print(f"[{tag}] memory peak: phase 1 {peaks[0]:.2f} GB, phase 2 "
          f"{peaks[1]:.2f} GB, phase 3 {peaks[2]:.2f} GB "
          f"(torch.cuda.max_memory_allocated; limit {PEAK_LIMIT_GB} GB)",
          flush=True)
    check(max(peaks) <= PEAK_LIMIT_GB,
          f"a phase of the {tag} run peaked at {max(peaks):.2f} GB, over "
          f"{PEAK_LIMIT_GB} GB")
    if on_result is not None:
        on_result(res)
    del res
    torch.cuda.empty_cache()
    return launches


def _digests(tree):
    """Per-leaf digests of a parameter tree's bits, on the card: each f32
    leaf's words as int64, their sum and a position-weighted sum. Integer
    sums are exact (wrapping) whatever the reduction order, so equal bits
    give equal digests, and a change of any word changes the first."""
    import torch
    out = []
    for leaf in _leaves(tree):
        words = leaf.detach().reshape(-1).view(torch.int32).to(torch.int64)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out.append((int(words.sum()), int((words * weight).sum())))
        del words, weight
    return out


def _train_digests(res, worker: int):
    """What ``[supervise]`` holds bitwise against a run of TRAIN_ARGV: the
    phase-1 params and worker ``worker``'s phase-2 params."""
    from repro_torch.optim.api import tree_map
    return {"phase1": _digests(res["phase1_bundle"]["params"]),
            "worker": _digests(tree_map(lambda a: a[worker],
                                        res["stacked_params"]))}


def phase_supervise(card: str, trained) -> Dict[str, int]:
    """Supervised SWAP at internlm2-1.8b's full width, built by the
    launcher's own code (its parser, ``train.resilience``, ``train.build``)
    from SUPERVISE_ARGV and a heartbeat directory, with a phase-2 chunk
    filter, ``FaultPlan().nan_at_step(SUPERVISE_NAN_STEP)``. Worker 0 never
    beats; with no checkpoint directory every restore comes from the
    supervisor's host copy of the phase's initial state. The run must make
    one divergence recovery (the NaN chunk, both workers replayed) and then
    one worker_lost [0] (found by the liveness hook after the replayed
    chunk), and end with worker 1 alone; its phase-1 params and worker 1's
    phase-2 params must equal those of ``[train]`` (``trained``: its
    ``_train_digests`` for worker 1) bitwise, the elastic average must
    agree with the plain mean, the flash kernels must launch as the layer
    plan has them for the three phase-2 attempts (W, W and W - 1 workers),
    all on the bf16 route, and swa_avg once a leaf a fold past the first
    (none for one survivor: the first model into the average is copied);
    every peak under PEAK_LIMIT_GB. Returns the launches."""
    import tempfile
    import torch
    from repro_torch.core.averaging import average_stacked
    from repro_torch.dist.config import DistConfig
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_map
    from repro_torch.testing.faults import FaultPlan

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as hb:
        argv = SUPERVISE_ARGV + ["--heartbeat-dir", hb]
        print(f"[supervise] python -m repro_torch.launch.train "
              f"{' '.join(argv)}, phase-2 chunk filter FaultPlan()."
              f"nan_at_step({SUPERVISE_NAN_STEP})", flush=True)
        args = train.build_parser().parse_args(argv)
        wiring = train.resilience(args, DistConfig.from_args(
            args, n_workers_default=train.N_WORKERS_DEFAULT))
        swap = train.build(args, supervisor=wiring.supervisor)
        plan = FaultPlan().nan_at_step(SUPERVISE_NAN_STEP)
        # --- the main path, with every launch count read around it ---
        _reset_launches()
        res = swap.run(
            torch.Generator(device=args.device).manual_seed(args.seed),
            worker_arrivals=wiring.worker_arrivals,
            phase2_hooks=wiring.phase2_hooks, heartbeats=wiring.monitor,
            phase2_chunk_filter=plan.chunk_filter)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in _launch_counts().items()}
        on_sm90 = {n: fn.launches_sm90 for n, fn in _launch_counts().items()
                   if n in FLASH_PAIR_KERNELS}
        # -------------------------------------------------------------
    events = res["recovery_events"]
    for ev in events:
        print(f"[supervise] recovery: {ev['kind']} in {ev['tag']} (attempt "
              f"{ev['attempt']}, lost {ev['lost_workers']}) -> resumed from "
              f"{ev['restored_from']} at step {ev['restored_step']}")
    check([(e["kind"], e["attempt"], e["tag"], e["restored_step"],
            e["restored_from"], e["lost_workers"]) for e in events] ==
          [("divergence", 1, "phase2", 0, "initial state", []),
           ("worker_lost", 2, "phase2", 0, "initial state", [0])],
          f"[supervise] recovery events are not one divergence, then one "
          f"worker_lost [0]: {events}")
    W, p1, p2 = args.workers, res["phase1_steps"], res["phase2_steps"]
    print(f"[supervise] phase2_worker_ids {res['phase2_worker_ids']}, live "
          f"mask {res['worker_live_mask']}, "
          f"{res['phase2_live_workers']} live, phase-2 steps {p2}")
    check(res["phase2_worker_ids"] == [1]
          and res["worker_live_mask"] == [False, True]
          and res["phase2_live_workers"] == 1 and p2 == args.phase2_steps,
          "[supervise] the run did not end with worker 1 alone at its "
          "phase-2 step target")
    got = _train_digests(res, 0)
    same = {k: got[k] == trained[k] for k in got}
    print(f"[supervise] bitwise against [train] (per-leaf digests): phase-1 "
          f"params {same['phase1']}, worker 1's phase-2 params "
          f"{same['worker']}")
    check(all(same.values()), f"[supervise] not bitwise equal to [train]: "
          f"{same}")
    rel = _rel_l2(res["final_bundle"]["params"],
                  average_stacked(res["stacked_params"]))
    print(f"[supervise] elastic average of the survivor against the plain "
          f"mean: relative L2 {rel:.3e} (limit 1e-6)")
    check(rel <= 1e-6, f"[supervise] elastic average differs: {rel}")
    # the layer plan (``_blocks``): a (worker) step runs each layer's
    # forward (twice in a rematerialized one) and its backward once; the
    # phase-2 attempts ran W, W and W - 1 workers p2 steps each
    n, remat = _blocks(Model(swap.adapter.cfg))["flash"]
    steps = p1 + p2 * (W + W + W - 1)
    evals, rem = divmod(launches["flash_attention_fwd"]
                        - (n + remat) * steps, n)
    n_leaves = len(list(_leaves(res["final_bundle"]["params"])))
    print(f"[supervise] launches on the supervised path: {launches}; on the "
          f"bf16 wgmma route: {on_sm90}; {steps} (worker) steps, {evals} eval "
          f"forwards of {n} layers")
    check(all(launches[k] == n * steps for k in FLASH_PAIR_KERNELS[1:])
          and evals >= 0 and rem == 0,
          f"[supervise] flash launches {launches} are not the plan's "
          f"{n + remat} forwards and {n} backwards a step of {steps}, with "
          f"whole eval forwards")
    check(all(on_sm90[k] == launches[k] > 0 for k in on_sm90),
          f"[supervise] flash launches off the bf16 route: {on_sm90}")
    check(launches["swa_avg"] == n_leaves * (res["phase2_live_workers"] - 1),
          f"[supervise] swa_avg launched {launches['swa_avg']} times, not "
          f"{n_leaves} a fold past the first")
    timing = {t["tag"]: t for t in wiring.supervisor.timings}
    for tag, t in timing.items():
        print(f"[supervise] on {card}: {tag} host copy of the initial state "
              f"{t['host_copy_bytes'] / 1e9:.2f} GB in "
              f"{t['host_copy_s']:.2f} s; restores "
              f"{[round(r, 3) for r in t['restore_s']]} s")
    st = res["device"]
    peaks = [st[f"phase{i}_peak_gb"] for i in (1, 2, 3)]
    print(f"[supervise] memory peak: phase 1 {peaks[0]:.2f} GB, phase 2 "
          f"{peaks[1]:.2f} GB, phase 3 {peaks[2]:.2f} GB (limit "
          f"{PEAK_LIMIT_GB} GB); SWAP total_time {res['total_time']:.1f} s",
          flush=True)
    check(max(peaks) <= PEAK_LIMIT_GB,
          f"[supervise] a phase peaked at {max(peaks):.2f} GB")
    del res, swap, wiring
    torch.cuda.empty_cache()
    print(f"[supervise] phase time on {card}: {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    return launches


def _dist_argv(port: int, rank: int):
    return DIST_ARGV + ["--coordinator", f"127.0.0.1:{port}",
                        "--process-id", str(rank)]


def _dist_cfg(layers: int):
    """internlm2-1.8b at full width, at ``layers`` of its layers."""
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config("internlm2-1.8b"),
                               n_layers=layers)


def _allocator_settings(settings: str) -> None:
    """Set this process's CUDA caching allocator options
    (``PYTORCH_CUDA_ALLOC_CONF``'s syntax) from here on."""
    import torch
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(settings)


@contextlib.contextmanager
def _dist_plant(plant: bool):
    """With ``plant``, a data-parallel fault that keeps the ranks equal:
    every rank reads shard 0 of each phase-1 batch, so that phase 1's
    mean covers half the batch on both ranks and only the bound on phase
    1 against one process can see it. Without, nothing."""
    from repro_torch.dist.config import DistConfig
    if not plant:
        yield
        return
    honest = DistConfig.data_shard
    DistConfig.data_shard = property(
        lambda d: (0, d.num_processes) if d.multihost else None)
    try:
        yield
    finally:
        DistConfig.data_shard = honest


def _dist_rank(port: str, layers: str, plant: str = "0") -> dict:
    """Rank 1 of ``[dist]`` (a child process, its caching allocator on
    expandable segments): the launcher's run, the launches it made, the
    digests of its phase-1 params, of its worker and of the average, its
    peaks and its collectives."""
    import torch
    from repro_torch.launch import train
    _reset_launches()
    with _dist_plant(plant == "1"):
        res = train.main(_dist_argv(int(port), 1),
                         cfg=_dist_cfg(int(layers)))
    torch.cuda.synchronize()
    return dict(_dist_record(res),
                launches={n: fn.launches
                          for n, fn in _launch_counts().items()},
                on_sm90={n: fn.launches_sm90 for n, fn in
                         _launch_counts().items() if n in FLASH_PAIR_KERNELS})


def _dist_record(res) -> dict:
    from repro_torch.optim.api import tree_map
    return {"phase1": _digests(res["phase1_bundle"]["params"]),
            "workers": res["local_worker_ids"],
            "local": [_digests(tree_map(lambda a: a[i],
                                        res["stacked_params"]))
                      for i in range(len(res["local_worker_ids"]))],
            "average": _digests(res["final_bundle"]["params"]),
            "peaks": [res["device"][f"phase{i}_peak_gb"] for i in (1, 2, 3)],
            "records": [list(r) for r in res["collectives"]],
            "accs": res["worker_test_accs"],
            "mask": res["worker_live_mask"],
            "times": {k: res[k] for k in ("phase1_time", "phase2_time",
                                          "phase3_time", "total_time")},
            "p1": res["phase1_steps"], "p2": res["phase2_steps"]}


def phase_dist(card: str, layers: int = DIST_LAYERS,
               plant: bool = False) -> Dict[str, Dict[str, int]]:
    """SWAP across two processes on the one card (``[dist]``): the
    launcher (``train.main``) with DIST_ARGV (DIST_TRAIN_ARGV on the
    worker:2 layout), this process rank 0 and a
    child rank 1 (``--phase-child dist-rank``), gloo over loopback
    (NCCL refuses two ranks on one card), internlm2-1.8b at full width
    (``_dist_cfg``). Prints each rank's peaks and their sum, the gloo
    transfer rates and the phase's time. Holds: both ranks' phase-1 params
    equal, and within DIST_PHASE1_RTOL (relative L2) of the single-process
    launcher's phase 1 (DIST_TRAIN_ARGV at DIST_LAYERS), run here after
    the ranks end (a data-parallel mean is not bitwise); each rank's worker
    and both ranks' averages bitwise those of the single-process port's
    phase 2 and elastic fold from rank 0's phase-1 params, also run here;
    the average within 1e-6 of the plain mean; no phase-2 collective
    across the worker blocks and one phase-3 broadcast a leaf a worker
    (the recorder); every kernel of the path launched on each rank, the
    flash kernels as the layer plan has them on the bf16 route, swa_avg
    once a leaf (the second worker's fold); the sum of the two ranks'
    peaks under PEAK_LIMIT_GB. Both ranks' caching allocators run on
    expandable segments (this process's only for the phase): two
    processes share the card, and memory that one holds reserved but
    unused is lost to the other. ``layers``: internlm2's depth (its 24
    layers, or a cut). ``plant``: both ranks read shard 0 of phase 1's
    batches (``_dist_plant``), and the check on phase 1 is that the bound
    catches it. Returns each rank's launches."""
    import socket
    import torch
    from repro_torch.core.averaging import average_stacked
    from repro_torch.dist.sharding import (CollectiveRecord,
                                           assert_no_cross_worker_collectives,
                                           collective_bytes)
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_map
    from repro_torch.train.loop import run_phase

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cfg = _dist_cfg(layers)
    free, total = torch.cuda.mem_get_info()
    planted = "; planted: both ranks on shard 0" if plant else ""
    print(f"[dist] 2 processes: python -m repro_torch.launch.train "
          f"{' '.join(_dist_argv(port, 0))} (rank 1: --process-id 1; "
          f"{cfg.n_layers} layers{planted}); the card has "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free, this process "
          f"holds {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved",
          flush=True)
    child = start_phase_child(
        "dist-rank", str(port), str(layers), str(int(plant)),
        env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    _allocator_settings("expandable_segments:True")
    try:
        # --- the main path (rank 0), its launch counts read around it ---
        _reset_launches()
        with _dist_plant(plant):
            res = train.main(_dist_argv(port, 0), cfg=cfg)
        torch.cuda.synchronize()
        launches0 = {n: fn.launches for n, fn in _launch_counts().items()}
        sm90_0 = {n: fn.launches_sm90 for n, fn in _launch_counts().items()
                  if n in FLASH_PAIR_KERNELS}
        # ----------------------------------------------------------------
        rank1 = finish_phase_child(child, "[dist] rank 1")
    except BaseException:
        _kill([child[0]])
        for name in ("stdout", "stderr"):     # rank 0 failed first
            path = Path(f"{child[1]}/{name}.txt")
            if path.exists():
                print(f"[dist] rank 1 {name}:\n{path.read_text()[-3000:]}",
                      flush=True)
        torch.cuda.empty_cache()
        _allocator_settings("expandable_segments:False")
        raise
    t_ranks = time.perf_counter() - t0
    rank0 = json.loads(json.dumps(_dist_record(res)))   # as rank 1's
    ranks = [rank0, rank1]
    launches = [launches0, rank1["launches"]]
    sm90 = [sm90_0, rank1["on_sm90"]]
    p1, p2 = rank0["p1"], rank0["p2"]
    peaks = [max(r["peaks"]) for r in ranks]
    print(f"[dist] memory peak: rank 0 {ranks[0]['peaks']} GB, rank 1 "
          f"{ranks[1]['peaks']} GB (phases 1-3); the sum of the ranks' "
          f"peaks {sum(peaks):.2f} GB (limit {PEAK_LIMIT_GB} GB)")
    print(f"[dist] rank 0 times {rank0['times']}; the ranks' run "
          f"{t_ranks:.1f} s", flush=True)

    # the recorder
    phase1 = res["phase1_bundle"]["params"]
    n_leaves = len(list(_leaves(phase1)))
    for r, rec in enumerate(ranks):
        recs = [CollectiveRecord(op, tuple(rk), nb, ph, sec)
                for op, rk, nb, ph, sec in rec["records"]]
        rates = []
        for phase, op in (("phase1", "all_reduce"), ("phase3", "broadcast")):
            xs = [x for x in recs if x.phase == phase and x.op == op]
            nb = collective_bytes(xs).get(op, 0)
            sec = sum(x.seconds for x in xs)
            rates.append(f"{phase} {len(xs)} {op} {nb / 1e9:.2f} GB in "
                         f"{sec:.2f} s ({nb / 1e9 / max(sec, 1e-9):.2f} GB/s)")
        phase2 = [x for x in recs if x.phase == "phase2"]
        print(f"[dist] rank {r} collectives on {card}, gloo over loopback: "
              f"{len(phase2)} in phase 2; " + "; ".join(rates), flush=True)
        assert_no_cross_worker_collectives(phase2, 2, 2)
        p3 = [x for x in recs if x.phase == "phase3"]
        check(len(p3) == 2 * n_leaves
              and all(x.op == "broadcast" for x in p3),
              f"[dist] rank {r}: phase 3 issued {len(p3)} collectives, not "
              f"one broadcast a leaf a worker ({2 * n_leaves})")
    check(sum(peaks) <= PEAK_LIMIT_GB,
          f"[dist] the two ranks peak at {sum(peaks):.2f} GB together")

    # the launches, rank by rank
    n, remat = _blocks(Model(cfg))["flash"]
    steps = p1 + p2              # each rank: phase 1, and one worker
    for r in (0, 1):
        lc = launches[r]
        evals, rem = divmod(lc["flash_attention_fwd"] - (n + remat) * steps,
                            n)
        print(f"[dist] rank {r} launches: {lc}; on the bf16 route: "
              f"{sm90[r]}; {steps} steps, {evals} eval forwards of {n} "
              f"layers")
        check(all(lc[k] > 0 for k in DENSE_TRAIN_KERNELS),
              f"[dist] rank {r}: a kernel of the path was not launched")
        check(all(lc[k] == n * steps for k in FLASH_PAIR_KERNELS[1:])
              and evals >= 0 and rem == 0,
              f"[dist] rank {r}: flash launches {lc} are not the plan's")
        check(all(sm90[r][k] == lc[k] for k in sm90[r]),
              f"[dist] rank {r}: flash launches off the bf16 route")
        check(lc["swa_avg"] == n_leaves,
              f"[dist] rank {r}: swa_avg launched {lc['swa_avg']} times, "
              f"not once a leaf ({n_leaves})")
    check(rank1["phase1"] == rank0["phase1"],
          "[dist] the two ranks' phase-1 params differ")
    del res

    # the single-process launcher's phase 1 from the same seed, then its
    # phase 2 and elastic fold from rank 0's phase-1 params
    single = train.build(train.build_parser().parse_args(DIST_TRAIN_ARGV),
                         cfg)
    init = single.adapter.init(torch.Generator(device="cuda").manual_seed(0))
    init0 = tree_map(lambda a: a.clone(), init["params"])
    runner, state = single.phase1(init)
    state = run_phase(runner, state, 0, max_steps=p1,
                      stop_accuracy=single.cfg.phase1.stop_accuracy).state
    rel1 = _rel_l2(phase1, state.bundle["params"])
    step1 = _rel_l2(state.bundle["params"], init0)
    del state, runner, init, init0
    print(f"[dist] phase 1 (data parallel over 2 ranks"
          f"{', planted: both on shard 0' if plant else ''}) against the "
          f"single-process launcher's: relative L2 {rel1:.3e} (limit "
          f"{DIST_PHASE1_RTOL:g}; phase 1 moved the params by {step1:.3e} "
          f"of their norm)", flush=True)
    if plant:
        check(rel1 > DIST_PHASE1_RTOL,
              f"[dist] the planted fault stays inside the bound: {rel1}")
    else:
        check(rel1 <= DIST_PHASE1_RTOL,
              f"[dist] phase 1 differs from the single-process one: {rel1}")
    runner, state = single.phase2({"params": phase1, "state": {}})
    state = run_phase(runner, state, [0, 1], max_steps=p2).state
    stacked = state.bundle["params"]
    del state, runner
    avg, mask = single.average(stacked)
    want = json.loads(json.dumps({
        "local": [_digests(tree_map(lambda a: a[w], stacked))
                  for w in (0, 1)],
        "average": _digests(avg)}))
    rel = _rel_l2(avg, average_stacked(stacked))
    del stacked, avg, phase1, single
    same = {f"worker {w}": ranks[w]["local"][0] == want["local"][w]
            for w in (0, 1)}
    same.update({f"average on rank {r}": ranks[r]["average"] ==
                 want["average"] for r in (0, 1)})
    print(f"[dist] bitwise against the single-process port from the same "
          f"phase-1 params (per-leaf digests): {same}")
    check(all(same.values()) and [r["workers"] for r in ranks] == [[0], [1]],
          f"[dist] not bitwise the single-process port: {same}")
    print(f"[dist] elastic average against the plain mean of the same "
          f"workers: relative L2 {rel:.3e} (limit 1e-6); live masks "
          f"{[r['mask'] for r in ranks]}; worker accs {rank0['accs']}")
    check(rel <= 1e-6 and all(r["mask"] == [True, True] for r in ranks)
          and rank1["accs"] == rank0["accs"],
          f"[dist] average {rel}, masks or accuracies disagree")
    torch.cuda.empty_cache()
    _allocator_settings("expandable_segments:False")
    print(f"[dist] phase time on {card}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"rank0": launches0, "rank1": launches[1]}


# ---------------------------------------------------------------------------
# phase 6: smoke-width training exactness
# ---------------------------------------------------------------------------


def phase_exact_train(arch="internlm2-1.8b", field="attention_impl",
                      cfg=None):
    """Smoke exactness with the kernels (``field`` = "kernel") against the
    plain versions (``field`` = "reference"), on ``cfg`` (f32; the arch's
    smoke config by default); ``field`` may be a tuple of such fields,
    switched together. In an MoE config the plain run goes first
    and records its expert choices, and the kernel run replays them
    (``_fixed_routes``): in f32 a near-tie of router probs, moved by the
    attention's summation order, can flip a top-k choice between the two
    runs, and then the two compute other functions. In the vlm family the
    grads' batch carries stub patch embeddings on its first tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                          ScheduleConfig, SWAPConfig)
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.averaging import elastic_average_stacked
    from repro_torch.core.swap import SWAP
    from repro_torch.data.pipeline import Loader, make_markov_lm
    from repro_torch.dist.config import DistConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train.steps import lm_loss_and_metrics

    smoke = cfg or registry.get_smoke_config(arch)           # f32
    fields = (field,) if isinstance(field, str) else field
    data = make_markov_lm(1, vocab=smoke.vocab_size, n_train=1024,
                          n_test=256, seq_len=64)
    batch = {"tokens": torch.from_numpy(data["train_tokens"][:16]).cuda(),
             "labels": torch.from_numpy(data["train_labels"][:16]).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = Model(smoke).init(gen)
    if smoke.family == "vlm":
        batch["vision_embeds"] = torch.randn(
            (16, smoke.n_vision_tokens, smoke.d_model), generator=gen,
            device="cuda")
    # the plain run first: an MoE config's kernel run replays its routes
    order = ("reference", "kernel")
    fixed = (lambda routes, impl: _fixed_routes(routes, impl == "kernel")
             if smoke.moe else contextlib.nullcontext())
    grads, routes = {}, []
    for impl in order:
        model = Model(dataclasses.replace(smoke,
                                          **dict.fromkeys(fields, impl)))
        req = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(req)
        tree = _rebuild(params, it)
        with fixed(routes, impl):
            loss, _ = lm_loss_and_metrics(model, tree, batch)
        grads[impl] = torch.autograd.grad(loss, req)
    err = l2 = 0.0
    for a, b in zip(grads["kernel"], grads["reference"]):
        check(bool(b.abs().max() > 0), f"zero grad leaf {tuple(b.shape)}")
        d = a - b
        err = max(err, (d.abs().max() / b.abs().max()).item())
        l2 = max(l2, (torch.linalg.vector_norm(d)
                      / torch.linalg.vector_norm(b)).item())
    moe_note = (f", the plain run's {len(routes)} routing choices replayed"
                if smoke.moe else
                f", stub patch embeddings on the first "
                f"{smoke.n_vision_tokens} tokens"
                if "vision_embeds" in batch else "")
    print(f"[exact] f32 {smoke.name} ({_describe(smoke)}{moe_note}): "
          f"whole-model grads with the kernels "
          f"against plain autograd, worst leaf: max |err|/max |ref| "
          f"{err:.3e} (limit {GRAD_TOL}), relative L2 {l2:.3e} (limit "
          f"{GRAD_L2_TOL})")
    check(err <= GRAD_TOL and l2 <= GRAD_L2_TOL,
          f"smoke grads differ: {err:.3e}, relative L2 {l2:.3e}")

    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    dist = DistConfig(n_workers=2, elastic_deadline_s=30.0)
    sched = ScheduleConfig(kind="warmup_linear", peak_lr=0.5,
                           warmup_steps=2, total_steps=8)
    cfg = SWAPConfig(n_workers=2, seed=1,
                     phase1=PhaseConfig(batch_size=64, max_steps=8,
                                        schedule=sched),
                     phase2=PhaseConfig(batch_size=16, max_steps=6,
                                        schedule=dataclasses.replace(
                                            sched, peak_lr=0.125,
                                            warmup_steps=0, total_steps=6)))
    runs, routes = {}, []
    for impl in order:
        adapter = LMAdapter(dataclasses.replace(
            smoke, **dict.fromkeys(fields, impl)), OptimizerConfig())
        test = Loader({"tokens": data["test_tokens"],
                       "labels": data["test_labels"]}, 64, device="cuda")
        with fixed(routes, impl):
            runs[impl] = SWAP(adapter, cfg, train, test, dist=dist).run(
                torch.Generator(device="cuda").manual_seed(5))
    ref_avg, _ = elastic_average_stacked(runs["reference"]["stacked_params"],
                                         dist, impl="reference")
    ref_final = runs["reference"]["final_bundle"]["params"]
    check(all(torch.equal(a, b) for a, b in zip(_leaves(ref_avg),
                                                 _leaves(ref_final))),
          "elastic average on the kernel is not bitwise the plain fold")
    rel = _rel_l2(runs["kernel"]["final_bundle"]["params"], ref_avg)
    acc = abs(runs["kernel"]["after_avg_test_acc"]
              - runs["reference"]["after_avg_test_acc"])
    print(f"[exact] f32 {smoke.name} SWAP (8 + 6 steps, W 2, elastic): "
          f"kernels against plain versions, averaged params relative L2 "
          f"{rel:.3e} (limit 1e-4), averaged test acc |diff| {acc:.3e} "
          f"(limit 2e-3)")
    check(rel <= 1e-4, f"smoke SWAP averaged params differ: {rel:.3e}")
    check(acc <= 2e-3, f"smoke SWAP averaged accuracy differs: {acc:.3e}")


# ---------------------------------------------------------------------------
# phase 7: gemma3-1b, the flash kernels at head dim 256
# ---------------------------------------------------------------------------


def phase_gemma(card: str):
    """gemma3-1b at full width (26 layers, 22 local at window 512 and 4
    global, head dim 256): the serving main path at batch 8, prompt 2048
    (the window binds), and SWAP training through the launcher at phase-1
    batch GEMMA_PHASE1_BATCH; then the smoke-width exactness on the gemma3
    smoke config at head dim 256 (2 layers, one local at window 32 and one
    global; prompts and sequences longer than the window). Returns (the
    forward's launches on the serving path, every kernel's on the training
    path)."""
    import dataclasses
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    serve = phase_serve(card, GEMMA, S=GEMMA_PROMPT, engine=False,
                        tag="gemma3-serve")["flash_attention_fwd"]
    launches = phase_train(card, GEMMA_TRAIN_ARGV, tag="gemma3-train",
                           required=FUSED_TRAIN_KERNELS,
                           sm90_only=FLASH_KERNELS, fused_bwd=True)
    narrow = dataclasses.replace(registry.get_smoke_config(GEMMA),
                                 head_dim=256)
    phase_exact(GEMMA, narrow, lengths=(9, 40, 5, 37, 8))
    phase_exact_train(GEMMA, cfg=narrow)
    print(f"[gemma3] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return serve, launches


# ---------------------------------------------------------------------------
# phase 8: the MoE family and MLA, served
# ---------------------------------------------------------------------------


def _narrow_moe(arch):
    """The f32 exactness config of an MoE arch: its smoke config (2
    layers) at d_model 256 with 4 heads, 4 experts top-2 and a capacity
    factor that drops no token (as tests/test_arch_smoke.py takes it), at
    head dims the kernels take: deepseek-v2-lite's full MLA head dims (qk
    128 + 64 = 192, v 128), granite-moe's head dim 64. The smoke configs'
    own heads (48 and 32) are dims the kernels refuse."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_smoke_config(arch)
    moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                              capacity_factor=4 / 2 * 1.1)
    kw = dict(d_model=256, n_heads=4, n_kv_heads=4 if cfg.mla else 2,
              moe=moe)
    if cfg.mla:
        kw["head_dim"] = 128
        kw["mla"] = dataclasses.replace(cfg.mla, qk_nope_head_dim=128,
                                        qk_rope_head_dim=64, v_head_dim=128)
    else:
        kw["head_dim"] = 64
    return dataclasses.replace(cfg, **kw)


def phase_moe(card: str):
    """deepseek-v2-lite (MLA: the flash forward at head dim 192, 27
    layers of 64 experts top-6, 15.7 B parameters, 62.7 GB in f32) and
    granite-moe-3b-a800m (GQA 24/8 at head dim 64) at full width on the
    serving main path, each with a profiler window of a prefill and a
    decode step and its memory peak; then the f32 exactness of continuous
    batching on their narrowed configs (``_narrow_moe``). Returns the
    forward's launches on each serving path."""
    t0 = time.perf_counter()
    launches = {}
    for arch, tag in ((DEEPSEEK, "deepseek-serve"),
                      (GRANITE, "granite-serve")):
        launches[arch] = phase_serve(card, arch,
                                     tag=tag)["flash_attention_fwd"]
    for arch in (DEEPSEEK, GRANITE):
        phase_exact(arch, _narrow_moe(arch))
    print(f"[moe] phase time {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: SWAP training of the MoE family and MLA
# ---------------------------------------------------------------------------


def _moe_train_cfg(arch, n_layers):
    """``arch``'s full config at ``n_layers``."""
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config(arch), n_layers=n_layers)


def _train_profile(card, tag, argv, cfg):
    """One profiler window of a phase-1 step and of a phase-2 step of the
    launcher's run (``profile_train``, one warm-up and one timed step
    before each): the step time, the device's busy time and idle share,
    and its top kernels."""
    from repro_torch.launch import profile_train
    report = profile_train.main(argv, cfg=cfg, counts=(1, 1, 1))
    for ph in ("phase1", "phase2"):
        r = report[ph]
        top = "; ".join(f"{k[:90]} {v:.2f}" for k, v in
                        list(r["top_kernels_ms_per_step"].items())[:10])
        # the device ms of the kernels each aten op launched (nested ops
        # count in their callers too)
        ops = "; ".join(f"{k} {v[1]:.2f} ({v[2]} calls)" for k, v in
                        [kv for kv in r["top_host_ops_by_device_ms"].items()
                         if kv[0].startswith("aten::")][:12])
        print(f"[{tag}] profile of one {ph} step on {card}: window "
              f"{r['traced_window_ms_per_step']:.2f} ms, device busy "
              f"{r['device_busy_ms_per_step']:.2f} ms, idle share "
              f"{r['device_idle_share']:.3f}; top kernels (ms): {top}; "
              f"top aten ops by their kernels' device ms: {ops}",
              flush=True)
    return report


def _step_twice(tag, cfg, size=256, seq=64):
    """The loss and whole-model grads of one phase-1 step (the launcher's
    batch and length, f32 params, the config's compute dtype) taken twice
    from the same params and tokens: the loss must repeat bitwise and every
    grad leaf within MOE_REPEAT_TOL of its largest value."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train.steps import lm_loss_and_metrics
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(11)
    params = model.init(g)
    tokens = torch.randint(0, cfg.vocab_size, (size, seq + 1), generator=g,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    runs = []
    for _ in range(2):
        req = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(req)),
                                      batch)
        runs.append((loss.detach(), torch.autograd.grad(loss, req)))
    (l0, g0), (l1, g1) = runs
    same = [torch.equal(a, b) for a, b in zip(g0, g1)]
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(g0, g1))
    print(f"[{tag}] one phase-1 step ({size}x{seq} tokens) "
          f"taken twice from the same params and tokens: loss "
          f"{'bitwise equal' if torch.equal(l0, l1) else 'differs'}, "
          f"{sum(same)} of {len(same)} grad leaves bitwise equal, worst "
          f"leaf max |diff|/max |grad| {worst:.3e}", flush=True)
    check(torch.equal(l0, l1), f"{tag}: a repeated step's loss differs")
    check(worst <= MOE_REPEAT_TOL,
          f"{tag}: a repeated step's grads differ by {worst:.3e} of a "
          f"leaf's largest value (limit {MOE_REPEAT_TOL})")
    del params, runs, g0, g1
    torch.cuda.empty_cache()


def phase_moe_train(card: str):
    """SWAP training of deepseek-v2-lite (MLA: the flash kernels at head
    dim 192, G 1; its backwards on the dQ/dK/dV kernel) cut to
    DEEPSEEK_TRAIN_LAYERS and granite-moe-3b-a800m (at head dim 64, G 3;
    the dQ and dK/dV kernels) at GRANITE_TRAIN_LAYERS, at full width through
    the launcher (``phase_train``: every flash launch on the bf16 wgmma route
    and as the layer plan has them, losses finite, the elastic average
    against the plain mean, every phase under PEAK_LIMIT_GB); a profiler
    window of a phase-1 and a phase-2 step of each; one MoE step taken
    twice (the loss bitwise, the grads within MOE_REPEAT_TOL); then the f32
    exactness on the narrowed configs (``_narrow_moe``) with the plain
    run's routes replayed. Returns each arch's launches on its training
    path."""
    t0 = time.perf_counter()
    launches = {}
    for arch, layers, tag, fused in ((DEEPSEEK, DEEPSEEK_TRAIN_LAYERS,
                                      "deepseek-train", True),
                                     (GRANITE, GRANITE_TRAIN_LAYERS,
                                      "granite-train", False)):
        cfg = _moe_train_cfg(arch, layers)
        argv = ["--arch", arch] + TRAIN_ARGV
        print(f"[{tag}] {arch} at {layers} layers: {_describe(cfg)}",
              flush=True)
        launches[arch] = phase_train(
            card, argv, cfg, tag=tag, sm90_only=FLASH_KERNELS,
            required=FUSED_TRAIN_KERNELS if fused else DENSE_TRAIN_KERNELS,
            fused_bwd=fused)
        _train_profile(card, tag, argv, cfg)
        _step_twice(tag, cfg)
    for arch in (DEEPSEEK, GRANITE):
        phase_exact_train(arch, cfg=_narrow_moe(arch))
    print(f"[moe-train] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: zamba2-7b, the hybrid family (the flash kernels at head dim 112)
# ---------------------------------------------------------------------------


def _narrow_zamba():
    """The f32 exactness config of zamba2: its smoke config at head dim 112
    (2 heads, d_model 224), SSD heads of 64 with a state of 64, and 5
    layers with the shared block before every 2 (2 units and a tail of 1).
    The smoke config's head dim of 32 is one the kernels refuse."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_smoke_config(ZAMBA)
    return dataclasses.replace(
        cfg, d_model=224, n_heads=2, n_kv_heads=2, head_dim=112, n_layers=5,
        ssm=dataclasses.replace(cfg.ssm, head_dim=64, d_state=64))


def phase_zamba(card: str):
    """zamba2-7b at full width: served at its 81 layers on phase 4's path
    (13 flash forwards and 81 SSD forwards a prefill, all on the bf16 wgmma
    route; the logits checks with both kernels switched), and SWAP-trained
    through the launcher with its depth cut to ZAMBA_TRAIN_LAYERS (the
    flash and SSD launches a step as the layer plan has them, all on the
    bf16 route; every phase under PEAK_LIMIT_GB), with a profiler window of
    a phase-1 and a phase-2 step; then the f32 exactness on
    ``_narrow_zamba``. Returns (every kernel's launches on the serving
    path, on the training path)."""
    import dataclasses
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    serve = phase_serve(card, ZAMBA, tag="zamba2-serve")
    cfg = dataclasses.replace(registry.get_config(ZAMBA),
                              n_layers=ZAMBA_TRAIN_LAYERS)
    argv = ["--arch", ZAMBA] + TRAIN_ARGV
    print(f"[zamba2-train] {ZAMBA} at {ZAMBA_TRAIN_LAYERS} layers: "
          f"{_describe(cfg)}", flush=True)
    kernels = FLASH_KERNELS + ("ssd_fwd", "ssd_bwd")
    train = phase_train(card, argv, cfg,
                        FLASH_PAIR_KERNELS + ("ssd_fwd", "ssd_bwd", "swa_avg"),
                        tag="zamba2-train", sm90_only=kernels)
    _train_profile(card, "zamba2-train", argv, cfg)
    narrow = _narrow_zamba()
    phase_exact(ZAMBA, narrow)
    phase_exact_train(ZAMBA, ("attention_impl", "ssd_impl"), narrow)
    print(f"[zamba2] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return serve, train


# ---------------------------------------------------------------------------
# phase 12: minicpm3-4b (MLA, the flash kernels at head dim 96)
# ---------------------------------------------------------------------------


def _narrow_mla96():
    """The f32 exactness config of minicpm3: its smoke config (2 layers,
    d_model 256, 4 heads) at its full config's MLA head dims, qk 64 + 32 =
    96 (the flash head dim) and v 64. The smoke config's qk 32 + 16 = 48 is
    a head dim the kernels refuse."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_smoke_config(MINICPM)
    return dataclasses.replace(cfg, head_dim=64, mla=dataclasses.replace(
        cfg.mla, qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64))


def phase_minicpm(card: str):
    """minicpm3-4b at full width: served at its 62 layers on phase 4's path
    (62 flash forwards a prefill at head dim 96, all on the bf16 wgmma
    route; the engine's prompts as internlm2's), and SWAP-trained through
    the launcher with its depth cut to MINICPM_TRAIN_LAYERS (the flash
    launches a step as the layer plan has them, all on the bf16 route;
    every phase under PEAK_LIMIT_GB), with a profiler window of a phase-1
    and a phase-2 step; then the f32 exactness on ``_narrow_mla96``.
    Returns (every kernel's launches on the serving path, on the training
    path)."""
    import dataclasses
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    serve = phase_serve(card, MINICPM, tag="minicpm3-serve")
    cfg = dataclasses.replace(registry.get_config(MINICPM),
                              n_layers=MINICPM_TRAIN_LAYERS)
    argv = ["--arch", MINICPM] + TRAIN_ARGV
    print(f"[minicpm3-train] {MINICPM} at {MINICPM_TRAIN_LAYERS} layers: "
          f"{_describe(cfg)}", flush=True)
    train = phase_train(card, argv, cfg, tag="minicpm3-train",
                        sm90_only=FLASH_KERNELS)
    _train_profile(card, "minicpm3-train", argv, cfg)
    narrow = _narrow_mla96()
    phase_exact(MINICPM, narrow)
    phase_exact_train(MINICPM, cfg=narrow)
    print(f"[minicpm3] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return serve, train


# ---------------------------------------------------------------------------
# phase 13: whisper-base, the audio family (encoder-decoder)
# ---------------------------------------------------------------------------


def _step_flash_plan(cfg, steps):
    """The flash launches of ``steps`` train steps: a forward and a
    backward an encoder layer and each attention of a decoder layer (its
    self attention, and in the audio family its cross attention), whose
    forward runs twice under remat (the encoder is not rematerialized, as
    in the reference)."""
    enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    dec = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
    fwd = enc + dec * (2 if cfg.remat else 1)
    bwd = enc + dec
    return {"flash_attention_fwd": steps * fwd,
            "flash_attention_bwd_dq": steps * bwd,
            "flash_attention_bwd_dkv": steps * bwd,
            "flash_attention_bwd_delta": steps * bwd,
            "flash_attention_bwd_dqkv": 0}


def phase_step_train(card: str, cfg, batch: int, S: int, steps: int,
                     tag: str):
    """``steps`` SGD steps of ``cfg`` (bf16 compute, f32 params) through
    ``train.steps.make_lm_train_step``, on batches of ``batch`` sequences
    of ``S`` tokens with the family's stub inputs from the seed: frames
    (batch, encoder_seq, d_model) for the audio family, patch embeddings
    (batch, n_vision_tokens, d_model) in f32 for the vlm family (the model
    casts them): a main path with the launch counts read around it. Every
    loss finite, the params moved and finite, the flash launches as
    ``_step_flash_plan`` has them, all on the bf16 route, and the peak
    under PEAK_LIMIT_GB. Returns the launches."""
    import math
    import torch
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import schedule_fn
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train.steps import make_lm_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    # the first 2^20 values of each leaf (a whole copy of qwen2-vl's would
    # take 17 GB)
    start = [t.flatten()[:1 << 20].clone() for t in tree_leaves(params)]
    opt_init, train_step = make_lm_train_step(
        model, OptimizerConfig(kind="sgd"),
        schedule_fn(ScheduleConfig(kind="const", peak_lr=0.01)))
    opt_state = opt_init(params)
    batches = []
    for _ in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (batch, S + 1),
                               generator=g, device="cuda")
        b = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.family == "audio":
            b["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                      generator=g, device="cuda").to(
                                          model.dtype)
        if cfg.family == "vlm":
            b["vision_embeds"] = torch.randn(
                (batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
                device="cuda")
        batches.append(b)
    stub = ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                     for k, v in batches[0].items()
                     if k not in ("tokens", "labels"))
    print(f"[{tag}] {cfg.name} ({cfg.n_layers} layers): {steps} SGD steps "
          f"at batch {batch}, S {S}; {stub or 'no stub inputs'}; "
          f"{cfg.dtype}, remat {cfg.remat_policy if cfg.remat else 'off'}",
          flush=True)
    # --- the main path, with every launch count read around it ---
    _reset_launches()
    losses, step_ms = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, b, i)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counted = _launch_counts()
    launches = {name: fn.launches for name, fn in counted.items()}
    on_sm90 = {name: counted[name].launches_sm90 for name in FLASH_KERNELS}
    # -------------------------------------------------------------
    want = _step_flash_plan(cfg, steps)
    print(f"[{tag}] losses {[f'{x:.4f}' for x in losses]}; step ms "
          f"{[f'{x:.1f}' for x in step_ms]} on {card} ({batch * S} tokens "
          f"a step); flash launches {launches} (plan {want}; on the bf16 "
          f"route {on_sm90})", flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.name}: non-finite loss {losses}")
    moved = max((a.flatten()[:1 << 20] - b).abs().max().item()
                for a, b in zip(tree_leaves(params), start))
    check(moved > 0, f"{cfg.name}: the train steps left the params "
                     f"unchanged")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          f"{cfg.name}: non-finite params after the train steps")
    for name, n in want.items():
        check(launches[name] == n and on_sm90[name] == n,
              f"{cfg.name}: {name} launched {launches[name]} times "
              f"({on_sm90[name]} on the bf16 route), not {n}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] params moved by up to {moved:.3e}; device memory peak "
          f"{peak:.2f} GB (limit {PEAK_LIMIT_GB} GB)", flush=True)
    check(peak <= PEAK_LIMIT_GB, f"{cfg.name}: train peak {peak:.2f} GB "
                                 f"over {PEAK_LIMIT_GB} GB")
    del params, opt_state, batches, start
    torch.cuda.empty_cache()
    return launches


def _narrow_whisper():
    """The f32 exactness config of whisper: its smoke config (2 + 2 layers,
    d_model 128, 64 frames) at whisper-base's head dim of 64 (2 heads). The
    smoke config's head dim of 32 is one the kernels refuse."""
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_smoke_config(WHISPER),
                               n_heads=2, n_kv_heads=2, head_dim=64)


def _whisper_exact():
    """f32 on ``_narrow_whisper``: greedy generation with frames, both
    engines, on the kernels token for token as on the plain attention; the
    LM loss's whole-model grads on the kernels against plain autograd, leaf
    by leaf at GRAD_TOL / GRAD_L2_TOL. The key biases' true grads are 0
    (a bias of k adds one value to every score of a query's row, which the
    softmax takes away): those leaves are held to f32 noise, 1e-6 of the
    largest grad, on both paths."""
    import dataclasses
    import torch
    from repro_torch.checkpoint.io import _items
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train.steps import lm_loss_and_metrics

    narrow = _narrow_whisper()
    models = {impl: Model(dataclasses.replace(narrow, attention_impl=impl))
              for impl in ("kernel", "reference")}
    g = torch.Generator(device="cuda").manual_seed(1)
    params = models["kernel"].init(g)
    prompts = torch.randint(0, narrow.vocab_size, (3, 10), generator=g,
                            device="cuda")
    frames = torch.randn((3, narrow.encoder_seq, narrow.d_model),
                         generator=g, device="cuda")
    for engine in ("loop", "compiled"):
        got, want = (generate(models[impl], params, prompts, 6,
                              {"frames": frames}, engine=engine)[0]
                     for impl in ("kernel", "reference"))
        check(torch.equal(got, want),
              f"whisper {engine}: kernel tokens {got.tolist()} != plain "
              f"{want.tolist()}")
    tokens = torch.randint(0, narrow.vocab_size, (4, 17), generator=g,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": torch.randn((4, narrow.encoder_seq, narrow.d_model),
                                   generator=g, device="cuda")}
    grads = {}
    for impl, model in models.items():
        req = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(req)),
                                      batch)
        grads[impl] = torch.autograd.grad(loss, req)
    keys = [k for k, _ in _items(params)]
    scale = max(b.abs().max().item() for b in grads["reference"])
    err = l2 = 0.0
    for key, a, b in zip(keys, grads["kernel"], grads["reference"]):
        if key.endswith("/bk"):
            check(max(a.abs().max().item(), b.abs().max().item())
                  <= 1e-6 * scale, f"whisper grad {key} is not ~0")
            continue
        check(bool(b.abs().max() > 0), f"zero grad leaf {key}")
        d = a - b
        err = max(err, (d.abs().max() / b.abs().max()).item())
        l2 = max(l2, (torch.linalg.vector_norm(d)
                      / torch.linalg.vector_norm(b)).item())
    print(f"[exact] f32 {narrow.name} ({_describe(narrow)}): generate "
          f"with frames, both engines, token for token on the kernels as on "
          f"the plain attention; whole-model grads with the kernels against "
          f"plain autograd, worst leaf: max |err|/max |ref| {err:.3e} (limit "
          f"{GRAD_TOL}), relative L2 {l2:.3e} (limit {GRAD_L2_TOL})",
          flush=True)
    check(err <= GRAD_TOL and l2 <= GRAD_L2_TOL,
          f"whisper smoke grads differ: {err:.3e}, relative L2 {l2:.3e}")


def phase_whisper(card: str):
    """whisper-base at full width: served on phase 4's path with frames
    (8, 1500, 512) from the seed, decoder prompts of WHISPER_PROMPT (18
    flash forwards a prefill: 6 encoder layers, 6 decoder self and 6 cross
    attentions; the continuous engine takes no frames, as the reference's
    takes none), and WHISPER_TRAIN_STEPS train steps
    (``phase_step_train``); then the f32 exactness on
    ``_narrow_whisper``. Returns (the launches on the serving path, on the
    training path)."""
    t0 = time.perf_counter()
    serve = phase_serve(card, WHISPER, S=WHISPER_PROMPT, engine=False,
                        tag="whisper-serve")
    from repro_torch.configs import registry
    train = phase_step_train(card, registry.get_config(WHISPER),
                             WHISPER_TRAIN_BATCH, WHISPER_PROMPT,
                             WHISPER_TRAIN_STEPS, "whisper-train")
    _whisper_exact()
    print(f"[whisper] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return serve, train


# ---------------------------------------------------------------------------
# phase 13b: qwen2-vl-72b, the vlm family (M-RoPE, stub vision embeddings)
# ---------------------------------------------------------------------------


def _grid_positions(B, S, nv, width=16, device="cuda"):
    """(B, 3, S) M-RoPE positions whose three components differ: the first
    ``nv`` tokens an image grid, (t, h, w) = (0, i // width, i % width),
    the text after it at one index past the grid's largest in all three
    (with equal components M-RoPE is plain RoPE, and a wrong section split
    would pass)."""
    import torch
    i = torch.arange(nv, device=device)
    grid = torch.stack([torch.zeros_like(i), i // width, i % width])
    start = int(grid.max()) + 1
    text = torch.arange(start, start + S - nv, device=device).expand(
        3, S - nv)
    return torch.cat([grid, text], dim=1).expand(B, 3, S)


def _mrope_check(cfg, S=600):
    """``rope_cos_sin`` with ``cfg``'s sections on the card at grid
    positions against an f64 formula on the host (frequency j rotates by
    component c(j) of the positions, c the section of j). f32 angles of up
    to S radians: held to 4 ulps of S; and the table must differ from the
    plain rope of any one component by more than 100 times that."""
    import numpy as np
    import torch
    from repro_torch.models.layers import rope_cos_sin
    pos = _grid_positions(2, S, cfg.n_vision_tokens)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    half = cfg.head_dim // 2
    inv = cfg.rope_theta ** (-np.arange(half, dtype=np.float64) / half)
    comp = np.repeat(np.arange(3), cfg.mrope_sections)
    ang = pos.cpu().numpy()[:, comp, :].transpose(0, 2, 1) * inv
    err = max(float(np.abs(cos.cpu().numpy() - np.cos(ang)).max()),
              float(np.abs(sin.cpu().numpy() - np.sin(ang)).max()))
    tol = 4 * S * 2.0 ** -23
    apart = min(max(float((a - b).abs().max()) for a, b in zip(
        rope_cos_sin(pos[:, c], cfg.head_dim, cfg.rope_theta), (cos, sin)))
        for c in range(3))
    print(f"[vlm] M-RoPE (sections {cfg.mrope_sections}, head dim "
          f"{cfg.head_dim}) on the card at grid positions (2, 3, {S}) "
          f"against f64 on the host: max |err| {err:.3e} (limit {tol:.3e}); "
          f"plain rope of one component {apart:.3e} away", flush=True)
    check(err <= tol, f"M-RoPE table off by {err:.3e}")
    check(apart > 100 * tol,
          "M-RoPE table equals the plain rope of a component")


def _narrow_vlm128():
    """The f32 exactness config of qwen2-vl: its smoke config (2 layers,
    d_model 256) at the full config's head dim 128, sections 16/24/24 and
    group G 8 (8 heads on 1 KV head). The smoke config's 4 heads on 2
    run G 2 at head dim 64."""
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_smoke_config(QWEN_VL),
                               n_heads=8, n_kv_heads=1, head_dim=128,
                               mrope_sections=(16, 24, 24))


def phase_vlm(card: str):
    """qwen2-vl-72b at full width with its depth cut to
    QWEN_VL_SERVE_LAYERS (f32 params of 80 layers, 291 GB, fit no card):
    served on phase 4's path with stub patch embeddings and grid positions
    (``phase_serve``; one flash forward a layer a prefill, all on the bf16
    wgmma route, at D 128 and G 8); M-RoPE on the card against f64;
    QWEN_VL_TRAIN_STEPS SGD steps at full width with the depth cut to
    QWEN_VL_TRAIN_LAYERS, on batches with stub patch embeddings
    (``phase_step_train``; SWAP's state of ~26 bytes a parameter does not
    fit one full-width layer beside the embeddings); then the f32
    exactness on ``_narrow_vlm128``. Returns (every kernel's launches on
    the serving path, on the training path)."""
    import dataclasses
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    full = registry.get_config(QWEN_VL)
    cut = dataclasses.replace(full, n_layers=QWEN_VL_SERVE_LAYERS)
    print(f"[vlm-serve] {QWEN_VL} at {QWEN_VL_SERVE_LAYERS} of "
          f"{full.n_layers} layers, full width: {_describe(cut)}",
          flush=True)
    serve = phase_serve(card, QWEN_VL, cfg=cut, tag="vlm-serve")
    _mrope_check(cut)
    train = phase_step_train(
        card, dataclasses.replace(full, n_layers=QWEN_VL_TRAIN_LAYERS),
        QWEN_VL_TRAIN_BATCH, QWEN_VL_TRAIN_SHAPE[1], QWEN_VL_TRAIN_STEPS,
        "vlm-train")
    narrow = _narrow_vlm128()
    phase_exact(QWEN_VL, narrow)
    phase_exact_train(QWEN_VL, cfg=narrow)
    print(f"[vlm] phase time {time.perf_counter() - t0:.1f} s", flush=True)
    return serve, train


# ---------------------------------------------------------------------------
# phase 14: the CNN+BatchNorm path at full width
# ---------------------------------------------------------------------------


def _finite(values) -> bool:
    import math
    return all(math.isfinite(v) for v in values)


def _bitwise(a_tree, b_tree) -> bool:
    import torch
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(_leaves(a_tree), _leaves(b_tree)))


def _cnn_table1_and_swa(card, cfg):
    """The CNN main path: Table 1 (seed 0) at full width, then Table 4's
    large-batch SWA row from its large-batch model. Returns (the swa_avg
    launches, Table 1's runs)."""
    import torch
    from repro_torch.core import swa as swa_mod
    from repro_torch.core.averaging import StreamingAverage
    from repro_torch.experiments import table1_cifar10 as t1
    from repro_torch.experiments import table4_swa_vs_swap as t4
    from repro_torch.experiments.common import run_swa
    from repro_torch.optim.api import tree_map

    # --- (a) Table 1, with every launch count read around it ---
    runs = []
    _reset_launches()
    out = t1.run(seeds=(0,), cfg=cfg, device="cuda", results=runs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _launch_counts().items()}
    # -------------------------------------------------------------
    print(f"[cnn] launches on the Table 1 path: {launches}")
    run = runs[0]
    small, large, swap = run["small"], run["large"], run["swap"]
    for row, v in out.items():
        print(f"[cnn] Table 1 {row}: test acc {v['acc'][0]:.4f}, time "
              f"{v['time'][0]:.3f} s, updates {v['updates'][0]}")
    check(_finite([v["acc"][0] for v in out.values()]
                  + [e[k] for e in swap["phase1_log"]
                     for k in ("loss", "accuracy")]
                  + swap["worker_test_accs"]
                  + [small["train_ema"], large["train_ema"]]),
          "CNN Table 1: a non-finite loss or accuracy")
    init_state = run["task"][0].init(
        torch.Generator(device="cuda").manual_seed(0))["state"]
    bn = swap["final_bundle"]["state"]
    check(all(bool(torch.isfinite(t).all()) for t in _leaves(bn)),
          "CNN phase 3: non-finite recomputed BN state")
    check(not any(torch.equal(a, b) for a, b in zip(_leaves(bn),
                                                     _leaves(init_state))),
          "CNN phase 3: a recomputed BN leaf equals its init value")
    st = swap["device"]
    p1, p2, W = swap["phase1_steps"], swap["phase2_steps"], t1.SWAP_HP[
        "workers"]
    b1, b2 = t1.SWAP_HP["b1"], t1.SWAP_HP["b2"]
    print(f"[cnn] SWAP on {card}: phase 1 {p1} steps of {b1}, "
          f"{st['phase1_train_s'] / p1 * 1e3:.2f} ms/step "
          f"({p1 * b1 / st['phase1_train_s']:.0f} images/s); phase 2 {p2} "
          f"steps of {W} workers x {b2}, "
          f"{st['phase2_train_s'] / p2 * 1e3:.2f} ms/step "
          f"({p2 * W * b2 / st['phase2_train_s']:.0f} images/s); phase 3 "
          f"(average + BN recompute) {swap['phase3_time'] * 1e3:.2f} ms")
    for name, r, b in (("small-batch", small, t1.SMALL["batch_size"]),
                       ("large-batch", large, t1.LARGE["batch_size"])):
        print(f"[cnn] SGD {name}: {r['steps']} steps of {b}, "
              f"{r['time'] / r['steps'] * 1e3:.2f} ms/step "
              f"({r['steps'] * b / r['time']:.0f} images/s)")
    print(f"[cnn] memory peak: phase 1 {st['phase1_peak_gb']:.2f} GB, phase "
          f"2 {st['phase2_peak_gb']:.2f} GB, phase 3 "
          f"{st['phase3_peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)",
          flush=True)

    # --- (b) Table 4's large-batch SWA row, counted the same way; each
    # sample is kept to refold it on the plain version ---
    samples = []

    class Recording(StreamingAverage):
        def add(self, params):
            samples.append(tree_map(lambda a: a.detach().clone(), params))
            return super().add(params)

    swa_mod.StreamingAverage = Recording
    try:
        _reset_launches()
        res = run_swa(*run["task"], start_bundle=large["bundle"], seed=0,
                      **t4.LB_SWA)
        torch.cuda.synchronize()
        swa_launches = {name: fn.launches
                        for name, fn in _launch_counts().items()}
    finally:
        swa_mod.StreamingAverage = StreamingAverage
    # -------------------------------------------------------------
    n_leaves = len(list(_leaves(large["bundle"]["params"])))
    folds = t4.LB_SWA["n_samples"] - 1
    print(f"[cnn] Table 4 large-batch SWA ({t4.LB_SWA['n_samples']} samples "
          f"x {t4.LB_SWA['cycle_steps']} steps of "
          f"{t4.LB_SWA['batch_size']}): before avg "
          f"{res['before_avg_test_acc']:.4f}, after avg "
          f"{res['after_avg_test_acc']:.4f}, {res['time']:.3f} s; launches "
          f"{swa_launches}")
    check(_finite([res["before_avg_test_acc"], res["after_avg_test_acc"]]),
          "CNN SWA row: non-finite accuracy")
    check(swa_launches["swa_avg"] == n_leaves * folds,
          f"swa_avg launched {swa_launches['swa_avg']} times on the SWA row, "
          f"not {n_leaves} leaves x {folds} folds")
    check(all(n == 0 for k, n in {**launches, **swa_launches}.items()
              if k != "swa_avg"), "a kernel outside the CNN path launched")
    plain = StreamingAverage(impl="reference")
    for sample in samples:
        plain.add(sample)
    check(_bitwise(res["final_bundle"]["params"], plain.value()),
          "the SWA row's average on the swa_avg kernel is not bitwise the "
          "plain refold of its samples")
    print(f"[cnn] SWA row average: {n_leaves} leaves x {folds} folds on the "
          f"kernel, bitwise equal to the plain refold", flush=True)
    return launches["swa_avg"] + swa_launches["swa_avg"], runs


def _cnn_profile(card, run):
    """Host-timed steps and a profiler window of phase 1 and phase 2 of
    Table 1's SWAP at full width (``launch.profile_train``'s measure), and
    the augmentation's time a step."""
    import torch
    from repro_torch.core.swap import SWAP
    from repro_torch.data import prng
    from repro_torch.data.augment import augment_images
    from repro_torch.experiments import table1_cifar10 as t1
    from repro_torch.experiments.common import swap_config
    from repro_torch.launch import profile_train as prof

    adapter, train, test = run["task"]
    swap = SWAP(adapter, swap_config(seed=0, **t1.SWAP_HP), train, test)
    bundle = adapter.init(torch.Generator(device="cuda").manual_seed(0))
    report = {}
    for phase, batch in (("phase1", t1.SWAP_HP["b1"]),
                         ("phase2", t1.SWAP_HP["b2"])):
        W = 1 if phase == "phase1" else t1.SWAP_HP["workers"]
        runner, state = getattr(swap, phase)(bundle)
        box = [state]
        workers = 0 if W == 1 else list(range(W))

        def step():
            box[0], _ = runner.run_chunk(box[0], workers, 1)

        r = report[phase] = prof._measure(step, W * batch)
        cats = ", ".join(f"{k} {v:.2f}" for k, v in
                         r["device_ms_per_step_by_category"].items())
        top = "; ".join(f"{k[:70]} {v:.2f}" for k, v in
                        list(r["top_kernels_ms_per_step"].items())[:6])
        print(f"[cnn-profile] {phase} ({W} x {batch} images) on {card}: "
              f"{r['step_ms_mean']:.2f} ms/step ({r['tokens_per_s']:.0f} "
              f"images/s), device busy {r['device_busy_ms_per_step']:.2f} "
              f"ms/step, idle share {r['device_idle_share']:.3f}; device "
              f"ms/step by category: {cats}; top kernels: {top}")
        del box, state, runner
    for batch in (t1.SWAP_HP["b1"], t1.SWAP_HP["b2"]):
        x = torch.randn(batch, 32, 32, 3, device="cuda")
        dev_ms = _host_ms(lambda: augment_images(x, 12345), 10)
        key = prng.PRNGKey(7)
        host_ms = _host_ms(lambda: prng.normal(key, tuple(x.shape)), 3)
        print(f"[cnn-profile] augment_images at batch {batch}: "
              f"{dev_ms:.3f} ms a call (bits hashed on the card; wall time "
              f"to the end of its device work); the noise alone hashed on "
              f"the host (numpy): {host_ms:.3f} ms", flush=True)
    torch.cuda.empty_cache()


def _host_ms(fn, iters: int) -> float:
    """Mean wall ms of fn, each call ended by a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _cnn_prng_on_card(shape):
    """The augmentation's device path on the card against the host path at
    ``shape``: the threefry bits and ``uniform`` bitwise; ``normal`` and
    ``augment_images`` within 4 ulp of their largest value, the cutout's
    zeros bitwise (the tolerances of the CPU tests)."""
    import numpy as np
    import torch
    from repro_torch.data import prng
    from repro_torch.data.augment import augment_images

    def ulps(got, want):
        spacing = np.spacing(want.abs().max().numpy())
        return ((got.cpu() - want).abs().max().item()) / float(spacing)

    k = prng.fold_in(prng.PRNGKey(7), 9176)
    bits = np.array_equal(prng._bits32(k, shape, device="cuda").cpu().numpy(),
                          prng._bits32(k, shape).astype(np.int64))
    uniform = torch.equal(
        prng.uniform(k, shape, device="cuda").cpu().view(torch.int32),
        prng.uniform(k, shape).view(torch.int32))
    normal = ulps(prng.normal(k, shape, device="cuda"), prng.normal(k, shape))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    got, want = augment_images(x.cuda(), 12345).cpu(), augment_images(x, 12345)
    zeros = torch.equal(got == 0, want == 0)
    aug = ulps(got, want)
    print(f"[cnn] prng device path on the card against the host path at "
          f"{shape}: bits bitwise {bits}, uniform bitwise {uniform}, normal "
          f"{normal:.1f} ulp, augment_images {aug:.1f} ulp with its cutout "
          f"zeros bitwise {zeros} (limit 4 ulp of the largest value)",
          flush=True)
    check(bits and uniform and zeros and normal <= 4 and aug <= 4,
          "the prng device path on the card differs from the host path")


def _cnn_card_vs_cpu(cfg, batch=32):
    """Card against CPU at full width in train mode, with cuDNN's TF32
    allowed around the card's calls, and the matmuls' too around each
    convolution's own (so that a TF32 leak shows): the
    forward (logits, new BN state) against the CPU in f32; the whole-model
    grads against the CPU in f32 and in f64, both run on the card's branch
    (the card forward's ReLU masks and max choices replayed,
    ``cnn_conv_accuracy.Branch``); each convolution's backward (dx, dw) on
    the input and cotangent the card's model gave it, against f64, beside
    the same backward through plain autograd (which follows the TF32
    flag) as the control. Without the replay a few ReLU inputs within
    rounding of 0 or near-tied maxes go the other way between two runs and
    move the grads far more than rounding: those distances and flips are
    printed, not held."""
    import torch
    from cnn_conv_accuracy import Branch, bwd_cudnn, cnn_grads, rel_err
    from repro_torch.models import cnn
    g = torch.Generator(device="cuda").manual_seed(21)
    params, state = cnn.init_cnn(g, cfg)
    x = torch.randn(batch, cfg.image_size, cfg.image_size, 3, generator=g,
                    device="cuda")
    cot = torch.randn(batch, cfg.n_classes, generator=g, device="cuda")
    model = (params, state, x, cot, cfg)

    def conv_bwd(xs, w, gy, conv=cnn._conv):
        xs, w = xs.clone().requires_grad_(), w.clone().requires_grad_()
        return torch.autograd.grad(conv(xs, w), (xs, w), gy)

    def leaky(xs, w):
        return torch.nn.functional.conv2d(
            xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1)

    convs, card_branch = [], Branch("record")
    torch.backends.cudnn.allow_tf32 = True
    try:
        card_out, card = cnn_grads(*model, "cuda", branch=card_branch,
                                   convs=convs)
        # the convolutions alone also with the matmuls' TF32 allowed (the
        # model's last layer, a plain matmul, follows that flag)
        torch.backends.cuda.matmul.allow_tf32 = True
        got = [conv_bwd(*c) for c in convs]
        ctl = [conv_bwd(*c, conv=leaky) for c in convs]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cpu_out, cpu = cnn_grads(*model, "cpu")
    f64_branch = Branch("record")
    f64 = cnn_grads(*model, "cpu", torch.float64, branch=f64_branch)[1]
    on_card = {dt: cnn_grads(*model, "cpu", dt, branch=Branch(
        "replay", card_branch.choices))[1]
        for dt in (torch.float32, torch.float64)}
    fwd = max(rel_err(a, b) for a, b in zip(card_out, cpu_out))
    grad = {dt: max(rel_err(a, b) for a, b in zip(card, ref))
            for dt, ref in on_card.items()}
    conv = ctl_err = 0.0
    for (xs, w, gy), mine, leak in zip(convs, got, ctl):
        want = bwd_cudnn(xs.cpu().double(), w.cpu().double(),
                         gy.cpu().double())
        conv = max([conv] + [rel_err(a, b) for a, b in zip(mine, want)])
        ctl_err = max([ctl_err] + [rel_err(a, b) for a, b in zip(leak, want)])
    print(f"[cnn] card against CPU at full width (train mode, batch {batch})"
          f", TF32 allowed around the card's calls, max |err|/max "
          f"|ref|: forward {fwd:.3e} (limit {CNN_FWD_TOL}); whole-model "
          f"grads on the card's branch against the CPU in f32 "
          f"{grad[torch.float32]:.3e}, in f64 {grad[torch.float64]:.3e} "
          f"(limit {CNN_GRAD_TOL}); each of the {len(convs)} convolutions' "
          f"backward on the model's own inputs against f64, worst "
          f"{conv:.3e} (limit {CNN_GRAD_TOL}; through plain autograd, "
          f"which follows the TF32 flag: {ctl_err:.3e})", flush=True)
    print(f"[cnn] not held: without the replay, the card's grads against "
          f"f64 {max(rel_err(a, b) for a, b in zip(card, f64)):.3e}, the "
          f"CPU's f32 grads against f64 "
          f"{max(rel_err(a, b) for a, b in zip(cpu, f64)):.3e}; the card's "
          f"choices that differ from f64's: {card_branch.flips(f64_branch)}",
          flush=True)
    check(fwd <= CNN_FWD_TOL and max(grad.values()) <= CNN_GRAD_TOL
          and conv <= CNN_GRAD_TOL,
          f"CNN card vs CPU: forward {fwd:.3e}, grads {grad}, conv backward "
          f"{conv:.3e}")


def _cnn_exact_smoke():
    """Smoke-width SWAP (W 2, elastic phase 3): the average on the kernel
    against the plain refold of the same phase-2 models, bitwise."""
    import torch
    from repro_torch.configs.base import PhaseConfig, ScheduleConfig
    from repro_torch.configs.base import SWAPConfig
    from repro_torch.core.averaging import elastic_average_stacked
    from repro_torch.core.swap import SWAP
    from repro_torch.dist.config import DistConfig
    from repro_torch.experiments.common import cnn_task

    adapter, train, test = cnn_task(seed=1, device="cuda")
    sched = ScheduleConfig(kind="warmup_linear", peak_lr=0.4, warmup_steps=2,
                           total_steps=8)
    cfg = SWAPConfig(n_workers=2, seed=1, bn_recompute_batches=4,
                     phase1=PhaseConfig(batch_size=256, max_steps=8,
                                        schedule=sched),
                     phase2=PhaseConfig(batch_size=64, max_steps=6,
                                        schedule=ScheduleConfig(
                                            kind="warmup_linear",
                                            peak_lr=0.05, total_steps=6)))
    dist = DistConfig(n_workers=2, elastic_deadline_s=30.0)
    _reset_launches()
    res = SWAP(adapter, cfg, train, test, dist=dist).run(
        torch.Generator(device="cuda").manual_seed(5))
    launches = _launch_counts()["swa_avg"].launches
    plain, _ = elastic_average_stacked(res["stacked_params"], dist,
                                       impl="reference")
    n_leaves = len(list(_leaves(plain)))
    check(launches == n_leaves, f"smoke CNN SWAP: swa_avg launched "
                                f"{launches} times for {n_leaves} leaves")
    check(_bitwise(res["final_bundle"]["params"], plain),
          "smoke CNN SWAP: the elastic average on the kernel is not bitwise "
          "the plain fold")
    check(all(bool(torch.isfinite(t).all())
              for t in _leaves(res["final_bundle"]["state"])),
          "smoke CNN SWAP: non-finite recomputed BN state")
    print(f"[cnn] smoke SWAP (W 2, elastic phase 3): average on the kernel "
          f"({launches} launches) bitwise equal to the plain fold; test acc "
          f"before {res['before_avg_test_acc']:.4f}, after "
          f"{res['after_avg_test_acc']:.4f}", flush=True)


def phase_cnn(card: str) -> int:
    """The CNN+BatchNorm phase; returns swa_avg's launches on its main
    path."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.experiments import table1_cifar10 as t1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = registry.get_config("cifar-cnn")
    print(f"[cnn] {cfg.name}: channels {cfg.cnn_channels}, images "
          f"{cfg.image_size}x{cfg.image_size}x3, {cfg.n_classes} classes, "
          f"f32", flush=True)
    launches, runs = _cnn_table1_and_swa(card, cfg)
    _cnn_profile(card, runs[0])
    del runs
    _cnn_prng_on_card((t1.SWAP_HP["b1"], cfg.image_size, cfg.image_size, 3))
    _cnn_card_vs_cpu(cfg)
    _cnn_exact_smoke()
    torch.cuda.empty_cache()
    print(f"[cnn] phase time {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the rest of the paper's experiments
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the CNN step's bits in a fresh process and in a process whose card is full
# ---------------------------------------------------------------------------


# what runs in a process of its own, beside the phases after it:
# ``--phase-child NAME OUT ARGS...`` runs ``CHILD_PHASES[NAME](*ARGS)``
CHILD_PHASES = {"experiments": "phase_experiments",
                "ablation": "phase_ablation", "cnn-step": "_cnn_step",
                "dist-rank": "_dist_rank"}


def phase_child(name: str, out: str, *args: str) -> None:
    """A fresh process that runs ``CHILD_PHASES[name](*args)`` and writes
    its result to ``out`` (JSON); its lines go to its stdout."""
    _require_card()
    Path(out).write_text(json.dumps(globals()[CHILD_PHASES[name]](*args)))


def start_phase_child(name: str, *args: str, env=None):
    """``phase_child(name, ..., *args)`` in a new process, started and not
    waited for: (the process, its directory, the name). ``env``: variables
    added to the child's environment."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp()
    # output to files, not pipes: the parent reads nothing until it waits,
    # and a full pipe would stop the child
    with open(f"{tmp}/stdout.txt", "w") as out, \
            open(f"{tmp}/stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase-child",
             name, f"{tmp}/result.json", *args], stdout=out, stderr=err,
            env=dict(os.environ, **env) if env else None)
    return proc, tmp, name


def _kill(procs) -> None:
    """Stop the processes of ``procs`` that still run (a failed check
    leaves none behind)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_phase_child(started, what: str = ""):
    """Wait for a ``start_phase_child`` process, print its lines, fail if
    it failed; returns its result."""
    import shutil
    proc, tmp, name = started
    try:
        proc.wait(timeout=900)
        print(Path(f"{tmp}/stdout.txt").read_text(), end="", flush=True)
        check(proc.returncode == 0, f"the {what or name} process failed:\n"
              f"{Path(f'{tmp}/stderr.txt').read_text()[-3000:]}")
        return json.loads(Path(f"{tmp}/result.json").read_text())
    finally:
        _kill([proc])
        shutil.rmtree(tmp, ignore_errors=True)


def _cnn_step(arm: str, margin: str) -> dict:
    """One full-width cifar-cnn forward and grads step
    (``cnn_determinism.train_step_record``) under ``arm``, the card first
    filled to ``margin`` MB free unless it is "-"."""
    from cnn_determinism import train_step_record
    return train_step_record(
        None if margin == "-" else int(float(margin) * 2 ** 20), arm)


def start_cnn_step(arm: str = "model", margin="-"):
    """``_cnn_step`` in a new process, started and not waited for."""
    return start_phase_child("cnn-step", arm, str(margin))


def phase_cnn_processes(card: str, arm: str = "model", fresh=None) -> None:
    """One full-width cifar-cnn forward and grads step (batch 512, params,
    batch and augmentation seed from seed 0) in a fresh process, and in a
    process that first fills the card, in blocks that leave the allocator
    fragmented (``cnn_determinism.fill_card``), until only
    ``cnn_determinism.pressure_margin_mb`` of the fresh step is free: room
    for the step's tensors and 2 GiB of scratch, not for a larger
    workspace. The sha256 of the loss, the grads and the new BN state must
    agree bitwise: the convolutions' bits may not depend on what the
    process did before (ROADMAP C1: cuDNN took other engines, and gave
    other bits, in a process whose card was full). Each convolution's
    scratch and kernels in both processes are printed. ``fresh``: the
    fresh process (``start_cnn_step``), if it was started beside an
    earlier phase (its step does not depend on what else runs on the
    card)."""
    from cnn_determinism import compare_steps, pressure_margin_mb
    t0 = time.perf_counter()
    fresh = finish_phase_child(fresh or start_cnn_step(arm),
                               f"CNN step ({arm}, fresh)")
    margin = pressure_margin_mb(fresh)
    full = finish_phase_child(start_cnn_step(arm, margin),
                              f"CNN step ({arm}, card filled to {margin} MB "
                              f"free)")
    for x, y in zip(fresh["convs"], full["convs"]):
        print(f"[cnn-processes] {x['name']}: scratch {x['scratch_mb']} MB "
              f"fresh, {y['scratch_mb']} MB in the full card; kernels "
              f"{x['kernels']}"
              + ("" if x["kernels"] == y["kernels"]
                 else f" fresh, {y['kernels']} in the full card"))
    same = all(fresh[k] == full[k] for k in ("loss", "grads", "state"))
    print(f"[cnn-processes] cifar-cnn step of {fresh['convs'][0]['name']}"
          f"... on {card}, convolutions {arm}: fresh step peak "
          f"{fresh['peak_mb']} MB; the card filled to {margin} MB free "
          f"({full['free_mb_before']} MB left before the step): "
          f"{compare_steps(fresh, full)} ({time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    check(same, f"the CNN step's bits in a full card differ from a fresh "
                f"process's: {compare_steps(fresh, full)}")


# the forward, then the backward's kernels: each of dQ, dK/dV and delta
# launches once a backward, so the launch checks hold delta's count to dQ's;
# at head dim 256 over one key tile (gemma3's training) the dQ/dK/dV kernel
# takes dQ's and dK/dV's place
FLASH_PAIR_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv", "flash_attention_bwd_delta")
FLASH_KERNELS = FLASH_PAIR_KERNELS + ("flash_attention_bwd_dqkv",)


def _counted(tag, fn):
    """``fn()`` as a main path: every launch count set to 0 just before it
    and read just after. Returns (its result, the counts, its seconds)."""
    import torch
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn_.launches for name, fn_ in _launch_counts().items()}
    print(f"[experiments] {tag}: {seconds:.2f} s; launches {launches}",
          flush=True)
    return out, launches, seconds


def _table_rows(tag, out):
    for row, v in out.items():
        print(f"[experiments] {tag} {row}: test acc {v['acc'][0]:.4f}, time "
              f"{v['time'][0]:.3f} s", flush=True)
    check(_finite([v["acc"][0] for v in out.values()]),
          f"{tag}: a non-finite accuracy")


def phase_experiments(card: str) -> Dict[str, int]:
    """Tables 2 and 3 and Figures 1-4, one seed each, the CNN ones at the
    full width of cifar-cnn ``config()``, Table 3 on its reference task
    (the internlm2 smoke config, f32, on the f32 flash kernels). Returns
    Table 3's launches."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.experiments import (figure1_curves, figure4_cosine,
                                         landscape_viz, table2_cifar100,
                                         table3_imagenet)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = registry.get_config("cifar-cnn")
    print(f"[experiments] {cfg.name} at full width (channels "
          f"{cfg.cnn_channels}, {cfg.image_size}x{cfg.image_size}x3) on "
          f"{card}; one seed each", flush=True)

    out, _, _ = _counted("Table 2 (20 classes, noise 3.0)",
                         lambda: table2_cifar100.run(
                             seeds=(0,), verbose=False, cfg=cfg))
    _table_rows("Table 2", out)

    out, launches, _ = _counted(
        "Table 3 (internlm2 smoke, f32)",
        lambda: table3_imagenet.run(seeds=(0,), verbose=False))
    _table_rows("Table 3", out)
    for name in FLASH_PAIR_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on Table 3")
    check(launches["flash_attention_bwd_dqkv"] == 0,
          "the dQ/dK/dV kernel launched on Table 3 (f32, head dim 64)")
    check(launches["flash_attention_bwd_delta"]
          == launches["flash_attention_bwd_dq"],
          f"Table 3: delta launched {launches['flash_attention_bwd_delta']} "
          f"times, dQ {launches['flash_attention_bwd_dq']}")
    table3 = {name: launches[name] for name in FLASH_KERNELS}

    f1, _, _ = _counted("Figure 1 (phase-2 curves, W 4)",
                        lambda: figure1_curves.run(verbose=False, cfg=cfg))
    curves = f1["curves"]
    late = len(curves) - len(curves) // 2
    print(f"[experiments] Figure 1: {len(curves)} curve points; averaged "
          f"model >= best worker in {f1['late_steps_avg_above_best']}/{late} "
          f"late-phase steps; last point workers "
          f"{[round(a, 4) for a in curves[-1]['worker_test_accs']]}, "
          f"average {curves[-1]['avg_test_acc']:.4f}", flush=True)
    check(_finite([a for c in curves for a in
                   c["worker_test_accs"] + [c["avg_test_acc"]]]),
          "Figure 1: a non-finite accuracy")

    f23, _, _ = _counted(
        "Figures 2/3 (plane through LB, SGD, SWAP; BN per point)",
        lambda: landscape_viz.main(["--device", "cuda"], cfg=cfg))
    print(f"[experiments] Figures 2/3: {len(f23['grid'])} grid points; "
          f"points {f23['points']}; train err at the points "
          f"{f23['train_err']}; test err {f23['test_err']}", flush=True)
    check(len(f23["grid"]) == 81 and _finite(
        [g[k] for g in f23["grid"] for k in ("train_err", "test_err")]
        + list(f23["train_err"].values()) + list(f23["test_err"].values())),
        "Figures 2/3: a missing grid point or a non-finite error")

    f4, _, _ = _counted("Figure 4 (cosine of -g with the SWAP direction)",
                        lambda: figure4_cosine.run(verbose=False, cfg=cfg))
    print(f"[experiments] Figure 4: {len(f4['sims'])} cosines; early mean "
          f"{f4['early_mean']:.4f} -> late mean {f4['late_mean']:.4f}",
          flush=True)
    check(_finite(f4["sims"] + [f4["early_mean"], f4["late_mean"]]),
          "Figure 4: a non-finite cosine")
    torch.cuda.empty_cache()
    print(f"[experiments] phase time {time.perf_counter() - t0:.1f} s",
          flush=True)
    return table3


def phase_ablation(card: str) -> Dict[str, int]:
    """The worker ablation (W 1, 2, 4, 8), one seed, at the full width of
    cifar-cnn ``config()``. Returns its launches."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.experiments import ablation_workers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = registry.get_config("cifar-cnn")
    runs = []
    abl, launches, _ = _counted(
        "worker ablation (W 1, 2, 4, 8)",
        lambda: ablation_workers.run(seeds=(0,), verbose=False, cfg=cfg,
                                     results=runs))
    for r in runs:
        s = r["swap"]
        print(f"[experiments] ablation W {r['workers']}: before avg "
              f"{s['before_avg_test_acc']:.4f}, after avg "
              f"{s['after_avg_test_acc']:.4f}; phase 1 {s['phase1_steps']} "
              f"steps, {s['phase1_time']:.2f} s; phase 2 "
              f"{s['phase2_time']:.2f} s", flush=True)
    check(_finite([a for v in abl.values() for a in v["before"] + v["after"]]),
          "the worker ablation: a non-finite accuracy")
    torch.cuda.empty_cache()
    print(f"[experiments] ablation phase time on {card}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 16: checkpoints and bit-exact resume in a new process
# ---------------------------------------------------------------------------

# cifar-cnn at full width on Table 1's SWAP (2048 images: 4 steps an epoch
# at 512, 32 at 64): snapshots every 48 steps fall at phase-1 steps 48 and
# 96 and at phase-2 step 64
CNN_CKPT_EVERY = 48
# internlm2 smoke through the launcher (4096 sequences: 16 steps an epoch
# at 256): phase-1 snapshots at 16, 32, 48, phase-2 at 16 and 32
LM_RESUME_ARGV = ["--workers", "2", "--phase1-steps", "48", "--phase2-steps",
                  "32", "--phase2-batch", "256", "--stop-acc", "1.01",
                  "--elastic-deadline", "30", "--checkpoint-every", "16",
                  "--device", "cuda"]
RESUME_SCALARS = ("phase1_steps", "phase2_steps", "phase1_train_acc",
                  "phase1_test_acc", "worker_test_accs",
                  "before_avg_test_acc", "after_avg_test_acc",
                  "phase1_skipped_steps", "phase1_loss_scale")


def _cnn_resume_swap(ckpt_dir):
    """Table 1's SWAP (seed 0) at full width, snapshotting into
    ``ckpt_dir``: (the SWAP, its key)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.swap import SWAP
    from repro_torch.experiments import table1_cifar10 as t1
    from repro_torch.experiments.common import cnn_task, swap_config
    adapter, train, test = cnn_task(seed=0, noise=t1.NOISE,
                                    cfg=registry.get_config("cifar-cnn"),
                                    device="cuda")
    cfg = dataclasses.replace(swap_config(seed=0, **t1.SWAP_HP),
                              checkpoint_dir=ckpt_dir,
                              checkpoint_every=CNN_CKPT_EVERY)
    return (SWAP(adapter, cfg, train, test),
            torch.Generator(device="cuda").manual_seed(0))


def _resume_record(res) -> Tuple[bytes, dict]:
    """What a resumed run must reproduce bitwise: (the packed final bundle,
    phase-1 bundle and stacked params; the phase-1 log and scalars)."""
    from repro_torch.checkpoint.io import pack_pytree
    tree = {"final": res["final_bundle"], "phase1": res["phase1_bundle"],
            "stacked": res["stacked_params"]}
    return pack_pytree(tree), {
        "phase1_log": res["phase1_log"],
        **{k: res[k] for k in RESUME_SCALARS}}


def resume_child(kind: str, out: str, args) -> None:
    """A fresh process that resumes: ``kind`` "cnn" (``args``: the
    checkpoint directory) or "lm" (``args``: the launcher's flags, with
    ``--resume``). Writes ``out``.msgpack and ``out``.json."""
    import torch
    _require_card()
    _reset_launches()
    if kind == "cnn":
        swap, key = _cnn_resume_swap(args[0])
        res = swap.run(key, resume=True)
    else:
        from repro_torch.launch import train
        res = train.main(args)
    torch.cuda.synchronize()
    packed, rec = _resume_record(res)
    rec["launches"] = {n: f.launches for n, f in _launch_counts().items()}
    Path(out + ".msgpack").write_bytes(packed)
    Path(out + ".json").write_text(json.dumps(rec))


def _interrupt(src: str, dst: str, keep) -> str:
    """Copy a checkpoint directory and delete the snapshots written after
    the cut (``keep(filename)`` false), as a killed process leaves it."""
    import os
    import shutil
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if not keep(name):
            os.remove(os.path.join(dst, name))
    check(any(n.endswith(".msgpack") for n in os.listdir(dst)),
          f"no snapshot before the cut in {src}: {sorted(os.listdir(src))}")
    return dst


def _start_resume(kind, out, args):
    """``resume_child`` in a new process, started and not waited for; its
    stderr goes to ``out``.err."""
    with open(out + ".err", "w") as err:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--resume-child",
             kind, out, *args], stdout=subprocess.DEVNULL, stderr=err)


def _finish_resume(proc, tag, out, want, first_step):
    """Wait for a ``_start_resume`` process and hold its record against the
    uninterrupted run's ``want`` bitwise. Returns its launches."""
    try:
        proc.wait(timeout=900)
    finally:
        _kill([proc])
    check(proc.returncode == 0, f"{tag}: the resuming process failed:\n"
          f"{Path(out + '.err').read_text()[-3000:]}")
    packed, rec = want
    got = json.loads(Path(out + ".json").read_text())
    tail = [e for e in rec["phase1_log"] if e["step"] >= first_step]
    same = {"params, BN state and stacked params": Path(
        out + ".msgpack").read_bytes() == packed,
            "phase1_log": got["phase1_log"] == tail,
            **{k: got[k] == rec[k] for k in RESUME_SCALARS}}
    print(f"[resume] {tag}, resumed in a new process: bitwise "
          f"{all(same.values())} ({len(got['phase1_log'])} phase-1 log "
          f"entries re-run; phase1_steps {got['phase1_steps']}, after avg "
          f"{got['after_avg_test_acc']!r}); launches {got['launches']}",
          flush=True)
    check(all(same.values()), f"{tag}: the resumed run differs from the "
                              f"uninterrupted one in "
                              f"{[k for k, v in same.items() if not v]}")
    return got["launches"]


def _snapshot_costs(swap, key, ckpt_dir):
    """Each snapshot's size, and its load and save ms alone."""
    import os
    import torch
    from repro_torch.checkpoint.state import (list_checkpoints,
                                              load_train_state,
                                              save_train_state)
    bundle = swap.adapter.init(key)
    templates = {"phase1": swap.phase1(bundle)[1],
                 "phase2": swap.phase2(bundle)[1]}
    for c in list_checkpoints(ckpt_dir):
        template = templates["phase2" if c["tag"] == "phase2" else "phase1"]
        t0 = time.perf_counter()
        state = load_train_state(c["path"], template)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        save_train_state(c["path"] + ".again", state, c["meta"])
        t2 = time.perf_counter()
        same = (Path(c["path"] + ".again").read_bytes()
                == Path(c["path"]).read_bytes())
        os.remove(c["path"] + ".again")
        os.remove(c["path"] + ".again.json")
        print(f"[resume] snapshot {os.path.basename(c['path'])}: "
              f"{os.path.getsize(c['path']) / 1e6:.2f} MB; load "
              f"{(t1 - t0) * 1e3:.1f} ms, save {(t2 - t1) * 1e3:.1f} ms; "
              f"saved again bitwise {same}", flush=True)
        check(same, f"snapshot {c['path']} is not saved again bitwise")


def phase_resume(card: str) -> Dict[str, int]:
    """Snapshots and resume, the resuming run a new process: cifar-cnn at
    full width (Table 1's SWAP) and internlm2 smoke through the launcher,
    each cut once mid-phase-1 and once mid-phase-2. The resuming processes
    run side by side (the CNN's beside the launcher's uninterrupted run).
    Returns the launches of the resumed launcher runs."""
    import os
    import tempfile
    import torch
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = f"{tmp}/cnn"
        swap, key = _cnn_resume_swap(run_dir)
        res = swap.run(key)
        torch.cuda.synchronize()
        want = _resume_record(res)
        p2_steps = res["phase2_steps"]
        print(f"[resume] cifar-cnn full width, Table 1's SWAP on {card}, "
              f"snapshots every {CNN_CKPT_EVERY} steps: phase 1 "
              f"{res['phase1_steps']} steps, phase 2 {p2_steps}; after avg "
              f"{res['after_avg_test_acc']:.4f}; snapshot time in the run "
              f"(phase 2, with its evals) {res['phase2_eval_time']:.2f} s",
              flush=True)
        del res
        _snapshot_costs(swap, key, run_dir)
        cnn_want, resuming, lm_resuming = want, [], []
        try:
            for cut, keep, first in (
                    ("mid-phase-1 (from phase 1 step 48)",
                     lambda n: n.startswith("phase1-step00000048"), 48),
                    ("mid-phase-2 (from phase 2 step 64)",
                     lambda n: n.startswith(("phase1-", "phase1_final-",
                                             "phase2-step00000064")),
                     10 ** 9)):
                src = _interrupt(run_dir, f"{tmp}/cnn-{first}", keep)
                out = f"{tmp}/cnn-{first}-out"
                resuming.append((_start_resume("cnn", out, [src]),
                                 f"cifar-cnn {cut}", out, first))

            lm_dir = f"{tmp}/lm"
            argv = LM_RESUME_ARGV + ["--checkpoint-dir", lm_dir]
            print(f"[resume] python -m repro_torch.launch.train "
                  f"{' '.join(LM_RESUME_ARGV)} --checkpoint-dir DIR",
                  flush=True)
            res = train.main(argv)
            torch.cuda.synchronize()
            want = _resume_record(res)
            del res
            for name in sorted(os.listdir(lm_dir)):
                if name.endswith(".msgpack"):
                    mb = os.path.getsize(f"{lm_dir}/{name}") / 1e6
                    print(f"[resume] internlm2 smoke snapshot {name}: "
                          f"{mb:.2f} MB")
            for cut, keep, first in (
                    ("mid-phase-1 (from phase 1 step 32)",
                     lambda n: n.startswith(("phase1-step00000016",
                                             "phase1-step00000032")), 32),
                    ("mid-phase-2 (from phase 2 step 16)",
                     lambda n: n.startswith(("phase1-", "phase1_final-",
                                             "phase2-step00000016")),
                     10 ** 9)):
                src = _interrupt(lm_dir, f"{tmp}/lm-{first}", keep)
                out = f"{tmp}/lm-{first}-out"
                lm_resuming.append((_start_resume(
                    "lm", out, LM_RESUME_ARGV + ["--checkpoint-dir", src,
                                                 "--resume"]),
                    f"internlm2 launcher {cut}", out, first))
            for proc, tag, out, first in resuming:
                _finish_resume(proc, tag, out, cnn_want, first)
            lm_got = [(tag, _finish_resume(proc, tag, out, want, first))
                      for proc, tag, out, first in lm_resuming]
        finally:
            # a failed check or run leaves no resuming process behind
            _kill([r[0] for r in resuming + lm_resuming])
        for tag, got in lm_got:
            cut = tag[len("internlm2 launcher "):]
            for name in FLASH_PAIR_KERNELS + ("swa_avg",):
                check(got[name] > 0, f"{name} was not launched in the "
                                     f"resumed launcher run ({cut})")
            check(got["flash_attention_bwd_dqkv"] == 0,
                  f"the dQ/dK/dV kernel launched in the resumed launcher "
                  f"run ({cut}; f32, head dim 64)")
            check(got["flash_attention_bwd_delta"]
                  == got["flash_attention_bwd_dq"],
                  f"delta and dQ launched {got['flash_attention_bwd_delta']} "
                  f"and {got['flash_attention_bwd_dq']} times in the resumed "
                  f"launcher run ({cut})")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    print(f"[resume] phase time {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def main() -> None:
    import dataclasses
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    rows = [phase_kernel(), *phase_kernel_bwd(), phase_swa_avg(),
            *phase_ssd()]
    compiled_fwd = phase_serve(card, compiled=True)["compiled"]
    published = phase_publish(card)
    trained = {}
    launches = phase_train(
        card, on_result=lambda res: trained.update(_train_digests(res, 1)))
    supervised = phase_supervise(card, trained)
    dist = phase_dist(card)
    phase_exact()
    phase_compiled_exact()
    phase_exact_train()
    gemma_serve, gemma_train = phase_gemma(card)
    moe_serve = phase_moe(card)
    moe_train = phase_moe_train(card)
    # the ssm family: serving at full width, training at a cut depth
    from repro_torch.configs import registry
    ssd_serve, ssd_compiled = phase_mamba_serve(card)
    cut = dataclasses.replace(registry.get_config(MAMBA),
                              n_layers=MAMBA_TRAIN_LAYERS)
    ssd_train = phase_train(card, ["--arch", MAMBA] + TRAIN_ARGV, cut,
                            MAMBA_TRAIN_KERNELS, tag="mamba-train",
                            sm90_only=("ssd_fwd", "ssd_bwd"))
    phase_exact(MAMBA)
    phase_exact_train(MAMBA, "ssd_impl")
    zamba_serve, zamba_train = phase_zamba(card)
    minicpm_serve, minicpm_train = phase_minicpm(card)
    whisper_serve, whisper_train = phase_whisper(card)
    vlm_serve, vlm_train = phase_vlm(card)
    cnn_launches = phase_cnn(card)
    # host-bound phases in processes of their own, side by side: the CNN
    # step's fresh process, the experiments and the ablation beside the
    # resume phase (whose resuming processes run side by side too); the
    # full card's CNN step runs last, alone
    fresh = start_cnn_step()
    children = [start_phase_child(n, card)
                for n in ("experiments", "ablation")]
    try:
        resumed = phase_resume(card)
        table3, _ = [finish_phase_child(c) for c in children]
    except BaseException:        # a failed check exits: leave no process
        _kill([fresh[0]] + [c[0] for c in children])
        raise
    phase_cnn_processes(card, fresh=fresh)
    # launches: the dense kernels' on the dense training path; the SSD
    # forward's on the mamba serving path (the shape of its row) and on the
    # mamba training path (its train_shape), the SSD backward's on the
    # mamba training path
    launches.update(ssd_fwd=ssd_serve, ssd_bwd=ssd_train["ssd_bwd"])
    print(f"[mamba-train] ssd_fwd launched {ssd_train['ssd_fwd']} times on "
          f"the training path too")
    for row in rows:
        # the dQ/dK/dV kernel's main path is gemma3's training, the other
        # dense kernels' internlm2's
        row["launches"] = (gemma_train[row["name"]]
                           if row["name"] == "flash_attention_bwd_dqkv"
                           else launches[row["name"]])
        if row["name"] == "ssd_fwd":
            row["train_shape"]["launches"] = ssd_train["ssd_fwd"]
        # the compiled engine's path at full width: internlm2-1.8b's
        # bucketed prefills on the flash forward, mamba2-2.7b's on the SSD
        # forward (its decode blocks run no hand-written kernel)
        if row["name"] == "flash_attention_fwd":
            row["compiled_launches"] = compiled_fwd
        if row["name"] == "ssd_fwd":
            row["compiled_launches"] = ssd_compiled
        if row["name"] == "swa_avg":
            row["cnn_launches"] = cnn_launches
        # live publishing at internlm2's full width: the admissions'
        # forwards and the fold of generation 2
        if row["name"] in ("flash_attention_fwd", "swa_avg"):
            row["publish_launches"] = published[row["name"]]
        if row["name"] in table3:
            row["table3_launches"] = table3[row["name"]]
        if row["name"] in resumed:
            row["resume_launches"] = resumed[row["name"]]
        # supervised SWAP at internlm2's full width (one survivor: no fold)
        if row["name"] in DENSE_TRAIN_KERNELS:
            row["supervise_launches"] = supervised[row["name"]]
            # SWAP across two processes, each rank's own launches
            row["dist_launches"] = {r: dist[r][row["name"]] for r in dist}
        if row["name"] in FLASH_KERNELS:
            row["gemma3_launches"] = {"train": gemma_train[row["name"]]}
            if row["name"] == "flash_attention_fwd":
                row["gemma3_launches"]["serve"] = gemma_serve
                row["deepseek_launches"] = moe_serve[DEEPSEEK]
                row["granite_launches"] = moe_serve[GRANITE]
        if row["name"] in DENSE_TRAIN_KERNELS + FUSED_TRAIN_KERNELS:
            row["deepseek_train_launches"] = moe_train[DEEPSEEK][row["name"]]
            row["granite_train_launches"] = moe_train[GRANITE][row["name"]]
        # zamba2-7b: the flash and SSD kernels on its serving (forwards)
        # and training paths, swa_avg on its training path
        row["zamba2_launches"] = {"train": zamba_train[row["name"]]}
        if row["name"] in ("flash_attention_fwd", "ssd_fwd"):
            row["zamba2_launches"]["serve"] = zamba_serve[row["name"]]
        # minicpm3-4b: the flash kernels and swa_avg on its training path,
        # the forward on its serving path; whisper-base: the flash kernels
        # on its train steps, the forward on its serving path
        if row["name"] in DENSE_TRAIN_KERNELS:
            row["minicpm3_launches"] = {"train": minicpm_train[row["name"]]}
        if row["name"] in FLASH_KERNELS:
            row["whisper_launches"] = {"train": whisper_train[row["name"]]}
        # qwen2-vl-72b: the flash kernels on its full-width train steps,
        # the forward on its full-width serving path
        if row["name"] in FLASH_KERNELS:
            row["qwen2vl_launches"] = {"train": vlm_train[row["name"]]}
        if row["name"] == "flash_attention_fwd":
            for key, serve in (("minicpm3_launches", minicpm_serve),
                               ("whisper_launches", whisper_serve),
                               ("qwen2vl_launches", vlm_serve)):
                row[key]["serve"] = serve[row["name"]]
    import torch
    print(f"[chip_smoke] all phases in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-child"]:
        phase_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--resume-child"]:
        resume_child(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
