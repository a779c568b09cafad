#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's four main paths, the training-plane knobs (ZeRO-1
and the overlapped exchange among them), the Trainer with its
checkpoints, the launcher with elastic recovery, the checkpoint-to-serving
chain, and the bench entry, and
holds every CUDA kernel on them against its plain PyTorch version on the
card:

* serving — the paged generation engine serving the bench LM at full
  width (``bench.py``'s ``_LM_TPU``: vocab 32768, d_model 2048, 16 heads
  of 128, 8 layers, d_ff 8192; random weights from a seed);
* training — ``bench.py``'s ResNet-50 train step with
  ``--conv-backend fused`` at full width (``[3,4,6,3]`` bottlenecks, 64
  base filters, 1000 classes, 224x224, batch 128, bf16 compute with f32
  params and head, SGD 0.1 / momentum 0.9, local BatchNorm) through the
  Horovod surface (``init``, ``broadcast_parameters``,
  ``DistributedOptimizer``) on a 1-rank NCCL world;
* LM training — ``bench.py``'s transformer-LM train step at full width
  (``_LM_TPU``: T=2048, batch 8, bf16 compute with f32 params and a bf16
  unembed, dense NLL, AdamW(1e-4, b1 0.9, b2 0.95, weight decay 0.1))
  through ``make_parallel_train_step`` on a 1-rank NCCL world, its
  attention on the packed flash forward with lse and the dq/dkv backward
  kernels;
* pipelined LM training — the same LM and batch through
  ``make_pp_transformer_train_step`` (1F1B, 2 microbatches of 4) on a
  dp=1 x pp=1 mesh of a 1-rank NCCL world (one card: all 8 layers in one
  stage), its attention on the [B,T,H,D] flash forward with lse and the
  dq/dkv kernels with K6's constants.

Phases, one JSON line each:

1. device   — require CUDA; print the card, its power limit, versions.
2. build    — nvcc-build the kernels from ``horovod_tpu_torch/ops/csrc``;
               registers, spills and shared memory of the flash, conv
               and paged kernels (fails if ptxas serialized a wgmma or
               any of them spills).
3. parity   — each kernel vs its plain version at the engine's shapes
               (the flash forward at T in {1, 16, 127, 128, 129, 1000,
               2047, 2048}); K8 against the dense and the split plain
               versions in five cases (the engine's positions with pos
               -1; both sides of split edges, empty splits and a
               position past the table; repeated blocks and trash-padded
               rows; S=1 and S=8 at the last key) and at block sizes 1,
               8, 12 and 32, each row within TOL_ATTN_ULPS bf16 ulps of
               its largest value, six launches bitwise equal.
4. engine   — ``GenerationEngine`` (8 slots, max_len 2048, paged,
               block 16), ``warmup()``, 8 concurrent requests of 32 new
               tokens with prompts from 9 to 1500 tokens, one over
               ``HttpServer`` ``POST /generate``. Launch counters are
               zeroed just before the requests and read just after: the
               flash kernel must run n_layers times per prefill, the
               paged kernel n_layers times per decode step. The same
               load runs again under ``torch.profiler`` for the device's
               busy share and the kernels that take its time.
5. e2e      — a 256-token prompt + 4 decode steps through the port on
               the card and, from the same weights, on the CPU (where
               the plain versions run); last logits compared.
6. timing   — each kernel's median time beside its bound, its plain
               version's time and a library yardstick's; the flash
               forward's and K8's host time per call. K8 at four shapes
               (PAGED_TIMED), each launch on the next of 8 layer views
               of the engine's pool.
7. parity_conv — K1/K2 (``fused_conv_bn.cu``) vs their plain versions at
               every distinct (M, Cin, Cout, prologue) of the 16 fused
               sites and a ragged M, with non-zero stats cotangents, and
               at a ragged M with an O(1) prologue shift and ds1 (rows past
               M must add nothing to the sums), and at shapes that take the
               kernels' other paths (CONV_EDGE); two launches must agree
               bitwise.
8. train    — the fused ResNet-50 train step: 2 warmup + 10 timed steps
               on the bench's fixed synthetic batch; launch counters
               zeroed before the timed steps (16 K1 + 16 K2 per step);
               the loss must be finite and fall. Then the same with the
               stock backend (cuDNN convs, PyTorch BatchNorm) as the
               model-level yardstick.
9. train_profile — one fused step under ``torch.profiler``.
10. e2e_train — one step of full-width ResNet-50 at batch 8 on the card
               and on the CPU from the same weights and batch: loss,
               logits, updated params and running statistics compared.
11. timing_conv — K1 and K2 at each of the eight site shapes beside
               their bounds and a GEMM-only yardstick (plain versions at
               two of them), and the per-step sums over the 16 sites.
12. parity_attn — the packed forward with lse (K3-qkv) and the dq/dkv
               backward pair vs their plain versions at B=1, H=16,
               d=128: T in {128, 1024, 2048} causal, T=256 non-causal
               and T in {1000, 129, 2, 65, 191} causal (lengths that the
               kernels' 64- and 128-row tiles cut raggedly); six launches
               must agree bitwise.
13. lm_train — the full-width LM train step: 2 warmup + 10 timed steps
               on a fixed random batch; launch counters zeroed before the
               timed steps (8 K3-qkv + 8 dq + 8 dkv per step, no prefill
               K3-fwd); step p50, tokens/s, MFU, peak memory; the loss
               must be finite and fall.
14. lm_train_profile — one LM step under ``torch.profiler``.
15. e2e_lm_train — one full-width step at batch 1, T=256 on the card and
               on the CPU from the same weights and batch: loss, logits,
               gradients and updates compared.
16. timing_attn — K3-qkv and the dq/dkv pair at the LM step's shape
               (B=8, H=16, T=2048, causal) vs their plain versions (the
               kernels line's max_abs_err; six launches bitwise equal),
               then timed beside their bounds, plain versions and SDPA;
               the Delta pass outside the kernels (``timing_delta``).
17. parity_attn_bhtd — the [B,T,H,D] forward with lse and the dq and
               dk/dv kernels (K6's constants) vs their plain versions at
               the pp step's shape (B=4, H=16, T=2048, causal; q/k/v
               strided slices of a packed [B,T,H,3,d] projection, q
               prescaled; the kernels line's max_abs_err), at B=1,
               T=1000 causal and T=256 non-causal, and at B=2, T=191
               causal; six launches must agree bitwise.
18. pp_lm_train — the full-width pipelined step: 2 warmup + 10 timed
               steps on lm_train's batch; counters zeroed before the timed
               steps (16 lse forwards + 16 dq + 16 dkv per step, no packed
               K3-qkv and no forward without lse); step p50, tokens/s,
               MFU, peak memory; the loss must be finite and fall.
19. pp_lm_train_profile — one pipelined step under ``torch.profiler``.
20. e2e_pp_lm_train — one full-width pipelined step at batch 2 (2
               microbatches of 1), T=256, on the card (NCCL world) and on
               the CPU (gloo world) from the same weights and batch: loss,
               gradients and the update compared.
21. timing_attn_bhtd — the three [B,T,H,D] launches and the pair at
               B=4, T=2048 beside their bounds, plain versions and SDPA;
               the Delta pass (``timing_delta``).
22. train_knobs — the full-width LM, two steps per variant from the same
               seed and batch, counters zeroed before each: accumulation
               over 2 microbatches (16 K3-qkv + 16 dq + 16 dkv a step;
               loss and update within TOL_E2E_LM of the plain step),
               remat (16 K3-qkv: the recompute; its params after the
               steps expected bitwise the plain step's), the chunked loss
               (4096; loss within TOL_CHUNK), the bf16 and fp8 wire
               formats (the JAX tests' tolerances, TOL_WIRE; the path
               NCCL took), the pipelined step with the guard and a bf16
               wire against the plain pipelined step; each variant's
               peak memory and step time.
23. guard   — the fused ResNet-50 at batch 128 with the bad-step guard: a
               NaN image leaves params, momentum and BatchNorm buffers
               bit-unchanged with bad_step 1 and loss 0 (16 K1 + 16 K2
               still launched), the next finite step trains; the step
               time with the guard off and on, in turns.
24. zero_overlap — ZeRO-1 and the backward-overlapped exchange on the
               1-rank NCCL world: the full-width LM (AdamW as bench.py,
               foreach pinned) plain, ``zero``, ``overlap`` and both, and
               the fused ResNet-50 at batch 128 plain and with both, 3
               steps each from one seed, counters zeroed before each
               step: every step launches 8 K3-qkv + 8 dq + 8 dkv (LM) or
               16 K1 + 16 K2 (ResNet), every variant's params after the
               steps bitwise equal to the plain run's; step ms p50 and
               peak bytes of each; then one ZeRO step with the guard on
               a NaN batch leaves params, the shards' state and the
               BatchNorm buffers bit-unchanged.
25. trainer — the fused ResNet-50 at batch 128 through ``Trainer.fit``
               (2 epochs of 4 steps on the fixed synthetic batch, prefetch
               2) with ``BroadcastGlobalVariablesCallback``,
               ``MetricAverageCallback``, ``LearningRateWarmupCallback`` and
               a save per epoch through ``AsyncCheckpointer`` +
               ``save_checkpoint(max_to_keep=2)``; counters zeroed before
               the fit (16 K1 + 16 K2 per step); the lr per batch against
               the warmup formula; ``verify_checkpoint``; a fresh state
               restored bitwise equal to the live one (params, buffers,
               momentum, lr, step); one more epoch from each, bitwise
               equal (``torch.backends.cudnn.deterministic`` pinned for
               it); a flipped and a truncated leaf raise
               ``CheckpointCorruptError`` naming the checkpoint and the
               leaf, a manifest-less copy restores unverified; the
               snapshot, write, manifest and restore times and bytes; the
               step loop's stall after a synchronous and an async save;
               the Trainer's step p50 (fed host batches, and batches
               already on the card) against the bare loop's, in turns;
               with ``HVD_MAX_BAD_STEPS=2`` NaN batches under the guard
               raise ``NonFiniteGradError`` after two skipped steps with
               the state bit-unchanged.
26. elastic — the launcher and elastic recovery: the fused ResNet-50 at
               batch 128 through ``Trainer.fit`` under
               ``run_with_recovery`` with ``ElasticState(commit_every=2,
               writer=AsyncCheckpointer)`` (durable at each epoch's end),
               2 epochs of 4 steps, cuDNN pinned deterministic, run by
               ``python -m horovod_tpu_torch.launcher -np 1`` as this
               script's ``--elastic-worker`` mode: (a) a clean run; (b)
               the same with ``--restarts 1``,
               ``HVD_RESTART_BACKOFF_MAX=0`` and
               ``HVD_FAULT_SPEC=rank=0:kill@step=5``: one relaunch, epoch
               1 logs ``resumed from committed step 4`` (markers 2 and 4
               only: the step-6 commit in flight at the kill left none),
               the final params and state bitwise (a)'s, each process
               16 K1 + 16 K2 a step; (c) in this process, commits at
               steps 2 and 4 with ``ckpt:flip@step=4``, then NaN batches
               until ``HVD_MAX_BAD_STEPS=2`` runs out: the walk discards
               step 4, the Trainer rolls back to step 2 (bitwise the
               commit), and 2 finite steps equal those of a restore of
               that commit. Time to recover (kill → the launcher's reap,
               relaunch → ``init``, the walk and restore, the first step
               after the resume), the commit's stall on the step loop
               (sync and async) and bytes, run (a)'s step p50 against
               the bare loop's.
27. lm_ckpt_serve — the full-width LM with ``zero=True``: 2 steps (8
               K3-qkv + 8 dq + 8 dkv each), ``save_sharded``,
               ``verify_checkpoint``, ``restore_sharded`` into a fresh
               state bitwise equal to the live one, one more step from
               each with bitwise-equal params; ``restore_for_inference``
               (reads only the params' files) through
               ``convert.params_from_jax`` into a paged engine (8 slots,
               max_len 2048, block 16): 4 greedy requests of 16 new tokens
               give the same tokens as an engine built from the live
               weights, the flash kernel running n_layers times per
               prefill and K8 n_layers times per decode step; bytes,
               save, verify, restore and ``restore_for_inference`` times.
               Checkpoints go to a temporary directory removed after each
               of these two phases.
28. lm_mesh — the mesh axes of the full-width LM on one card, counters
               zeroed before each run's steps: (a) the four-axis step on
               a hand-built one-rank mesh naming dp, pp, ep and tp
               (``make_mesh``; the spec-grouped all-reduce plane, tp's
               sum all-reduces on a group of one) against the dp-only
               ``make_parallel_train_step``, MESH_STEPS steps each from
               one seed: params bitwise equal, 8 K3-qkv + 8 dq + 8 dkv a
               step each; (b) the ring path with a named sp axis of size
               1 at MESH_RING_BATCH (f32 dense blocks, no flash launch):
               first-step loss within TOL_RING_LOSS of the flash step's
               at the same batch; (c) a one-expert MoE on a named ep axis
               of size 1 (capacity 20480 slots of [1, 20480, 2048] bf16)
               and its aux loss; step p50 and peak bytes of each; (d)
               K3-qkv and the dq/dkv pair at the per-rank shapes of tp in
               MESH_TP (8 and 4 heads, qkv rows of 3·1024 and 3·512; B=8,
               T=2048) and K3-lse with the dq/dk/dv kernels at 8 heads
               (pp × tp=2: B=4) against their plain versions
               (TOL_ATTN_ULPS, TOL_LSE), then timed beside their bounds
               and SDPA. Multi-rank tp/sp/ep need more than one card.
29. lm_mesh_zero — ZeRO-1 and overlap on every axis of the full-width
               LM on one card, AdamW with ``foreach`` pinned, counters
               zeroed before each step: (a) the four-axis step on the
               one-rank ``make_mesh({"dp", "pp", "ep", "tp"})`` (the
               hybrid ZeRO plane with every non-scatter axis at size 1)
               plain, ``zero``, ``overlap`` and both, MZ_STEPS steps
               each, params and losses bitwise the dp-only ``zero=True``
               step's and the plain step's, 8 K3-qkv + 8 dq + 8 dkv a
               step; (b) the pipelined step on ``make_mesh({"dp", "pp",
               "tp"})`` (2 microbatches of 4) plain, ``zero``,
               ``overlap`` and both, bitwise the plain step's, 16
               K3-lse + 16 + 16 of its dq/dkv pair a step; step p50,
               peak bytes, optimizer-state elements and buckets per spec
               group of each; (c) ``save_sharded`` of (a)'s and (b)'s
               ZeRO states in the 2-D canonical form, verify, restore
               into a fresh state, one more step from each, bitwise;
               ``restore_for_inference(mesh=, spec_fn=)`` of (a)'s leaf
               for leaf the live model's; bytes, save, verify and
               restore times.
30. bench   — ``python -m horovod_tpu_torch.bench`` four times (the
               default two lines, the same with ``--zero --overlap``,
               ``--model resnet50 --conv-backend fused``, ``--model
               transformer_lm --accum-steps 2``), each in a process of
               its own: names, finite positive values, 0 < mfu <= 1, the
               knob fields, the peak bytes, the card; then ``--scaling
               --model resnet50`` (a launcher world of 1: the scaling
               line of 1 GPU, then the per-GPU line).

Then, before the last line, the card's ``name, power.limit`` and one
``{"kernels": [...]}`` object; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with
no result line. Run: ``python3 chip_smoke.py`` from the repository root.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import http.client
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback

_T_START = time.time()   # before torch's import: an elastic worker's start

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F

LM = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8, d_ff=8192)
MAX_SLOTS, MAX_LEN, BLOCK = 8, 2048, 16
NEW_TOKENS = 32
PROMPT_LENS = (9, 100, 300, 1000, 1500, 200, 600)   # + one over HTTP
HTTP_PROMPT_LEN = 64
FLASH_T = (128, 1000, 2048)           # timed
# + the smallest prefill buckets and both sides of the 128-row q tile and
# 128-key tile's edges (a ragged tile, a diagonal inside a tile)
FLASH_T_PARITY = (1, 16, 127, 128, 129, 1000, 2047, 2048)
TOL_FLASH = 2e-2    # bf16 outputs of magnitude < 4: a few bf16 ulps
# Late rows at T=2048 are ~0.04 in magnitude, so each output row of d is
# also held at TOL_ATTN_ULPS bf16 ulps of its own largest value
# (row_ulps): a dropped or doubled key tile moves such a row by tens.
TOL_PAGED = 2e-2    # f32 math on both sides, one bf16 rounding of O(1)
# K8's timed shapes (S = len(positions)): the balanced row kept from
# earlier PRs (random positions 896-1152, drawn in phase_timing_paged),
# the engine's 8 slots mid-decode (prompt + NEW_TOKENS / 2), one slot and
# every slot at the table's last key.
PAGED_TIMED = (("balanced", None),
               ("engine_mix", tuple(n + NEW_TOKENS // 2 for n in
                                    PROMPT_LENS + (HTTP_PROMPT_LEN,))),
               ("one_slot", (MAX_LEN - 1,)),
               ("full", (MAX_LEN - 1,) * MAX_SLOTS))
# A value no key or value holds: the trash block of the trash-padded
# parity case is filled with it, so a read of it would show.
PAGED_TRASH = 512.0
PAGED_PARITY_BS = (1, 8, 12, 32)
# Logits of std ~0.9 after 8 bf16 layers on two devices whose matmuls
# round differently: 0.035 measured on an H100, bound at about 3x that.
TOL_E2E = 0.1
# ResNet-50 training (bench.py's resnet50 config).
RN_BATCH, RN_IMAGE, RN_CLASSES = 128, 224, 1000
RN_WARMUP, RN_STEPS = 2, 10
RN_E2E_BATCH = 8
RN_SITES = 16         # fused 1x1 sites per step with fused_stages=(0, 1)
# The distinct (M, Cin, Cout, prologue) of the 16 sites at batch 128 with
# their launches per step (each launches K1 once and K2 once).
CONV_SITES = (((401408, 64, 64, False), 1), ((401408, 64, 256, True), 3),
              ((401408, 64, 256, False), 1), ((401408, 256, 64, False), 2),
              ((401408, 256, 128, False), 1), ((100352, 128, 512, True), 4),
              ((100352, 256, 512, False), 1), ((100352, 512, 128, False), 3))
# Parity: the sites, and a ragged M (not a multiple of the 64- and 128-row
# tiles) both ways, with small stats cotangents like the sites'.
CONV_SHAPES = tuple(site for site, _ in CONV_SITES) + (
    (1000, 64, 128, True), (1000, 128, 64, False))
# A ragged M with an O(1) prologue shift b and stats cotangent ds1: a row
# past M would add relu(b) to u and bf16(ds1) to e, which moves s1, s2,
# dW, da and db by far more than TOL_CONV.
CONV_RAGGED_O1 = ((1000, 64, 256, True),)
# Kernel paths the sites do not take (fwd_plan / bwd_plan): K1 streaming W
# (Cin 2048) and resident at Cin 1280; the one pass with an odd count of
# dx boxes; dx slices of one box with 64-wide and odd dW windows; M = 1.
CONV_EDGE = ((4096, 2048, 512, False), (300, 1280, 128, True),
             (1000, 192, 64, True), (2000, 64, 2048, True),
             (777, 192, 320, True), (1, 64, 64, True))
# Plain versions are timed at these two sites only (the first is the
# kernels line's row).
CONV_TIMED = ((401408, 64, 256, True), (401408, 256, 128, False))
# Errors are max|kernel - plain| / max|plain| per output. bf16 outputs
# (y, dx): within one bf16 ulp of the largest value (f32 sums in another
# order can flip a rounding). f32 sums (s1, s2, dW, da, db) over up to
# 401408 rows: 1e-3.
TOL_CONV = {"y": 2.0 ** -7, "dx": 2.0 ** -7, "s1": 1e-3, "s2": 1e-3,
            "dw": 1e-3, "da": 1e-3, "db": 1e-3}
# The CUDA kernels behind K1 and K2 (fused_conv_bn.cu), by profile key:
# K1; K2's one pass and dW windows; K2's dx where the one pass does not
# fit; the fixed-order reduction of the partials; bf16(W) for the kernels
# that stream W.
CONV_KERNELS = {"k1": "conv_bn_fwd_kernel", "k2": "conv_bn_bwd_kernel",
                "k2_dx": "conv_bn_bwd_dx_kernel",
                "col_sum": "conv_bn_col_sum_kernel",
                "w_round": "conv_bn_w_round_kernel"}
# Card vs CPU after one bf16 train step of full-width ResNet-50 (batch 8,
# flax's init), each about 3-4x the value measured on an H100 (PERF.md):
# loss 4.9e-4, logits 2.4e-3, per-leaf update 0.10 (the last block's BN
# scale; 0.03 elsewhere), running stats 7.6e-5; the whole update's
# cosine must stay near 1 (measured 1.000).
TOL_E2E_TRAIN = {"loss": 2e-3, "logits": 1e-2, "param_updates": 0.3,
                 "batch_stats": 3e-4, "update_cosine": 0.99}
# Transformer-LM training (bench.py's _LM_TPU and measure_lm).
LM_BATCH, LM_SEQ = 8, 2048
LM_WARMUP, LM_STEPS = 2, 10
LM_E2E_BATCH, LM_E2E_SEQ = 1, 256
ADAMW = dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
# (T, causal) of the attention parity checks at B=1, H=16, d=128.
ATTN_PARITY = ((128, True), (1024, True), (2048, True), (256, False),
               (1000, True), (129, True), (2, True), (65, True),
               (191, True))
# bf16 outputs (o, dq, dk, dv): within 2 bf16 ulps of the largest value
# (f32 sums in another order can flip a rounding of ds or of the output);
# lse2 (f32, log2 domain): 1e-4 absolute.
TOL_ATTN_ULPS = 2.0
TOL_LSE = 1e-4
# Launches of each attention kernel set that must agree bitwise: a fault
# in a ring's ordering shows as launch-to-launch differences, often in
# fewer than one launch in two.
ATTN_REPEATS = 6
ATTN_KERNELS = ("flash_attention_qkv_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The pipelined LM (bench.py measure_lm's max(2, accum_steps) microbatches).
PP_MICRO = 2
PP_E2E_BATCH, PP_E2E_SEQ = 2, 256
# (B, T, causal) of the [B,T,H,D] parity checks; the first is the pp
# step's own shape (one microbatch) and gives the kernels line's errors.
BHTD_PARITY = ((LM_BATCH // PP_MICRO, LM_SEQ, True), (1, 1000, True),
               (1, 256, False), (2, 191, True))
BHTD_KERNELS = ("flash_attention_lse", "flash_bwd_dq_bhtd",
                "flash_bwd_dkv_bhtd")
# Card vs CPU after one bf16 AdamW pipelined step (batch 2 as 2
# microbatches, T=256, same weights and batch), about 3-4x the values
# measured on an H100 (PERF.md): loss 4.5e-4, the worst leaf's gradient
# 1.07e-2 in relative L2 (the embedding), the whole update's cosine 0.9936
# (1 - cosine 6.4e-3), held to [0.975, 1 + 1e-6].
TOL_E2E_PP = {"loss": 1.5e-3, "grad_rel_l2": 0.04, "update_cosine": 0.975}
# Card vs CPU after one bf16 AdamW step of the full-width LM (batch 1,
# T=256, same weights and batch), about 3-4x the values measured on an
# H100 (PERF.md): loss 4.5e-4, logits 0.046, the worst leaf's gradient
# 1.2e-2 in relative L2. The gradient limit is the one that separates a
# wrong kernel. AdamW's first step is ~lr*sign(g), so entries whose
# gradient is rounding noise flip sign: per-leaf updates differ by up to
# 0.17 in relative L2 (printed, not held to a limit), and the whole
# update's cosine (0.993 measured) is held to [0.97, 1 + 1e-6].
TOL_E2E_LM = {"loss": 1.5e-3, "logits": 0.15, "grad_rel_l2": 0.04,
              "update_cosine": 0.97}
# The training-plane knobs (train_knobs): one full-width LM step pair per
# variant from the same seed and batch. Chunked vs dense loss: 1e-3
# relative. A wire format vs fp32 after two steps: the JAX tests of the
# same name (tests/test_overlap_wire.py: bf16 loss rtol 5e-3, params rtol
# 5e-2 / atol 4e-2; fp8 loss rtol 5e-2, params rtol 5e-1 / atol 5e-2).
KNOB_STEPS = 2
KNOB_CHUNK = 4096
TOL_CHUNK = 1e-3
TOL_WIRE = {"bf16": dict(loss_rtol=5e-3, rtol=5e-2, atol=4e-2),
            "fp8": dict(loss_rtol=5e-2, rtol=5e-1, atol=5e-2)}
# The bad-step guard (guard): the fused ResNet-50 at batch 128; the step
# time with the guard off and on, in turns.
GUARD_TIMED_PAIRS = 4
# The bench entry (bench): python -m horovod_tpu_torch.bench with these
# arguments, each in a process of its own; its metric names per run.
BENCH_RUNS = (((), ("resnet50_synthetic_images_per_sec_per_gpu",
                    "transformer_lm_tokens_per_sec_per_gpu")),
              (("--zero", "--overlap"),
               ("resnet50_synthetic_images_per_sec_per_gpu",
                "transformer_lm_tokens_per_sec_per_gpu")),
              (("--model", "resnet50", "--conv-backend", "fused"),
               ("resnet50_synthetic_images_per_sec_per_gpu",)),
              (("--model", "transformer_lm", "--accum-steps", "2"),
               ("transformer_lm_tokens_per_sec_per_gpu",)))
BENCH_TIMEOUT = 400
# The --scaling sweep through the launcher: one world of 1 on one card.
BENCH_SCALING = ("--scaling", "--model", "resnet50")
# ZeRO-1 and overlap (zero_overlap): ZO_STEPS steps per variant from one
# seed on a 1-rank NCCL world, where the reduce-scatter and all-gather
# move nothing: every variant's params must equal the plain run's
# bitwise. The full-width LM in four variants, the fused ResNet-50 at
# batch 128 in two; then one ZeRO step with the guard on a NaN batch.
ZO_STEPS = 3
ZO_LM = (("plain", {}), ("zero", dict(zero=True)),
         ("overlap", dict(overlap=True)),
         ("zero_overlap", dict(zero=True, overlap=True)))
ZO_RN = (("plain", {}), ("zero_overlap", dict(zero=True, overlap=True)))
# The Trainer and its checkpoints (trainer): the fused ResNet-50 at batch
# 128 through Trainer.fit, TR_EPOCHS epochs of TR_STEPS steps on the
# bench's fixed synthetic batch, a save per epoch (max_to_keep
# TR_KEEP); then the round trip, one resumed epoch from the restored and
# from the live state, three corruptions and the bad-step budget
# (HVD_MAX_BAD_STEPS=TR_BAD_BUDGET). TR_TIMED steps of the bare loop and
# of the Trainer, in turns, for the Trainer's overhead; TR_STALL_STEPS
# steps after a synchronous and after an async save for the stall.
TR_EPOCHS, TR_STEPS, TR_KEEP, TR_PREFETCH = 2, 4, 2, 2
TR_BAD_BUDGET = 2
TR_TIMED, TR_STALL_STEPS = 10, 4
# The LM checkpoint to serving chain (lm_ckpt_serve): CK_STEPS ZeRO steps
# of the full-width LM, save_sharded, restore into a fresh state, one more
# step from each; restore_for_inference into engines of CK_SLOTS slots,
# CK_REQUESTS greedy requests of CK_NEW_TOKENS new tokens.
CK_STEPS = 2
CK_SLOTS, CK_REQUESTS, CK_NEW_TOKENS = 8, 4, 16
CK_PROMPT_LENS = (37, 300, 900, 1500)
# The launcher and elastic recovery (elastic): the fused ResNet-50 at
# batch 128 through Trainer.fit under run_with_recovery, EL_EPOCHS
# epochs of EL_EPOCH_STEPS steps, an async commit every EL_COMMIT_EVERY
# steps (durable at each epoch's end), in a world of 1 started by the
# launcher: (a) clean; (b) killed after global step EL_KILL_STEP of
# restart epoch 0 and relaunched once (--restarts 1, no backoff), which
# must resume from EL_RESUME and end bitwise as (a); (c) in this process,
# commits at steps 2 and 4, the step-4 commit's bytes flipped, then NaN
# batches until HVD_MAX_BAD_STEPS=EL_BAD_BUDGET runs out: the rollback
# walks past step 4 to step 2, then EL_AFTER finite steps. EL_STALL_STEPS
# steps after a sync and after an async commit give the stall.
EL_EPOCHS, EL_EPOCH_STEPS, EL_COMMIT_EVERY = 2, 4, 2
EL_KILL_STEP, EL_RESUME = 5, 4
EL_BAD_BUDGET, EL_AFTER, EL_STALL_STEPS = 2, 2, 4
EL_TIMEOUT = 300
# The mesh axes (slice 13) on one card.
MESH_STEPS = 5
MZ_STEPS = 4             # lm_mesh_zero: steps of each variant (p50 of the last 3)
MZ_FOUR = (("dp_zero", False, dict(zero=True)), ("plain", True, {}),
           ("zero", True, dict(zero=True)),
           ("overlap", True, dict(overlap=True)),
           ("zero_overlap", True, dict(zero=True, overlap=True)))
MZ_PP = (("plain", {}), ("zero", dict(zero=True)),
         ("overlap", dict(overlap=True)),
         ("zero_overlap", dict(zero=True, overlap=True)))
MESH_RING_BATCH = 2      # the ring's f32 [B,16,2048,2048] blocks: B=8 OOMs
MESH_TP = (2, 4)         # tp sizes whose per-rank flash shapes are timed
TOL_RING_LOSS = 5e-3     # ring (f32 blocks) vs flash (bf16 P) loss, rel
# The trainer phase's bare-loop step p50, which the elastic phase prints
# beside its launched Trainer's.
TRAINER_BARE_P50 = {}
REPLACES = {
    "flash_attention": "horovod_tpu/ops/pallas_attention.py:101",
    "flash_attention_qkv_fwd": "horovod_tpu/ops/pallas_attention.py:101",
    "flash_bwd_dq": "horovod_tpu/ops/pallas_attention.py:163",
    "flash_bwd_dkv": "horovod_tpu/ops/pallas_attention.py:206",
    "flash_attention_lse": "horovod_tpu/ops/pallas_attention.py:462",
    "flash_bwd_dq_bhtd": "horovod_tpu/ops/pallas_attention.py:250",
    "flash_bwd_dkv_bhtd": "horovod_tpu/ops/pallas_attention.py:250",
    "paged_decode_attention": "horovod_tpu/ops/pallas_paged_attention.py:57",
    "fused_conv_bn_fwd": "horovod_tpu/ops/pallas_conv.py:81",
    "fused_conv_bn_bwd": "horovod_tpu/ops/pallas_conv.py:116",
}
SOURCES = {
    "flash_attention": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "flash_attention_qkv_fwd":
        "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "flash_bwd_dkv": "horovod_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "flash_attention_lse": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "flash_bwd_dq_bhtd": "horovod_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "flash_bwd_dkv_bhtd":
        "horovod_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "paged_decode_attention":
        "horovod_tpu_torch/ops/csrc/paged_attention.cu",
    "fused_conv_bn_fwd": "horovod_tpu_torch/ops/csrc/fused_conv_bn.cu",
    "fused_conv_bn_bwd": "horovod_tpu_torch/ops/csrc/fused_conv_bn.cu",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def peaks_for(name: str):
    """Published dense peaks (bf16 tensor-core FLOP/s, memory bytes/s) of
    the card called ``name`` (``utils/flops.py``)."""
    from horovod_tpu_torch.utils.flops import peaks_for as peaks
    return peaks(name)


def time_ms(fn, reps: int = 15, inner: int = 10,
            queued: bool = False) -> float:
    """Median per-call device time of ``fn`` (CUDA events, warmed up).
    ``queued``: each sample's calls are enqueued behind a 2 ms sleep on
    the stream, so that a kernel shorter than its host call is timed
    back to back on the device, not at the host's pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(4_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return float(np.median(samples))


def host_ms(fn, n: int = 200) -> float:
    """Host time per call of ``fn``: the wall time of ``n`` calls that
    enqueue without waiting (the device runs behind), over ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / n * 1e3


def bound_ms(flops: float, nbytes: float, peaks) -> tuple:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def device_profile(run) -> tuple:
    """Run ``run()`` once under ``torch.profiler`` (CUDA activity): its
    wall time and the (device us, name, count) rows by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    return wall_s, rows


def busy_shares(rows, wall_s: float, patterns: dict) -> dict:
    """Device busy time and share of the wall time, and for each named
    pattern the device time and launches of the kernels whose name holds
    it and their share of the busy time."""
    busy_us = sum(r[0] for r in rows)
    out = {"device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / 1e6 / wall_s if rows else None}
    for key, pattern in patterns.items():
        hits = [r for r in rows if pattern in r[1]]
        us = sum(r[0] for r in hits)
        out[key] = {"ms": us / 1e3, "launches": sum(r[2] for r in hits),
                    "share": us / busy_us if busy_us else None}
    return out


# -- phase inputs ------------------------------------------------------------

def flash_inputs(T: int, gen: torch.Generator):
    """q/k/v as the engine hands them to the kernel: strided views of the
    [1, T, H, 3, d] projection output."""
    qkv = torch.randn((1, T, LM["n_heads"], 3, 128), generator=gen,
                      device="cuda").to(torch.bfloat16)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def paged_inputs(positions, gen: torch.Generator, layers: int = 0,
                 bs: int = BLOCK):
    """The engine's pool (one layer's, or ``layers`` layers' stacked; in
    blocks of ``bs``), random tables over blocks 1.. (block 0 is the trash
    block) and q, for ``len(positions)`` slots."""
    nb = -(-MAX_LEN // bs)
    n_blocks = MAX_SLOTS * nb + 1
    H, S = LM["n_heads"], len(positions)
    shape = (layers,) * bool(layers) + (n_blocks, bs, H, 128)
    pool = lambda: torch.randn(shape, generator=gen, device="cuda",  # noqa: E731
                               dtype=torch.bfloat16)
    q = torch.randn((S, H, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tables = torch.randint(1, n_blocks, (S, nb), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, pool(), pool(), tables, pos


def paged_chunk(S: int, bs: int = BLOCK) -> int:
    """Keys of one chunk of the kernel's split plan at S slots."""
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.paged_attention import split_plan
    return split_plan(S, LM["n_heads"], -(-MAX_LEN // bs), bs,
                      _build.sm_count(torch.device("cuda"))).chunk_keys


# -- phases -------------------------------------------------------------------

def phase_device():
    if torch.cuda.device_count() < 1:
        raise RuntimeError("no CUDA device")
    line = smi_line()
    print(line, flush=True)
    try:
        nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        nvcc = nvcc.splitlines()[-1]
    except (OSError, IndexError):
        nvcc = None
    # The unembed is an f32 product: it must run in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=line, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return line


def ptxas_summary(log: str, needle: str) -> dict:
    """Registers, shared memory and spills per kernel whose mangled name
    holds ``needle``, from the ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            hit = re.search(r"\d+([a-z_]+kernel)((?:L[ib]\d+E)*)",
                            mangled.replace("IL", "L", 1))
            name = None
            if needle in mangled and hit:
                args = re.findall(r"L[ib](\d+)E", hit.group(2))
                name = hit.group(1) + (f"<{','.join(args)}>" if args
                                       else "")
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                      line)
        if m:     # dynamic shared memory is not in the static smem count
            out[name]["registers"] = int(m.group(1))
            out[name]["smem_bytes"] = int(m.group(2) or 0)
    return out


def phase_build():
    from horovod_tpu_torch.ops import _build
    t0 = time.monotonic()
    path = _build.build()
    lib = _build.library()
    secs = time.monotonic() - t0
    with open(path + ".log") as f:
        log = f.read()
    # ptxas names the kernels whose wgmma it had to serialize: they would
    # still be right, at a fraction of their rate.
    serialized = [ln.strip() for ln in log.splitlines()
                  if "serialized" in ln]
    flash = ptxas_summary(log, "flash")
    conv = ptxas_summary(log, "conv_bn")
    paged = ptxas_summary(log, "paged")
    emit("build", seconds=secs, library=path, compiler_log=path + ".log",
         fused_conv_bn_ptxas=conv,
         flash_ptxas=flash, paged_ptxas=paged,
         flash_dynamic_smem_bytes={
             "flash_fwd_wgmma_kernel":
                 lib.hvd_flash_attention_fwd_smem_bytes(),
             "flash_bwd_dq_kernel": lib.hvd_flash_bwd_dq_smem_bytes(),
             "flash_bwd_dkv_kernel": lib.hvd_flash_bwd_dkv_smem_bytes()},
         ptxas_serialized=serialized)
    check(not serialized, "; ".join(serialized))
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        check(name in flash, f"ptxas reported no {name}")
    for name in CONV_KERNELS.values():
        check(any(k.startswith(name) for k in conv),
              f"ptxas reported no {name}")
    check("paged_decode_split_kernel" in paged,
          "ptxas reported no paged_decode_split_kernel")
    spilled = {k: v for k, v in {**flash, **conv, **paged}.items()
               if v.get("spill_stores") or v.get("spill_loads")}
    check(not spilled, f"flash, conv or paged kernels spill: {spilled}")


def phase_parity(seed: int):
    from horovod_tpu_torch.ops.attention import (flash_attention_prefill,
                                                 flash_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs, rows = {}, {}
    for T in FLASH_T_PARITY:
        q, k, v = flash_inputs(T, gen)
        out = flash_attention_prefill(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal=True)
        err = (out.float() - ref.float()).abs().max().item()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"flash_attention T={T}: bad output")
        errs[f"T{T}"] = err
        check(err <= TOL_FLASH, f"flash_attention T={T}: max abs err "
                                f"{err} > {TOL_FLASH}")
        rows[f"T{T}"] = row_ulps(out, ref)
        check(rows[f"T{T}"] <= TOL_ATTN_ULPS,
              f"flash_attention T={T}: a row is {rows[f'T{T}']} bf16 ulps "
              f"of its largest value off > {TOL_ATTN_ULPS}")
    flash_err = max(errs.values())
    emit("parity", kernel="flash_attention", max_abs_err=errs,
         tolerance=TOL_FLASH, row_ulps=rows, row_tolerance=TOL_ATTN_ULPS,
         shapes="B=1 H=16 d=128 bf16 causal")
    e = paged_chunk(MAX_SLOTS)
    rng = np.random.RandomState(seed)
    cases = (
        ("engine", [-1, 0, 15, 16, MAX_LEN - 1]
         + [int(p) for p in rng.randint(0, MAX_LEN, 3)]),
        # both sides of the first split edges; a slot whose later splits
        # are empty; a position past the table's keys
        ("split_edges", [e - 1, e, e + 1, 2 * e - 1, 2 * e, 3, MAX_LEN - e,
                         2 * MAX_LEN]),
        ("tables", [300, 40, 700, 5, 1000, 17, 64, MAX_LEN - 1]),
        ("one_slot", [MAX_LEN - 1]),
        ("full", [MAX_LEN - 1] * MAX_SLOTS))
    # Block sizes the engine does not use: several boxes a tile (1, 8),
    # 12-key tiles (12), two boxes a block (32).
    mixed = [-1, 0, 5, 100, 1000, MAX_LEN - 1, 333, 64]
    paged_err = max([paged_parity(name, positions, gen)
                     for name, positions in cases]
                    + [paged_parity(f"bs{bs}", mixed, gen, bs)
                       for bs in PAGED_PARITY_BS])
    return {"flash_attention": flash_err,
            "paged_decode_attention": paged_err}


def paged_parity(name: str, positions, gen, bs: int = BLOCK) -> float:
    """K8 against the dense plain version and the split plain version at
    the kernel's chunk: max abs error and each row's error in bf16 ulps of
    its own largest value; ATTN_REPEATS launches bitwise equal. The
    ``tables`` case repeats one physical block through slot 0's row,
    alternates two through slot 1's, and trash-pads every row past pos's
    block with block 0, which holds PAGED_TRASH."""
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_attention_split_reference,
        paged_decode_attention)
    q, kp, vp, tables, pos = paged_inputs(positions, gen, bs=bs)
    if name == "tables":
        nb = MAX_LEN // BLOCK
        tables[0] = tables[0, 0]
        tables[1] = tables[1, :2].repeat(nb // 2)
        used = torch.tensor([p // BLOCK + 1 for p in positions],
                            device="cuda")
        tables[torch.arange(nb, device="cuda")[None, :]
               >= used[:, None]] = 0
        kp[0] = PAGED_TRASH
        vp[0] = PAGED_TRASH
    outs = [paged_decode_attention(q, kp, vp, tables, pos)
            for _ in range(ATTN_REPEATS)]
    torch.cuda.synchronize()
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    out = outs[0]
    chunk = paged_chunk(len(positions), bs)
    ref = paged_attention_reference(q, kp, vp, tables, pos)
    split = paged_attention_split_reference(q, kp, vp, tables, pos, chunk)
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"paged_decode_attention {name}: bad output")
    errs = {"max_abs_err": _abs_err(out, ref), "row_ulps": row_ulps(out, ref),
            "split_max_abs_err": _abs_err(out, split),
            "split_row_ulps": row_ulps(out, split)}
    emit("parity", kernel="paged_decode_attention", case=name,
         S=len(positions), positions=list(positions), block_size=bs,
         chunk_keys=chunk, **errs, tolerance=TOL_PAGED,
         row_tolerance=TOL_ATTN_ULPS, bitwise_repeatable=same,
         launches_compared=ATTN_REPEATS,
         shapes=f"H=16 d=128 {tables.shape[1]} blocks/slot bf16")
    for i, p in enumerate(positions):
        if p < 0:
            check(not out[i].any(), f"paged_decode_attention {name}: "
                                    f"pos=-1 row not zero")
    check(same, f"paged_decode_attention {name}: {ATTN_REPEATS} launches "
                f"differ")
    for key, val in errs.items():
        tol = TOL_ATTN_ULPS if "ulps" in key else TOL_PAGED
        check(val <= tol, f"paged_decode_attention {name}: {key} {val} > "
                          f"{tol}")
    del outs, out, ref, split, q, kp, vp
    torch.cuda.empty_cache()
    return errs["max_abs_err"]


def _http_generate(port: int, tokens, out: dict) -> None:
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [int(t) for t in tokens],
             "max_new_tokens": NEW_TOKENS}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        out["lines"] = [json.loads(x) for x in
                        resp.read().decode().strip().splitlines()]
        conn.close()
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        out["error"] = repr(e)


def profile_round(eng, prompts) -> dict:
    """Serve ``prompts`` again under ``torch.profiler`` (CUDA activity):
    device busy share = summed kernel/copy device time over the wall
    time of the round (one stream, so device work does not overlap), the
    prefill and decode kernels' device time, and the top entries by
    device time. Null when the profiler records no device time (tracing
    is unavailable)."""
    def serve():
        for h in [eng.submit(p) for p in prompts]:
            h.result(600)
    wall_s, rows = device_profile(serve)
    return {"wall_s": wall_s,
            **busy_shares(rows, wall_s, {"k3_fwd": "flash_fwd_wgmma_kernel",
                                         "k8": "paged_decode"}),
            "top": [{"name": k[:80], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:8]]}


def build_model(seed: int):
    from horovod_tpu_torch.parallel.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(**LM, dtype=torch.bfloat16,
                            unembed_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return Transformer(cfg, generator=gen, device="cuda")


def phase_engine(model, seed: int):
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.serve import (GenerationConfig, GenerationEngine,
                                         HttpServer)
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, GenerationConfig(
        max_slots=MAX_SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        default_max_new_tokens=NEW_TOKENS, max_queue=64), device="cuda")
    srv = None
    try:
        t0 = time.monotonic()
        eng.warmup()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(0, cfg.vocab, n) for n in PROMPT_LENS]
        http_prompt = rng.randint(0, cfg.vocab, HTTP_PROMPT_LEN)
        srv = HttpServer(eng).start()
        steps0 = eng.stats()["batches_total"]
        http_out: dict = {}
        LAUNCHES.reset()
        t0 = time.monotonic()
        handles = [eng.submit(p) for p in prompts]
        th = threading.Thread(target=_http_generate,
                              args=(srv.port, http_prompt, http_out))
        th.start()
        results = [h.result(600) for h in handles]
        th.join(600)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        launches = LAUNCHES.snapshot()
        stats = eng.stats()
        profiled = profile_round(eng, prompts + [http_prompt])
    finally:
        if srv is not None:
            srv.stop()
        eng.shutdown()
    check(not th.is_alive(), "HTTP request did not finish")
    check("error" not in http_out and http_out.get("status") == 200,
          f"HTTP /generate failed: {http_out}")
    lines = http_out["lines"]
    check(lines[-1].get("done") is True
          and [x["token"] for x in lines[:-1]] == lines[-1]["tokens"]
          and lines[-1]["n_tokens"] == NEW_TOKENS,
          f"HTTP stream malformed: {lines[-1]}")
    results.append({k: v for k, v in lines[-1].items() if k != "done"})
    for r in results:
        check(r["n_tokens"] == NEW_TOKENS and r["finish_reason"] == "length",
              f"request did not finish: {r}")
        check(all(0 <= t < cfg.vocab for t in r["tokens"]),
              "token out of range")
    n_req = len(results)
    steps = stats["batches_total"] - steps0
    k3 = launches.get("flash_attention", 0)
    k8 = launches.get("paged_decode_attention", 0)
    check(k3 == cfg.n_layers * n_req,
          f"flash_attention launched {k3} times, expected "
          f"{cfg.n_layers} x {n_req} prefills")
    check(k8 == cfg.n_layers * steps and steps > 0,
          f"paged_decode_attention launched {k8} times, expected "
          f"{cfg.n_layers} x {steps} decode steps")
    blocks = eng.stats()["blocks"]      # after the drain: no stream left
    check(blocks["used"] == 0, f"blocks still held after drain: {blocks}")
    decode_tps = (stats["batch_live_rows_total"]
                  / stats["execute_seconds_total"])
    ttft = sorted(r["ttft_ms"] for r in results)
    emit("engine", requests=n_req, prompt_lens=list(PROMPT_LENS)
         + [HTTP_PROMPT_LEN], new_tokens=NEW_TOKENS, warmup_s=warm_s,
         wall_s=wall_s, decode_steps=steps, launches=launches,
         ttft_ms=ttft, ttft_p50_ms=float(np.median(ttft)),
         decode_step_ms_p50=stats["latency_ms"]["execute_p50"],
         decode_tokens_per_s=decode_tps,
         tokens_per_s_per_stream_p50=stats["generation"][
             "tokens_per_sec_user_p50"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         blocks=blocks)
    emit("engine_profile", **profiled)
    return launches


def phase_e2e(model, seed: int):
    """A 256-token prompt + 4 decode steps through the same port
    functions on the card (kernels) and on the CPU (plain versions)."""
    from horovod_tpu_torch.parallel.kv_blocks import (blocks_for,
                                                      init_paged_kv_cache,
                                                      paged_decode_step,
                                                      paged_prefill)
    from horovod_tpu_torch.parallel.transformer import gen_weights
    cfg = model.cfg
    T, steps = 256, 4
    rng = np.random.RandomState(seed + 1)
    prompt = rng.randint(0, cfg.vocab, T).astype(np.int32)
    feed = rng.randint(0, cfg.vocab, steps).astype(np.int32)
    nb = blocks_for(T + steps, BLOCK)
    row = np.arange(1, nb + 1, dtype=np.int32)

    def run(m, device):
        with torch.no_grad():
            w = gen_weights(m)
            cache = init_paged_kv_cache(cfg, nb + 1, BLOCK, 1, device=device)
            t = lambda a: torch.tensor(a, device=device)  # noqa: E731
            _, lg = paged_prefill(w, t(prompt), cache, 0, t(row), cfg)
            out = [lg[T - 1].float().cpu()]
            for i in range(steps):
                _, lg = paged_decode_step(
                    w, t(feed[i:i + 1]), cache, t(np.array([T + i], np.int32)),
                    t(row[None]), cfg)
                out.append(lg[0].float().cpu())
        return torch.stack(out)

    t0 = time.monotonic()
    card = run(model, "cuda")
    card_s = time.monotonic() - t0
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.monotonic()
    cpu = run(cpu_model, "cpu")
    cpu_s = time.monotonic() - t0
    del cpu_model
    check(bool(torch.isfinite(card).all()), "card logits not finite")
    diff = (card - cpu).abs().max().item()
    top_card = card.argmax(-1).tolist()
    top_cpu = cpu.argmax(-1).tolist()
    srt = cpu[-1].sort(descending=True).values
    emit("e2e", positions=T + steps, max_abs_diff=diff, bound=TOL_E2E,
         top1_card=top_card, top1_cpu=top_cpu,
         cpu_top1_margin=float(srt[0] - srt[1]), logits_std=float(
             cpu[-1].std()), card_s=card_s, cpu_s=cpu_s)
    check(diff <= TOL_E2E, f"e2e logits differ by {diff} > {TOL_E2E}")
    check(top_card[-1] == top_cpu[-1], "e2e top-1 differs")


def phase_timing(seed: int, peaks):
    from horovod_tpu_torch.ops.attention import (flash_attention_prefill,
                                                 flash_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    H, d = LM["n_heads"], 128
    rows = {}
    for T in FLASH_T:
        q, k, v = flash_inputs(T, gen)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: flash_attention_prefill(q, k, v, causal=True))
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, causal=True), reps=5, inner=2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4.0 * d * H * T * (T + 1) / 2
        nbytes = 4.0 * T * H * d * 2
        bnd, by = bound_ms(flops, nbytes, peaks)
        rows[T] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
        host = host_ms(lambda: flash_attention_prefill(q, k, v, causal=True))
        emit("timing", kernel="flash_attention", T=T, **rows[T],
             host_ms_per_call=host,
             library="torch.nn.functional.scaled_dot_product_attention")
    return {"flash_attention": rows[max(FLASH_T)],
            "paged_decode_attention": phase_timing_paged(seed, peaks)}


def phase_timing_paged(seed: int, peaks):
    """K8 at each PAGED_TIMED shape: its median device time, launch after
    launch through the 8 layer views of the engine's whole pool (each
    launch, as in a decode step, finds its K/V out of L2) and queued
    behind a sleep (the kernel is shorter than its host call), beside its
    bound, its plain version's time and its host time per call. Returns
    the balanced row (the kernels line's)."""
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    H, d, L = LM["n_heads"], 128, LM["n_layers"]
    rng = np.random.RandomState(seed + 3)
    rows = {}
    for name, positions in PAGED_TIMED:
        if positions is None:
            positions = tuple(int(p) for p in rng.randint(896, 1152,
                                                          MAX_SLOTS))
        q, kp, vp, tables, pos = paged_inputs(positions, gen, layers=L)
        views = [(kp[i], vp[i]) for i in range(L)]
        turn = itertools.cycle(views).__next__

        def run():
            k, v = turn()
            return paged_decode_attention(q, k, v, tables, pos)
        ms = time_ms(run, queued=True)
        host = host_ms(run)
        plain = time_ms(lambda: paged_attention_reference(
            q, kp[0], vp[0], tables, pos), reps=5, inner=2)
        keys = sum(min(p, MAX_LEN - 1) + 1 for p in positions if p >= 0)
        flops = 4.0 * d * H * keys
        nbytes = (keys * H * d * 2 * 2 + 2 * q.numel() * 2
                  + tables.numel() * 4)
        bnd, by = bound_ms(flops, nbytes, peaks)
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                          bound_ms=bnd, bound_by=by)
        emit("timing", kernel="paged_decode_attention", shape=name,
             S=len(positions), positions=list(positions), keys=keys,
             **rows[name], share_of_bound=bnd / ms, host_ms_per_call=host,
             library=None)
        del q, kp, vp, views
        torch.cuda.empty_cache()
    return rows["balanced"]


# -- ResNet-50 training (slice 2) ---------------------------------------------

def conv_inputs(M, cin, cout, prologue, gen, o1: bool = False):
    """One site's operands at the model's dtypes: bf16 x, f32 [Cout, Cin]
    weight, f32 affine, and the backward's bf16 dy with small non-zero
    stats cotangents (``o1``: b and ds1 of order 1)."""
    x = torch.randn((M, cin), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((cout, cin), generator=gen, device="cuda") * cin ** -0.5
    a = b = None
    if prologue:
        a = torch.rand((cin,), generator=gen, device="cuda") + 0.5
        b = torch.randn((cin,), generator=gen, device="cuda") * (
            1.0 if o1 else 0.5)
    dy = torch.randn((M, cout), generator=gen,
                     device="cuda").to(torch.bfloat16)
    ds1 = torch.randn((cout,), generator=gen, device="cuda") * (
        1.0 if o1 else 1e-3)
    ds2 = torch.randn((cout,), generator=gen, device="cuda") * 1e-4
    return x, w, a, b, dy, ds1, ds2


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()
            .clamp_min(1e-30)).item()


def phase_parity_conv(seed: int):
    from horovod_tpu_torch.ops import fused_conv_bn as fcb
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    worst = {k: 0.0 for k in TOL_CONV}
    abs_err = {"fused_conv_bn_fwd": 0.0, "fused_conv_bn_bwd": 0.0}
    cases = [(shape, False) for shape in CONV_SHAPES + CONV_EDGE] + [
        (shape, True) for shape in CONV_RAGGED_O1]
    for (M, cin, cout, pro), o1 in cases:
        x, w, a, b, dy, ds1, ds2 = conv_inputs(M, cin, cout, pro, gen, o1)
        fwd = fcb.fused_linear_bn_act_fwd(x, w, a, b)
        bwd = fcb.fused_linear_bn_act_bwd(x, w, a, b, fwd[0], dy, ds1, ds2)
        fwd2 = fcb.fused_linear_bn_act_fwd(x, w, a, b)
        bwd2 = fcb.fused_linear_bn_act_bwd(x, w, a, b, fwd[0], dy, ds1, ds2)
        torch.cuda.synchronize()
        rfwd = fcb.fused_linear_bn_act_reference(x, w, a, b)
        rbwd = fcb.fused_linear_bn_act_bwd_reference(x, w, a, b, fwd[0], dy,
                                                     ds1, ds2)
        errs = {}
        for name, got, ref in zip(("y", "s1", "s2", "dx", "dw", "da", "db"),
                                  fwd + bwd, rfwd + rbwd):
            if ref is None:
                continue
            check(got is not None and got.shape == ref.shape
                  and bool(torch.isfinite(got).all()),
                  f"conv {M}x{cin}->{cout}: bad {name}")
            errs[name] = _rel_err(got, ref)
            worst[name] = max(worst[name], errs[name])
            check(errs[name] <= TOL_CONV[name],
                  f"conv {M}x{cin}->{cout} prologue={pro}: {name} error "
                  f"{errs[name]} > {TOL_CONV[name]}")
        abs_err["fused_conv_bn_fwd"] = max(
            abs_err["fused_conv_bn_fwd"],
            (fwd[0].float() - rfwd[0].float()).abs().max().item())
        abs_err["fused_conv_bn_bwd"] = max(
            abs_err["fused_conv_bn_bwd"],
            (bwd[0].float() - rbwd[0].float()).abs().max().item())
        same = all(torch.equal(p, q) for p, q in zip(
            fwd + bwd, fwd2 + bwd2) if p is not None)
        check(same, f"conv {M}x{cin}->{cout}: two launches differ")
        emit("parity_conv", M=M, cin=cin, cout=cout, prologue=pro,
             o1_cotangent=o1, rel_err=errs, bitwise_repeatable=same,
             y_max_abs_err=(fwd[0].float() - rfwd[0].float()).abs().max()
             .item())
    emit("parity_conv_summary", worst_rel_err=worst, tolerance=TOL_CONV,
         max_abs_err=abs_err, deterministic=True,
         note="rel_err = max|kernel-plain|/max|plain|; max_abs_err is y "
              "for K1 and dx for K2")
    return abs_err


def synthetic_batch(batch: int, seed: int):
    """bench.py's synthetic data: standard-normal images and uniform
    labels from a seeded numpy generator, one fixed batch, on the card."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((batch, RN_IMAGE, RN_IMAGE, 3)).astype(
        np.float32)
    y = rng.randint(0, RN_CLASSES, size=(batch,))
    return (torch.from_numpy(x).to("cuda"), torch.from_numpy(y).to("cuda"))


def build_resnet(backend: str, seed: int, device="cuda"):
    from horovod_tpu_torch.models import resnet50
    return resnet50(RN_CLASSES, conv_backend=backend, device=device,
                    generator=torch.Generator().manual_seed(seed))


def train_run(backend: str, seed: int, data):
    """Warmup, then timed steps; returns the report and the state."""
    import functools
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    torch.cuda.reset_peak_memory_stats()
    model = build_resnet(backend, seed)
    state = create_train_state(model, functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))
    hvd.broadcast_parameters(model)
    step = make_train_step()
    losses = []
    for _ in range(RN_WARMUP):
        state, metrics = step(state, data)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    LAUNCHES.reset()
    times = []
    for _ in range(RN_STEPS):
        t0 = time.monotonic()
        state, metrics = step(state, data)
        losses.append(metrics["loss"].item())
        times.append(time.monotonic() - t0)
    launches = LAUNCHES.snapshot()
    p50 = float(np.median(times))
    report = dict(backend=backend, batch=RN_BATCH, image=RN_IMAGE,
                  warmup=RN_WARMUP, steps=RN_STEPS, losses=losses,
                  step_ms=[t * 1e3 for t in times], step_ms_p50=p50 * 1e3,
                  images_per_s=RN_BATCH / p50,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches=launches, world=hvd.size())
    check(all(np.isfinite(losses)), f"{backend}: loss not finite {losses}")
    check(losses[-1] < losses[0], f"{backend}: loss did not fall {losses}")
    return report, state


def phase_train(seed: int):
    import horovod_tpu_torch as hvd
    hvd.init()
    check(hvd.size() == 1 and hvd.rank() == 0, "expected a 1-rank world")
    data = synthetic_batch(RN_BATCH, seed)
    fused, state = train_run("fused", seed, data)
    k1 = fused["launches"].get("fused_conv_bn_fwd", 0)
    k2 = fused["launches"].get("fused_conv_bn_bwd", 0)
    check(k1 == k2 == RN_SITES * RN_STEPS,
          f"fused step launched K1 {k1}, K2 {k2} times; expected "
          f"{RN_SITES} x {RN_STEPS}")
    emit("train", **fused)
    profiled = profile_train_step(state, data)
    emit("train_profile", **profiled)
    del state
    torch.cuda.empty_cache()
    stock, state = train_run("xla", seed, data)
    check(not any(k.startswith("fused_conv_bn")
                  for k in stock["launches"]),
          f"stock step launched the fused kernels: {stock['launches']}")
    emit("train", **stock)
    del state, data
    torch.cuda.empty_cache()
    hvd.shutdown()
    return fused["launches"]


def profile_train_step(state, data) -> dict:
    """One fused step under ``torch.profiler`` (CUDA activity only):
    device busy share = summed kernel time over the step's wall time,
    top kernels, and the shares of K1's and K2's kernels (the reduction
    and W-rounding kernels they share are reported on their own)."""
    from horovod_tpu_torch.training import make_train_step
    step = make_train_step()

    def one_step():
        step(state, data)[1]["loss"].item()
    wall_s, rows = device_profile(one_step)
    return {"wall_ms": wall_s * 1e3, **busy_shares(rows, wall_s,
                                                   CONV_KERNELS),
        "top": [{"name": k[:90], "ms": us / 1e3, "count": n}
                for us, k, n in rows[:12]]}


def _one_step(model, x, y):
    """One plain train step (no world: the e2e check compares the model
    and its kernels, not the collective): forward, loss, backward, SGD."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.training import cross_entropy_loss
    opt = torch.optim.SGD([p for _, p in convert.jax_leaf_order(model)],
                          lr=0.1, momentum=0.9)
    logits = model(x, train=True)
    loss = cross_entropy_loss(logits, y)
    loss.backward()
    opt.step()
    return loss.item(), logits.detach().float().cpu()


# Leaves whose gradient is non-zero at flax's init (each block's last
# BatchNorm scale starts at 0, which zeroes the gradients of the block's
# inner convs): the stem, the fused shortcut convs of stages 0 and 1, the
# zero-initialised scales themselves, the head.
E2E_PARAMS = ("stem.kernel", "BottleneckBlock_0.shortcut.kernel",
              "BottleneckBlock_3.shortcut.kernel",
              "BottleneckBlock_1.BatchNorm_2.scale",
              "BottleneckBlock_5.BatchNorm_2.scale",
              "BottleneckBlock_15.BatchNorm_2.scale", "head.kernel")
E2E_STATS = ("stem_bn.var", "BottleneckBlock_0.BatchNorm_0.mean",
             "BottleneckBlock_2.BatchNorm_2.var",
             "BottleneckBlock_3.shortcut_bn.mean",
             "BottleneckBlock_15.BatchNorm_1.var")


def phase_e2e_train(seed: int):
    """Full-width ResNet-50 at flax's init, batch 8 at 224²: every one of
    the 16 sites still fuses. One step on the card (kernels) and on the
    CPU (plain versions) from the same weights and batch. (With every
    residual branch switched on, a random ResNet-50's bf16 gradient at
    batch 8 is dominated by rounding — card and CPU, or bf16 and f32,
    disagree in direction — so the check runs where flax starts.)"""
    from horovod_tpu_torch.ops import LAUNCHES
    card = build_resnet("fused", seed + 1)
    cpu = copy.deepcopy(card).to("cpu")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    x, y = synthetic_batch(RN_E2E_BATCH, seed + 3)
    LAUNCHES.reset()
    t0 = time.monotonic()
    loss_card, logits_card = _one_step(card, x, y)
    card_s = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    check(launches.get("fused_conv_bn_fwd") == RN_SITES
          and launches.get("fused_conv_bn_bwd") == RN_SITES,
          f"e2e step at batch {RN_E2E_BATCH} did not fuse every site: "
          f"{launches}")
    t0 = time.monotonic()
    loss_cpu, logits_cpu = _one_step(cpu, x.cpu(), y.cpu())
    cpu_s = time.monotonic() - t0
    check(bool(torch.isfinite(logits_card).all()), "card logits not finite")
    cp, pp = dict(card.named_parameters()), dict(cpu.named_parameters())
    cb, pb = dict(card.named_buffers()), dict(cpu.named_buffers())
    rel = lambda a, b: _rel_err(a.detach().cpu(), b.detach())  # noqa: E731
    diffs = {"loss": abs(loss_card - loss_cpu),
             "logits": (logits_card - logits_cpu).abs().max().item(),
             "param_updates": {n: rel(cp[n].cpu() - before[n],
                                      pp[n] - before[n])
                               for n in E2E_PARAMS},
             "batch_stats": {n: rel(cb[n], pb[n]) for n in E2E_STATS}}
    upd_card = torch.cat([(cp[n].detach().cpu() - before[n]).flatten()
                          for n in before])
    upd_cpu = torch.cat([(pp[n].detach() - before[n]).flatten()
                         for n in before])
    cosine = F.cosine_similarity(upd_card, upd_cpu, dim=0).item()
    emit("e2e_train", batch=RN_E2E_BATCH, loss_card=loss_card,
         loss_cpu=loss_cpu, logits_std=logits_cpu.std().item(),
         diffs=diffs, update_cosine=cosine, tolerance=TOL_E2E_TRAIN,
         launches=launches,
         card_s=card_s, cpu_s=cpu_s,
         note="param_updates: max|card-cpu|/max|cpu| of the step's change "
              "to each leaf; batch_stats: the same of the running stats")
    check(diffs["loss"] <= TOL_E2E_TRAIN["loss"],
          f"e2e loss differs by {diffs['loss']}")
    check(diffs["logits"] <= TOL_E2E_TRAIN["logits"],
          f"e2e logits differ by {diffs['logits']}")
    check(cosine >= TOL_E2E_TRAIN["update_cosine"],
          f"e2e whole-model update cosine {cosine}")
    for key in ("param_updates", "batch_stats"):
        for n, v in diffs[key].items():
            check(v <= TOL_E2E_TRAIN[key], f"e2e {n} differs by {v}")


def phase_timing_conv(seed: int, peaks):
    """K1 and K2 at each of the eight site shapes beside their bounds and
    a GEMM-only yardstick, with the site's launches per step; the plain
    versions at the CONV_TIMED sites; then the per-step sums over the 16
    sites. Bytes: each input read once, each output written once (x, y,
    dy bf16; W, a, b, stats, dW f32)."""
    from horovod_tpu_torch.ops import fused_conv_bn as fcb
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    rows = {}
    step = {k: {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
            for k in ("fused_conv_bn_fwd", "fused_conv_bn_bwd")}
    for (M, cin, cout, pro), per_step in CONV_SITES:
        x, w, a, b, dy, ds1, ds2 = conv_inputs(M, cin, cout, pro, gen)
        y = fcb.fused_linear_bn_act_fwd(x, w, a, b)[0]
        wb = w.to(torch.bfloat16)
        e = dy.clone()
        ab_bytes = 8 * cin if pro else 0
        timed = (M, cin, cout, pro) in CONV_TIMED
        shape = dict(M=M, cin=cin, cout=cout, prologue=pro,
                     launches_per_step=per_step)
        # K1
        ms = time_ms(lambda: fcb.fused_linear_bn_act_fwd(x, w, a, b))
        plain = time_ms(lambda: fcb.fused_linear_bn_act_reference(
            x, w, a, b), reps=5, inner=2) if timed else None
        lib = time_ms(lambda: torch.matmul(x, wb.t()))
        bnd, by = bound_ms(2.0 * M * cin * cout,
                           2.0 * M * (cin + cout) + 4.0 * cin * cout
                           + ab_bytes + 8.0 * cout, peaks)
        k1 = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                  bound_by=by)
        emit("timing", kernel="fused_conv_bn_fwd", **shape, **k1,
             library="torch.matmul [M,Cin]x[Cin,Cout] bf16 (GEMM only, "
                     "not the same function)")
        # K2
        ms = time_ms(lambda: fcb.fused_linear_bn_act_bwd(
            x, w, a, b, y, dy, ds1, ds2))
        plain = time_ms(lambda: fcb.fused_linear_bn_act_bwd_reference(
            x, w, a, b, y, dy, ds1, ds2), reps=5, inner=2) if timed else None
        lib = time_ms(lambda: (torch.matmul(e, wb), torch.matmul(e.t(), x)))
        bnd, by = bound_ms(4.0 * M * cin * cout,
                           2.0 * M * (2 * cin + 2 * cout)
                           + 8.0 * cin * cout + ab_bytes + 8.0 * cout
                           + (8 * cin if pro else 0), peaks)
        k2 = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                  bound_by=by)
        emit("timing", kernel="fused_conv_bn_bwd", **shape, **k2,
             library="torch.matmul e.W and e^T.x bf16 (GEMMs only, not "
                     "the same function)")
        for name, row in (("fused_conv_bn_fwd", k1), ("fused_conv_bn_bwd",
                                                      k2)):
            for key in step[name]:
                step[name][key] += per_step * row[key]
            if (M, cin, cout, pro) == CONV_TIMED[0]:
                rows[name] = row
        del x, w, a, b, dy, ds1, ds2, y, wb, e
    emit("timing_conv_step", per_step=step,
         launches_per_step=sum(n for _, n in CONV_SITES),
         note="sums over the 16 sites of a batch-128 step: launches per "
              "step x ms; library_ms: the GEMM-only yardstick")
    torch.cuda.empty_cache()
    return rows


# -- transformer-LM training (slice 3) ----------------------------------------

def bf16_ulps(got, ref) -> float:
    """max|got - ref| in units of one bf16 ulp of max|ref|."""
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133
    return (got.float() - ref.float()).abs().max().item() / ulp


def row_ulps(got, ref, d: int = 128) -> float:
    """The largest over output rows of d (one head of one position) of
    max|got - ref| in units of one bf16 ulp of that row's max|ref|."""
    g, r = got.float().reshape(-1, d), ref.float().reshape(-1, d)
    top = r.abs().amax(1)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7).clamp_min(2.0 ** -133)
    return ((g - r).abs().amax(1) / ulp).max().item()


def attn_inputs(B: int, T: int, gen: torch.Generator, H: int = 0):
    """The packed projection output qkv [B, T, H*3*d] and a cotangent
    dO [B, T, H*d], bf16 standard normals (H: the LM's heads, or this
    many)."""
    H, d = H or LM["n_heads"], 128
    qkv = torch.randn((B, T, H * 3 * d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    do = torch.randn((B, T, H * d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return qkv, do


def _abs_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def parity_report(phase: str, kernels, run, plain, causal: bool,
                  what: str):
    """Hold one forward-with-lse + dq/dkv kernel set against its plain
    versions. ``run()`` launches the kernels and returns ``(o, lse, dq,
    dk, dv)``; it runs ``ATTN_REPEATS`` times and every result must agree
    bitwise with the first.
    ``plain(o, lse)`` returns the plain versions' five, the backward's
    computed from the kernels' own o and lse2. Emits one ``phase`` line;
    returns the errors (o/dq/dk/dv in bf16 ulps of the largest value, lse
    absolute) and the max |kernel - plain| of each of ``kernels`` (the
    forward's o, dq, and dk/dv)."""
    got = run()
    same = True
    for _ in range(ATTN_REPEATS - 1):
        again = run()
        same = same and all(torch.equal(a, b) for a, b in zip(got, again))
        del again
    ref = plain(got[0], got[1])
    names = ("o", "lse", "dq", "dk", "dv")
    for name, g, r in zip(names, got, ref):
        check(g.shape == r.shape and bool(torch.isfinite(g).all()),
              f"attention {what}: bad {name}")
    errs = {n: (g - r).abs().max().item() if n == "lse" else bf16_ulps(g, r)
            for n, g, r in zip(names, got, ref)}
    errs["o_row"] = row_ulps(got[0], ref[0])
    fwd, dq, dkv = kernels
    abs_err = {fwd: _abs_err(got[0], ref[0]), dq: _abs_err(got[2], ref[2]),
               dkv: max(_abs_err(got[3], ref[3]), _abs_err(got[4], ref[4]))}
    B, T = got[0].shape[:2]
    emit(phase, B=B, T=T, causal=causal, err=errs, max_abs_err=abs_err,
         bitwise_repeatable=same, launches_compared=ATTN_REPEATS,
         note="o/dq/dk/dv in bf16 ulps of the largest value, o_row of "
              "each row's; lse abs")
    check(same, f"attention {what}: {ATTN_REPEATS} launches differ")
    for name, val in errs.items():
        tol = TOL_LSE if name == "lse" else TOL_ATTN_ULPS
        check(val <= tol, f"attention {what}: {name} error {val} > {tol}")
    del got, ref
    torch.cuda.empty_cache()
    return errs, abs_err


def attn_parity(qkv, do, causal: bool, what: str, H: int = 0,
                phase: str = "parity_attn"):
    """K3-qkv (o, lse2) and the dq/dkv pair (the packed d_qkv) on
    ``qkv``/``do`` (H heads: the LM's by default) against their plain
    versions (:func:`parity_report`, one ``phase`` line)."""
    from horovod_tpu_torch.ops import attention as A
    H, d = H or LM["n_heads"], 128
    B, T = qkv.shape[:2]

    def run():
        o, lse = A.flash_attention_qkv_fwd(qkv, H, causal=causal)
        g = A.flash_attention_qkv_bwd(qkv, o, lse, do, H, causal=causal)
        return (o, lse, *g.view(B, T, H, 3, d).unbind(3))

    def plain(o, lse):
        ro, rl = A.flash_attention_qkv_reference(qkv, H, causal=causal)
        rg = A.flash_attention_qkv_bwd_reference(qkv, o, lse, do, H,
                                                 causal=causal)
        return (ro, rl, *rg.view(B, T, H, 3, d).unbind(3))
    return parity_report(phase, ATTN_KERNELS, run, plain, causal, what)


def phase_parity_attn(seed: int):
    """The edge cases at B=1: short, ragged (T not a multiple of the
    kernels' 64- and 128-row tiles) and non-causal. The training shape
    itself is compared in :func:`phase_timing_attn`, on the inputs it
    times."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    worst = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0,
             "dv": 0.0}
    for T, causal in ATTN_PARITY:
        qkv, do = attn_inputs(1, T, gen)
        errs, _ = attn_parity(qkv, do, causal, f"B=1 T={T} causal={causal}")
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        del qkv, do
    emit("parity_attn_summary", worst=worst,
         tolerance={"ulps": TOL_ATTN_ULPS, "lse": TOL_LSE})


def lm_config():
    from horovod_tpu_torch.parallel.transformer import TransformerConfig
    return TransformerConfig(**LM, dtype=torch.bfloat16,
                             unembed_dtype=torch.bfloat16)


def lm_batch(batch: int, seq: int, seed: int, device="cuda"):
    """bench.py's LM data: uniform tokens, then labels, from one seeded
    numpy generator."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, LM["vocab"], size=(batch, seq))
    labels = rng.randint(0, LM["vocab"], size=(batch, seq))
    return (torch.from_numpy(tokens).to(device),
            torch.from_numpy(labels).to(device))


def lm_steps(step, state, tokens, labels):
    """LM_WARMUP steps, then LM_STEPS timed ones (host clock around a step
    that ends in ``.item()`` of its loss) with the launch counters zeroed
    just before them. Returns the state, every loss, the timed steps'
    seconds and their launches."""
    from horovod_tpu_torch.ops import LAUNCHES
    losses = []
    for _ in range(LM_WARMUP):
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
    torch.cuda.synchronize()
    LAUNCHES.reset()
    times = []
    for _ in range(LM_STEPS):
        t0 = time.monotonic()
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
        times.append(time.monotonic() - t0)
    return state, losses, times, LAUNCHES.snapshot()


def lm_report(losses, times, launches, n_params, peaks) -> dict:
    """The LM steps' line: step p50, tokens/s, MFU on the bench's
    matmul-only count, peak memory."""
    from horovod_tpu_torch.utils.flops import lm_train_gflop_per_token
    p50 = float(np.median(times))
    tok_s = LM_BATCH * LM_SEQ / p50
    gflop = lm_train_gflop_per_token(dict(LM, seq=LM_SEQ))
    return dict(batch=LM_BATCH, seq=LM_SEQ, params=n_params,
                warmup=LM_WARMUP, steps=LM_STEPS, losses=losses,
                step_ms=[t * 1e3 for t in times], step_ms_p50=p50 * 1e3,
                tokens_per_s=tok_s, gflop_per_token=gflop,
                mfu=tok_s * gflop * 1e9 / peaks[0], peak_flops=peaks[0],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches)


def lm_profile(step, state, tokens, labels, patterns) -> tuple:
    """One more step under ``torch.profiler``: the state and the profile
    line's fields (busy share, the named kernels' shares, top kernels)."""
    box = [state]

    def one_step():
        box[0], loss = step(box[0], tokens, labels)
        loss.item()
    wall_s, rows = device_profile(one_step)
    return box[0], dict(wall_ms=wall_s * 1e3,
                        **busy_shares(rows, wall_s, patterns),
                        top=[{"name": k[:90], "ms": us / 1e3, "count": c}
                             for us, k, c in rows[:14]])


def phase_lm_train(seed: int, peaks):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.transformer import \
        make_parallel_train_step
    hvd.init()
    check(hvd.size() == 1 and hvd.rank() == 0, "expected a 1-rank world")
    cfg = lm_config()
    torch.cuda.reset_peak_memory_stats()
    init_state, step = make_parallel_train_step(
        cfg, functools.partial(torch.optim.AdamW, **ADAMW))
    state = init_state(seed)
    hvd.broadcast_parameters(state.model)
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    state, losses, times, launches = lm_steps(step, state, tokens, labels)
    n_params = sum(p.numel() for p in state.model.parameters())
    emit("lm_train", **lm_report(losses, times, launches, n_params, peaks),
         world=hvd.size(), unembed="torch.mm(bf16, bf16, out_dtype=float32)")
    n = cfg.n_layers * LM_STEPS
    for name in ATTN_KERNELS:
        check(launches.get(name, 0) == n,
              f"{name} launched {launches.get(name, 0)} times; expected "
              f"{cfg.n_layers} x {LM_STEPS}")
    check(launches.get("flash_attention", 0) == 0,
          "the LM step launched the prefill kernel")
    check(all(np.isfinite(losses)), f"LM loss not finite {losses}")
    check(losses[-1] < losses[0], f"LM loss did not fall {losses}")
    state, profiled = lm_profile(step, state, tokens, labels, {
        "k3_qkv": "flash_fwd_wgmma_kernel", "dq": "flash_bwd_dq_kernel",
        "dkv": "flash_bwd_dkv_kernel"})
    emit("lm_train_profile", **profiled)
    del state
    torch.cuda.empty_cache()
    hvd.shutdown()
    return launches


def _lm_one_step(model, tokens, labels):
    """One plain LM step (no world: the check compares the model and its
    kernels, not the collective): forward, dense NLL, backward, AdamW.
    Returns the loss, the logits and the gradients (on the CPU)."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel.transformer import dense_nll, forward
    opt = torch.optim.AdamW([p for _, p in convert.jax_leaf_order(model)],
                            **ADAMW)
    logits = forward(model, tokens)
    loss = dense_nll(logits, labels).mean()
    loss.backward()
    grads = {n: p.grad.detach().float().cpu().clone()
             for n, p in model.named_parameters()}
    opt.step()
    return loss.item(), logits.detach().float().cpu(), grads


def phase_e2e_lm_train(seed: int):
    """The full-width LM at batch 1, T=256 (tilable: the kernels run on
    the card), one step on the card and on the CPU (plain versions) from
    the same weights and batch."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.transformer import Transformer
    cfg = lm_config()
    card = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + 1), device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    tokens, labels = lm_batch(LM_E2E_BATCH, LM_E2E_SEQ, seed + 5)
    LAUNCHES.reset()
    t0 = time.monotonic()
    loss_card, logits_card, g_card = _lm_one_step(card, tokens, labels)
    card_s = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    check(all(launches.get(k) == cfg.n_layers for k in ATTN_KERNELS),
          f"e2e LM step did not run the attention kernels: {launches}")
    t0 = time.monotonic()
    loss_cpu, logits_cpu, g_cpu = _lm_one_step(cpu, tokens.cpu(),
                                               labels.cpu())
    cpu_s = time.monotonic() - t0
    check(bool(torch.isfinite(logits_card).all()), "card logits not finite")
    cp, pp = dict(card.named_parameters()), dict(cpu.named_parameters())

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    upd_card = {n: cp[n].detach().cpu() - before[n] for n in before}
    upd_cpu = {n: pp[n].detach() - before[n] for n in before}
    grad_err = {n: rel_l2(g_card[n], g_cpu[n]) for n in before}
    upd_err = {n: rel_l2(upd_card[n], upd_cpu[n]) for n in before}
    cosine = F.cosine_similarity(     # f64: 470 M terms
        torch.cat([u.flatten() for u in upd_card.values()]).double(),
        torch.cat([u.flatten() for u in upd_cpu.values()]).double(),
        dim=0).item()
    worst_g = max(grad_err, key=grad_err.get)
    worst_u = max(upd_err, key=upd_err.get)
    diffs = {"loss": abs(loss_card - loss_cpu),
             "logits": (logits_card - logits_cpu).abs().max().item(),
             "grad_rel_l2": grad_err[worst_g],
             "update_rel_l2": upd_err[worst_u]}
    emit("e2e_lm_train", batch=LM_E2E_BATCH, seq=LM_E2E_SEQ,
         loss_card=loss_card, loss_cpu=loss_cpu,
         logits_std=logits_cpu.std().item(), diffs=diffs,
         worst_grad_leaf=worst_g, worst_update_leaf=worst_u,
         grad_rel_l2={n: grad_err[n] for n in ("embed", "lnf",
                                               "layers.0.wqkv",
                                               "layers.7.w2")},
         update_cosine=cosine, tolerance=TOL_E2E_LM, launches=launches,
         card_s=card_s, cpu_s=cpu_s,
         note="grad/update_rel_l2: worst leaf's ||card-cpu||/||cpu||")
    for key in ("loss", "logits", "grad_rel_l2"):
        check(diffs[key] <= TOL_E2E_LM[key],
              f"e2e LM {key} differs by {diffs[key]}")
    check(TOL_E2E_LM["update_cosine"] <= cosine <= 1 + 1e-6,
          f"e2e LM whole-model update cosine {cosine}")


def attn_timing_row(rows: dict, shape, peaks, name: str, fn, n_mm: int,
                    n_io: int, n_stat: int, plain, lib, lib_name) -> None:
    """Time one attention launch (``fn``) at ``shape`` = (B, T, H, d),
    causal, and emit its ``timing`` line. Bound: ``n_mm`` matmul passes
    over the T(T+1)/2 causal (q, key) pairs per head at 2d flops a pair,
    against ``n_io`` [B,T,H,d] bf16 tensors and ``n_stat`` [B*H, T] f32
    rows read or written once."""
    B, T, H, d = shape
    ms = time_ms(fn)
    bnd, by = bound_ms(n_mm * 2.0 * d * B * H * T * (T + 1) / 2,
                       n_io * 2.0 * B * T * H * d + n_stat * 4.0 * B * H * T,
                       peaks)
    rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                      bound_by=by)
    emit("timing", kernel=name, B=B, T=T, H=H, causal=True, **rows[name],
         library=lib_name)


def delta_row(B: int, T: int, H: int, d: int, peaks, fn) -> None:
    """Time the backward's row statistic Delta = rowsum(dO * O) (plain
    PyTorch outside the kernels, once per backward) and emit its
    ``timing_delta`` line; bound: reading dO and O, writing Delta."""
    emit("timing_delta", B=B, T=T, H=H, ms=time_ms(fn),
         bound_ms=bound_ms(0.0, 2 * 2.0 * B * T * H * d + 4.0 * B * H * T,
                           peaks)[0])


def _suffixed_row(suffix: str, rows: dict, shape, peaks, name: str, *args):
    attn_timing_row(rows, shape, peaks, name + suffix, *args)


def phase_timing_attn(seed: int, peaks, H: int = 0, suffix: str = "",
                      unembed: bool = True):
    """K3-qkv, dq, dkv and the pair at the training shape: compared with
    their plain versions (:func:`attn_parity`), then timed. Bounds: FLOPs
    of the causal (q, key) pairs, T(T+1)/2 per head, at 2d per pair per
    matmul (fwd 2 matmuls; the backward's function 5; dq 3, dkv 4 as the
    kernels split it); bytes: each input read once, each output written
    once (q, k, v, o, dO, dq, dk, dv bf16; lse2, Delta f32)."""
    from horovod_tpu_torch.ops import attention as A
    B, T, H, d = LM_BATCH, LM_SEQ, H or LM["n_heads"], 128
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    qkv, do = attn_inputs(B, T, gen, H)
    # The kernels against their plain versions at the shape the LM step
    # gives them; this is the kernels line's max_abs_err.
    _, abs_err = attn_parity(qkv, do, True, f"B={B} T={T} H={H} causal", H,
                             "parity_attn" + suffix)
    o, lse = A.flash_attention_qkv_fwd(qkv, H, causal=True)
    delta = A.attention_delta(do, o, H)
    delta_row(B, T, H, d, peaks, lambda: A.attention_delta(do, o, H))
    g = torch.empty_like(qkv)
    rows = {}
    row = functools.partial(_suffixed_row, suffix, rows, (B, T, H, d), peaks)
    q4, k4, v4 = (x.transpose(1, 2) for x in A._split_qkv(qkv, H))
    plain_fwd = time_ms(lambda: A.flash_attention_qkv_reference(
        qkv, H, causal=True), reps=3, inner=1)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    row("flash_attention_qkv_fwd",
        lambda: A.flash_attention_qkv_fwd(qkv, H, causal=True), 2, 4, 1,
        plain_fwd, lib_fwd,
        "torch.nn.functional.scaled_dot_product_attention (forward)")
    torch.cuda.empty_cache()
    plain_bwd = time_ms(lambda: A.flash_attention_qkv_bwd_reference(
        qkv, o, lse, do, H, causal=True), reps=3, inner=1)
    torch.cuda.empty_cache()
    row("flash_bwd_dq", lambda: A.flash_bwd_dq(qkv, do, lse, delta, g, H,
                                               causal=True),
        3, 5, 2, plain_bwd, None, None)
    row("flash_bwd_dkv", lambda: A.flash_bwd_dkv(qkv, do, lse, delta, g, H,
                                                 causal=True),
        4, 6, 2, plain_bwd, None, None)
    ql, kl, vl = (x.detach().contiguous().requires_grad_()
                  for x in (q4, k4, v4))
    gl = do.view(B, T, H, d).transpose(1, 2).contiguous()
    lib_pair = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
        (ql, kl, vl), gl))

    def pair():
        A.flash_bwd_dq(qkv, do, lse, delta, g, H, causal=True)
        A.flash_bwd_dkv(qkv, do, lse, delta, g, H, causal=True)
    row("flash_bwd_pair", pair, 5, 7, 2, plain_bwd, lib_pair,
        "scaled_dot_product_attention forward + backward (autograd)")
    del qkv, do, o, lse, delta, g, ql, kl, vl, gl
    torch.cuda.empty_cache()
    if not unembed:
        return rows, abs_err
    # The LM step's bf16 unembed (not a kernel of the port): the cuBLAS
    # product with f32 output it uses, beside the f32 upcast of the same
    # bf16 values that the CPU path computes.
    n, dm, V = LM_BATCH * LM_SEQ, LM["d_model"], LM["vocab"]
    x = torch.randn((n, dm), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((V, dm), generator=gen, device="cuda").to(torch.bfloat16)
    mm_ms = time_ms(lambda: torch.mm(x, w.t(), out_dtype=torch.float32))
    up_ms = time_ms(lambda: x.float() @ w.float().t(), reps=5, inner=2)
    emit("timing_unembed", shape=[n, dm, V], out_dtype_mm_ms=mm_ms,
         f32_upcast_ms=up_ms, bound_ms=bound_ms(
             2.0 * n * dm * V, 2.0 * (n + V) * dm + 4.0 * n * V, peaks)[0],
         note="forward only; torch.mm(bf16, bf16, out_dtype=float32)")
    return rows, abs_err


# -- the pipelined LM (slice 4) -----------------------------------------------

def bhtd_inputs(B: int, T: int, gen: torch.Generator, H: int = 0):
    """q/k/v as the pipelined block hands them to the kernels: strided
    slices of a packed [B, T, H, 3, d] projection, q prescaled by
    sm_scale*log2(e) (contiguous); and a cotangent dO [B, T, H, d]."""
    from horovod_tpu_torch.ops.attention import LOG2E
    H, d = H or LM["n_heads"], 128
    qkv = torch.randn((B, T, H, 3, d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q = (qkv[..., 0, :].float() * (d ** -0.5 * LOG2E)).to(torch.bfloat16)
    do = torch.randn((B, T, H, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return q, qkv[..., 1, :], qkv[..., 2, :], do


def bhtd_parity(q, k, v, do, causal: bool, what: str,
                phase: str = "parity_attn_bhtd"):
    """The forward with lse and the dq and dk/dv kernels on [B,T,H,D]
    operands against their plain versions (:func:`parity_report`, one
    ``phase`` line)."""
    from horovod_tpu_torch.ops import attention as A

    def run():
        o, lse = A.flash_attention_lse(q, k, v, causal=causal)
        delta = A.attention_delta_bhtd(do, o)
        return (o, lse,
                A.flash_bwd_dq_bhtd(q, k, v, do, lse, delta, causal=causal),
                *A.flash_bwd_dkv_bhtd(q, k, v, do, lse, delta,
                                      causal=causal))

    def plain(o, lse):
        return (*A.flash_attention_lse_reference(q, k, v, causal=causal),
                *A.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal=causal))
    return parity_report(phase, BHTD_KERNELS, run, plain, causal, what)


def phase_parity_attn_bhtd(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    worst = {"o": 0.0, "o_row": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0,
             "dv": 0.0}
    abs_err = None
    for B, T, causal in BHTD_PARITY:
        q, k, v, do = bhtd_inputs(B, T, gen)
        errs, err_abs = bhtd_parity(q, k, v, do, causal,
                                    f"[B,T,H,D] B={B} T={T} causal={causal}")
        worst = {key: max(val, errs[key]) for key, val in worst.items()}
        abs_err = abs_err or err_abs         # the pp step's shape: first
        del q, k, v, do
    emit("parity_attn_bhtd_summary", worst=worst,
         tolerance={"ulps": TOL_ATTN_ULPS, "lse": TOL_LSE})
    return abs_err


def pp_step_fn(cfg, mesh, device="cuda", **kw):
    from horovod_tpu_torch.parallel.pp_transformer import \
        make_pp_transformer_train_step
    return make_pp_transformer_train_step(
        cfg, mesh, functools.partial(torch.optim.AdamW, **ADAMW), PP_MICRO,
        device=device, **kw)


def phase_pp_lm_train(seed: int, peaks):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    hvd.init()
    check(hvd.size() == 1 and hvd.rank() == 0, "expected a 1-rank world")
    mesh = create_hybrid_mesh(dp=1, pp=1)
    cfg = lm_config()
    torch.cuda.reset_peak_memory_stats()
    init_state, step = pp_step_fn(cfg, mesh)
    state = init_state(seed)
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    state, losses, times, launches = lm_steps(step, state, tokens, labels)
    n_params = sum(p.numel() for p in state.optimizer.param_groups[0][
        "params"])
    emit("pp_lm_train", **lm_report(losses, times, launches, n_params,
                                    peaks),
         microbatches=PP_MICRO, mesh=mesh.shape, world=hvd.size())
    n = cfg.n_layers * PP_MICRO * LM_STEPS
    for name in BHTD_KERNELS:
        check(launches.get(name, 0) == n,
              f"{name} launched {launches.get(name, 0)} times; expected "
              f"{cfg.n_layers} x {PP_MICRO} x {LM_STEPS}")
    for name in ("flash_attention_qkv_fwd", "flash_attention"):
        check(launches.get(name, 0) == 0,
              f"the pipelined step launched {name}")
    check(all(np.isfinite(losses)), f"pp LM loss not finite {losses}")
    check(losses[-1] < losses[0], f"pp LM loss did not fall {losses}")
    state, profiled = lm_profile(step, state, tokens, labels, {
        "k3_lse": "flash_fwd_wgmma_kernel", "dq": "flash_bwd_dq_kernel",
        "dkv": "flash_bwd_dkv_kernel", "index_add": "index"})
    emit("pp_lm_train_profile", **profiled)
    del state
    torch.cuda.empty_cache()
    hvd.shutdown()
    return launches


def _pp_one_step(params, device, tokens, labels):
    """One pipelined step on a 1-rank world of ``device`` (NCCL on the
    card, gloo on the CPU) from a copy of ``params``: returns the loss,
    the gradients, the updated parameters (on the CPU, by leaf name), the
    launches and the seconds the step took."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    from horovod_tpu_torch.parallel.pp_transformer import named_leaves

    def copy_to(tree):
        if isinstance(tree, dict):
            return {k: copy_to(v) for k, v in tree.items()}
        return torch.nn.Parameter(tree.detach().to(device, copy=True))
    hvd.init(device=device)
    try:
        init_state, step = pp_step_fn(
            lm_config(), create_hybrid_mesh(dp=1, pp=1), device=device)
        state = init_state(params=copy_to(params))
        LAUNCHES.reset()
        t0 = time.monotonic()
        state, loss = step(state, tokens.to(device), labels.to(device))
        loss = loss.item()
        secs = time.monotonic() - t0
        launches = LAUNCHES.snapshot()
        named = named_leaves(state.params)
        grads = {n: p.grad.detach().float().cpu() for n, p in named}
        after = {n: p.detach().float().cpu() for n, p in named}
    finally:
        hvd.shutdown()
    return loss, grads, after, launches, secs


def phase_e2e_pp_lm_train(seed: int):
    """One full-width pipelined step at batch 2 (2 microbatches of 1),
    T=256 (tilable: the kernels run on the card), through the same entry
    points on the card and on the CPU (plain versions) from the same
    weights and batch."""
    from horovod_tpu_torch.parallel.pp_transformer import (init_pp_params,
                                                           named_leaves)
    cfg = lm_config()
    params = init_pp_params(torch.Generator(device="cuda").manual_seed(
        seed + 2), cfg, 1, 0, device="cuda")
    before = {n: p.detach().float().cpu() for n, p in named_leaves(params)}
    tokens, labels = lm_batch(PP_E2E_BATCH, PP_E2E_SEQ, seed + 6)
    loss_card, g_card, p_card, launches, card_s = _pp_one_step(
        params, "cuda", tokens, labels)
    n = cfg.n_layers * PP_MICRO
    check(all(launches.get(k) == n for k in BHTD_KERNELS),
          f"e2e pp step did not run the [B,T,H,D] kernels: {launches}")
    loss_cpu, g_cpu, p_cpu, _, cpu_s = _pp_one_step(params, "cpu", tokens,
                                                    labels)
    del params

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    grad_err = {n: rel_l2(g_card[n], g_cpu[n]) for n in before}
    cosine = F.cosine_similarity(     # f64: 470 M terms
        torch.cat([(p_card[n] - before[n]).flatten() for n in before])
        .double(),
        torch.cat([(p_cpu[n] - before[n]).flatten() for n in before])
        .double(), dim=0).item()
    worst = max(grad_err, key=grad_err.get)
    diffs = {"loss": abs(loss_card - loss_cpu),
             "grad_rel_l2": grad_err[worst]}
    emit("e2e_pp_lm_train", batch=PP_E2E_BATCH, seq=PP_E2E_SEQ,
         microbatches=PP_MICRO, loss_card=loss_card, loss_cpu=loss_cpu,
         diffs=diffs, worst_grad_leaf=worst, grad_rel_l2=grad_err,
         update_cosine=cosine, tolerance=TOL_E2E_PP, launches=launches,
         card_s=card_s, cpu_s=cpu_s,
         note="grad_rel_l2: ||card-cpu||/||cpu|| per leaf")
    check(np.isfinite(loss_card), "e2e pp loss not finite")
    for key in ("loss", "grad_rel_l2"):
        check(diffs[key] <= TOL_E2E_PP[key],
              f"e2e pp {key} differs by {diffs[key]}")
    check(TOL_E2E_PP["update_cosine"] <= cosine <= 1 + 1e-6,
          f"e2e pp whole-model update cosine {cosine}")


def phase_timing_attn_bhtd(seed: int, peaks, H: int = 0, suffix: str = ""):
    """The [B,T,H,D] launches at the pp step's shape (B=4, H=16 or
    ``H``, T=2048, causal), timed beside their bounds (as
    :func:`phase_timing_attn` counts them), plain versions and SDPA;
    ``suffix`` names the rows of another shape."""
    from horovod_tpu_torch.ops import attention as A
    B, T, H, d = LM_BATCH // PP_MICRO, LM_SEQ, H or LM["n_heads"], 128
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    q, k, v, do = bhtd_inputs(B, T, gen, H)
    o, lse = A.flash_attention_lse(q, k, v, causal=True)
    delta = A.attention_delta_bhtd(do, o)
    delta_row(B, T, H, d, peaks, lambda: A.attention_delta_bhtd(do, o))
    rows = {}
    row = functools.partial(_suffixed_row, suffix, rows, (B, T, H, d), peaks)
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    plain_fwd = time_ms(lambda: A.flash_attention_lse_reference(
        q, k, v, causal=True), reps=3, inner=1)
    # q is prescaled into the log2 domain: scale ln 2 gives SDPA the
    # same function (exp(x ln 2) = exp2(x)).
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=A.LN2))
    row("flash_attention_lse",
        lambda: A.flash_attention_lse(q, k, v, causal=True), 2, 4, 1,
        plain_fwd, lib_fwd,
        "torch.nn.functional.scaled_dot_product_attention (forward)")
    torch.cuda.empty_cache()
    plain_bwd = time_ms(lambda: A.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True), reps=3, inner=1)
    torch.cuda.empty_cache()
    row("flash_bwd_dq_bhtd", lambda: A.flash_bwd_dq_bhtd(
        q, k, v, do, lse, delta, causal=True), 3, 5, 2, plain_bwd, None,
        None)
    row("flash_bwd_dkv_bhtd", lambda: A.flash_bwd_dkv_bhtd(
        q, k, v, do, lse, delta, causal=True), 4, 6, 2, plain_bwd, None,
        None)
    ql, kl, vl = (x.detach().contiguous().requires_grad_()
                  for x in (q4, k4, v4))
    gl = do.transpose(1, 2).contiguous()
    lib_pair = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                       scale=A.LN2), (ql, kl, vl), gl))

    def pair():
        A.flash_bwd_dq_bhtd(q, k, v, do, lse, delta, causal=True)
        A.flash_bwd_dkv_bhtd(q, k, v, do, lse, delta, causal=True)
    row("flash_bwd_pair_bhtd", pair, 5, 7, 2, plain_bwd, lib_pair,
        "scaled_dot_product_attention forward + backward (autograd)")
    del q, k, v, do, o, lse, delta, ql, kl, vl, gl
    torch.cuda.empty_cache()
    return rows


# -- the training-plane knobs, the guard and the bench entry -----------------

def _flat_params(named):
    return {n: p.detach().float().clone() for n, p in named}


def _update_cosine(after_a, after_b, before) -> float:
    """Cosine of two whole-model updates, summed leaf by leaf in f64."""
    dot = na = nb = 0.0
    for n, p0 in before.items():
        a = (after_a[n] - p0).double()
        b = (after_b[n] - p0).double()
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
    return dot / max(math.sqrt(na * nb), 1e-300)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _knob_run(name, make, tokens, labels, held: int):
    """``KNOB_STEPS`` steps of the step ``make()`` builds (``(state, step,
    named)``): the losses, the launches of the run, its peak memory, the
    last step's seconds, and the parameters before and after. ``held``
    is the bytes of the earlier runs' parameter copies still on the card:
    they and this run's own copy are left out of the peak, which is
    the step's."""
    from horovod_tpu_torch.ops import LAUNCHES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, named = make()
    before = _flat_params(named(state))
    losses = []
    LAUNCHES.reset()
    for _ in range(KNOB_STEPS):
        t0 = time.monotonic()
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
        secs = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated() - held - _nbytes(
        before.values())
    after = _flat_params(named(state))
    report = dict(variant=name, losses=losses, step_s=secs,
                  launches=launches, peak_mem_gb=peak / 1e9)
    del state
    check(all(np.isfinite(losses)), f"{name}: loss not finite {losses}")
    return report, before, after


def phase_train_knobs(seed: int):
    """The bench LM at full width (8 x 2048, AdamW as bench.py), two steps
    per variant from the same seed and batch: accumulation over 2
    microbatches, remat, the chunked loss, the bf16 and fp8 wire formats
    (the path NCCL takes for each), and the pipelined step with the guard
    armed and a bf16 wire, each against its plain counterpart."""
    import dataclasses
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import wire_path
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    from horovod_tpu_torch.parallel.pp_transformer import named_leaves
    from horovod_tpu_torch.parallel.transformer import \
        make_parallel_train_step
    from horovod_tpu_torch.utils import config as hcfg
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    check(not hcfg.guard_nonfinite() and hcfg.wire_dtype_default() is None,
          "HVD_GUARD_NONFINITE / HVD_WIRE_DTYPE are set")
    base_cfg = lm_config()
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    adamw = functools.partial(torch.optim.AdamW, **ADAMW)

    def dp(cfg=base_cfg, **kw):
        def make():
            init_state, step = make_parallel_train_step(cfg, adamw, **kw)
            return (init_state(seed), step,
                    lambda st: st.model.named_parameters())
        return make

    def pp(**kw):
        def make():
            init_state, step = pp_step_fn(
                base_cfg, create_hybrid_mesh(dp=1, pp=1), **kw)
            return init_state(seed), step, lambda st: named_leaves(
                st.params)
        return make

    L, n = base_cfg.n_layers, KNOB_STEPS
    dp_launches = {"flash_attention_qkv_fwd": L, "flash_bwd_dq": L,
                   "flash_bwd_dkv": L}
    pp_launches = {k: L * PP_MICRO for k in BHTD_KERNELS}
    # (name, step builder, launches per step, the run it is held to)
    variants = (
        ("base", dp(), dp_launches, None),
        ("accum2", dp(accum_steps=2),
         {k: 2 * v for k, v in dp_launches.items()}, "base"),
        # remat recomputes each layer's forward, flash kernel included.
        ("remat", dp(dataclasses.replace(base_cfg, remat=True)),
         dict(dp_launches, flash_attention_qkv_fwd=2 * L), "base"),
        ("chunk", dp(dataclasses.replace(base_cfg, loss_chunk=KNOB_CHUNK)),
         dp_launches, "base"),
        ("wire_bf16", dp(wire_dtype="bf16"), dp_launches, "base"),
        ("wire_fp8", dp(wire_dtype="fp8"), dp_launches, "base"),
        ("pp", pp(), pp_launches, None),
        ("pp_guard_bf16", pp(wire_dtype="bf16", guard_nonfinite=True),
         pp_launches, "pp"),
    )
    runs, refs = {}, {}
    for name, make, per_step, ref in variants:
        held = sum(_nbytes(b.values()) + _nbytes(a.values())
                   for b, a in refs.values())
        report, before, after = _knob_run(name, make, tokens, labels, held)
        want = {k: v * n for k, v in per_step.items()}
        got = {k: report["launches"].get(k, 0) for k in want}
        check(got == want, f"{name}: launches {report['launches']}, "
                           f"expected {want}")
        runs[name] = report
        if ref is None:
            refs[name] = (before, after)
            continue
        ref_before, ref_after = refs[ref]
        check(all(torch.equal(p0, ref_before[k])
                  for k, p0 in before.items()),
              f"{name}: initial params differ from the {ref} run's")
        report["update_cosine"] = _update_cosine(after, ref_after,
                                                 ref_before)
        diff = max(float((after[k] - ref_after[k]).abs().max())
                   for k in after)
        report["max_abs_param_diff"] = diff
        report["bitwise_equal"] = diff == 0.0
        report["params_within"] = {
            w: all(torch.allclose(after[k], ref_after[k], rtol=t["rtol"],
                                  atol=t["atol"]) for k in after)
            for w, t in TOL_WIRE.items()}
        del before, after
    del refs
    base = runs["base"]
    paths = {w: wire_path(w) for w in ("bf16", "fp8")}
    emit("train_knobs", batch=LM_BATCH, seq=LM_SEQ, steps=n,
         variants=runs, wire_paths=paths,
         nccl=".".join(map(str, torch.cuda.nccl.version())),
         tolerance={"accum": TOL_E2E_LM, "chunk": TOL_CHUNK,
                    "wire": TOL_WIRE},
         note="update_cosine, max_abs_param_diff: each variant's params "
              "after the steps against its plain run's (base; pp for the "
              "pipelined variants)")
    acc = runs["accum2"]
    check(abs(acc["losses"][0] - base["losses"][0]) <= TOL_E2E_LM["loss"],
          f"accum2 loss {acc['losses'][0]} vs {base['losses'][0]}")
    check(acc["update_cosine"] >= TOL_E2E_LM["update_cosine"],
          f"accum2 update cosine {acc['update_cosine']}")
    check(runs["remat"]["update_cosine"] >= TOL_E2E_LM["update_cosine"],
          f"remat update cosine {runs['remat']['update_cosine']}")
    for i in range(n):
        rel = abs(runs["chunk"]["losses"][i] / base["losses"][i] - 1)
        check(rel <= TOL_CHUNK, f"chunked loss differs by {rel}")
    for w in ("bf16", "fp8"):
        got, tol = runs[f"wire_{w}"], TOL_WIRE[w]
        rel = abs(got["losses"][-1] / base["losses"][-1] - 1)
        check(rel <= tol["loss_rtol"], f"wire {w}: loss differs by {rel}")
        check(got["params_within"][w], f"wire {w}: params beyond {tol}")
    got = runs["pp_guard_bf16"]
    rel = abs(got["losses"][-1] / runs["pp"]["losses"][-1] - 1)
    check(rel <= TOL_WIRE["bf16"]["loss_rtol"]
          and got["params_within"]["bf16"],
          f"pp with guard and bf16 wire: loss differs by {rel}")
    torch.cuda.empty_cache()
    hvd.shutdown()


def phase_guard(seed: int):
    """The bad-step guard on the fused ResNet-50 at batch 128 (SGD 0.1,
    momentum 0.9): a finite step, a step whose batch holds a NaN image
    (params, momentum and BatchNorm buffers bit-unchanged, bad_step 1,
    loss 0, the kernels still run), a finite step that trains; then the
    step time with the guard off and on, in turns."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    hvd.init()
    model = build_resnet("fused", seed)
    state = create_train_state(model, functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))
    guarded = make_train_step(guard_nonfinite=True)
    x, y = synthetic_batch(RN_BATCH, seed)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("nan")

    def bits():
        opt = state.optimizer
        return ([p.detach().clone() for p in model.parameters()]
                + [opt.state[p]["momentum_buffer"].clone()
                   for p in model.parameters()]
                + [b.detach().clone() for b in model.buffers()])
    state, m0 = guarded(state, (x, y))
    before = bits()
    LAUNCHES.reset()
    state, m1 = guarded(state, (bad, y))
    skipped = {k: float(v) for k, v in m1.items()}
    skip_launches = LAUNCHES.snapshot()
    unchanged = all(torch.equal(a, b) for a, b in zip(before, bits()))
    LAUNCHES.reset()
    state, m2 = guarded(state, (x, y))
    after = {k: float(v) for k, v in m2.items()}
    trained = not all(torch.equal(a, b) for a, b in
                      zip(before[:len(list(model.parameters()))],
                          bits()))
    rec_launches = LAUNCHES.snapshot()
    del before
    plain = make_train_step()
    times = {"off": [], "on": []}
    for _ in range(GUARD_TIMED_PAIRS):
        for key, step in (("off", plain), ("on", guarded)):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = step(state, (x, y))
            m["loss"].item()
            times[key].append((time.monotonic() - t0) * 1e3)
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    emit("guard", batch=RN_BATCH, first_loss=float(m0["loss"]),
         skipped=skipped, unchanged=unchanged, recovery=after,
         trained=trained, skip_launches=skip_launches,
         recovery_launches=rec_launches, step_ms=times, step_ms_p50=p50,
         guard_cost_ms=p50["on"] - p50["off"],
         decision="one host read of the all-finite flag per step")
    check(skipped["bad_step"] == 1.0 and skipped["loss"] == 0.0,
          f"NaN step not skipped: {skipped}")
    check(unchanged, "a skipped step changed params, momentum or BN stats")
    check(after["bad_step"] == 0.0 and np.isfinite(after["loss"])
          and trained, f"the step after the skip did not train: {after}")
    for launches in (skip_launches, rec_launches):
        check(launches.get("fused_conv_bn_fwd") == RN_SITES
              and launches.get("fused_conv_bn_bwd") == RN_SITES,
              f"guarded step launches {launches}")
    del state, model, x, y, bad
    torch.cuda.empty_cache()
    hvd.shutdown()


def _zo_variant(name, make, data, steps, per_step, held: int):
    """``steps`` steps of ``make()``'s ``(state, step, model)``, the
    launch counters zeroed before each step and checked against
    ``per_step``; the step ms (p50 of the steps after the first, which
    pays first-use costs and, under overlap, the order probe), losses,
    peak bytes (less ``held``: the bytes of the plain run's parameter
    copy) and the state."""
    from horovod_tpu_torch.ops import LAUNCHES
    gc.collect()        # the overlap hooks tie params and optimizer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, model = make()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.monotonic()
        state, loss = step(state, *data)
        losses.append(loss.item())
        times.append((time.monotonic() - t0) * 1e3)
        got = {k: LAUNCHES.snapshot().get(k, 0) for k in per_step}
        check(got == per_step, f"zero_overlap {name}: step {i} launched "
                               f"{LAUNCHES.snapshot()}, expected {per_step}")
    check(all(np.isfinite(losses)), f"zero_overlap {name}: {losses}")
    opt = state.optimizer
    report = dict(variant=name, losses=losses, step_ms=times,
                  step_ms_p50=float(np.median(times[1:])),
                  peak_bytes=int(torch.cuda.max_memory_allocated() - held),
                  launches_per_step=per_step, zero=opt.zero,
                  overlap=opt.overlap, overlap_order=opt.grad_order_source)
    if opt.zero:
        plan = opt.plan
        report.update(buckets=len(plan.buckets),
                      state_elems=sum(plan.shard_len(i) for i in
                                      range(len(plan.buckets))))
    return report, state, model


def phase_zero_overlap(seed: int):
    """ZeRO-1 and the backward-overlapped exchange (``zero``, ``overlap``
    on ``make_parallel_train_step`` and ``create_train_state``) at full
    width on a 1-rank NCCL world, each variant held bitwise to its plain
    run; then the ZeRO guard's skip on a NaN batch."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.transformer import \
        make_parallel_train_step
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    cfg = lm_config()
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    adamw = functools.partial(torch.optim.AdamW, **ADAMW, foreach=True)
    lm_launch = {k: cfg.n_layers for k in ATTN_KERNELS}

    def lm(kw):
        def make():
            init_state, step = make_parallel_train_step(cfg, adamw, **kw)
            state = init_state(seed)
            return state, step, state.model
        return make

    x, y = synthetic_batch(RN_BATCH, seed)
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                            foreach=True)
    rn_launch = {"fused_conv_bn_fwd": RN_SITES,
                 "fused_conv_bn_bwd": RN_SITES}

    def rn(kw):
        def make():
            model = build_resnet("fused", seed)
            state = create_train_state(model, sgd, **kw)
            core = make_train_step()

            def step(st, xb, yb):
                st, m = core(st, (xb, yb))
                return st, m["loss"]
            return state, step, model
        return make

    out = {}
    for family, variants, make, data, per_step in (
            ("lm", ZO_LM, lm, (tokens, labels), lm_launch),
            ("resnet50", ZO_RN, rn, (x, y), rn_launch)):
        ref, rows = None, {}
        for name, kw in variants:
            held = 0 if ref is None else _nbytes(ref)
            report, state, model = _zo_variant(
                f"{family} {name}", make(kw), data, ZO_STEPS, per_step,
                held)
            params = [p.detach() for p in model.parameters()]
            if ref is None:
                ref = [p.clone() for p in params]
            report["params_bitwise_equal_to_plain"] = all(
                torch.equal(a, b) for a, b in zip(ref, params))
            rows[name] = report
            if family == "resnet50" and name == "zero_overlap":
                out["guard"] = _zo_guard(state, model, x, y)
            del state, model, params
        out[family] = rows
        del ref
    emit("zero_overlap", batch={"lm": LM_BATCH, "resnet50": RN_BATCH},
         seq=LM_SEQ, steps=ZO_STEPS, **out,
         note="world 1: the reduce-scatter and all-gather move nothing; "
              "peak_bytes is each variant's own (the plain run's param "
              "copy left out)")
    for family in ("lm", "resnet50"):
        for name, r in out[family].items():
            check(r["params_bitwise_equal_to_plain"],
                  f"zero_overlap {family} {name}: params differ from plain")
            if r["overlap"]:
                check(r["overlap_order"] == "probed",
                      f"zero_overlap {family} {name}: order "
                      f"{r['overlap_order']}")
    g = out["guard"]
    check(g["bad_step"] == 1.0 and g["loss"] == 0.0 and g["unchanged"],
          f"zero_overlap guard: {g}")
    torch.cuda.empty_cache()
    hvd.shutdown()


def _zo_guard(state, model, x, y) -> dict:
    """One ZeRO step with the guard on a batch holding a NaN image:
    params, the shards' optimizer state and the BatchNorm buffers must
    come back bit-unchanged."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.training import make_train_step
    bad = x.clone()
    bad[0, 0, 0, 0] = float("nan")

    def bits():
        return ([p.detach().clone() for p in model.parameters()]
                + [v.clone() for st in state.optimizer.zero_state().inner
                   for v in st.values() if torch.is_tensor(v)]
                + [b.detach().clone() for b in model.buffers()])
    before = bits()
    LAUNCHES.reset()
    state, m = make_train_step(guard_nonfinite=True)(state, (bad, y))
    launches = LAUNCHES.snapshot()
    unchanged = all(torch.equal(a, b) for a, b in zip(before, bits()))
    check(launches.get("fused_conv_bn_fwd") == RN_SITES
          and launches.get("fused_conv_bn_bwd") == RN_SITES,
          f"zero guard launches {launches}")
    return dict(unchanged=unchanged, bad_step=float(m["bad_step"]),
                loss=float(m["loss"]), launches=launches)


def phase_bench(smi: str):
    """``python -m horovod_tpu_torch.bench`` in a process of its own for
    each of BENCH_RUNS: every line named as expected, finite positive
    values, 0 < mfu <= 1, the knob fields, the peak bytes and the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    for args, names in BENCH_RUNS:
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.bench", *args],
            cwd=root, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT)
        secs = time.monotonic() - t0
        check(proc.returncode == 0, f"bench {args} exited "
                                    f"{proc.returncode}: "
                                    f"{proc.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        emit("bench", args=list(args), seconds=secs, lines=lines)
        check([ln["metric"] for ln in lines] == list(names),
              f"bench {args} printed {[ln['metric'] for ln in lines]}")
        accum = int(args[args.index("--accum-steps") + 1]) \
            if "--accum-steps" in args else 1
        zero, overlap = "--zero" in args, "--overlap" in args
        for ln in lines:
            check(np.isfinite(ln["value"]) and ln["value"] > 0
                  and ln["vs_baseline"] > 0, f"bench value {ln}")
            check(0 < ln["mfu"] <= 1 and ln["tflops_per_gpu"] > 0,
                  f"bench mfu {ln}")
            check(isinstance(ln["peak_bytes_per_gpu"], int)
                  and ln["peak_bytes_per_gpu"] > 0, f"bench peak {ln}")
            check({k: ln[k] for k in ("accum_steps", "zero", "overlap",
                                      "overlap_order", "wire_dtype", "tp",
                                      "pp", "mesh", "world")}
                  == {"accum_steps": accum, "zero": zero,
                      "overlap": overlap,
                      "overlap_order": "probed" if overlap else None,
                      "wire_dtype": "fp32", "tp": 1, "pp": 1,
                      "mesh": "dp1", "world": 1},
                  f"bench knob fields {ln}")
            check(ln["gpu"] == smi, f"bench card {ln['gpu']} vs {smi}")
        if "--conv-backend" in args:
            check(lines[0]["conv_backend"] == "fused", "bench backend")
        if "images" in names[0]:
            check(0 < lines[0]["phases"]["backward_share"] <= 1,
                  f"bench phases {lines[0]['phases']}")
    # --scaling: one launcher world per size up to this host's GPUs (a
    # world of 1 here), then the largest world's per-GPU line.
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", *BENCH_SCALING],
        cwd=root, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    secs = time.monotonic() - t0
    check(proc.returncode == 0, f"bench --scaling exited {proc.returncode}:"
                                f" {proc.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    emit("bench", args=list(BENCH_SCALING), seconds=secs, lines=lines)
    check([ln["metric"] for ln in lines]
          == ["resnet50_scaling_efficiency_1gpus",
              "resnet50_synthetic_images_per_sec_per_gpu"],
          f"bench --scaling printed {[ln['metric'] for ln in lines]}")
    check(lines[0]["value"] == 1.0 and lines[0]["world"] == 1
          and lines[0]["images_per_sec_total"] > 0
          and lines[1]["gpu"] == smi, f"bench --scaling lines {lines}")


def want_launches(got: dict, want: dict, what: str) -> None:
    """Every kernel of ``want`` launched exactly that many times."""
    seen = {k: got.get(k, 0) for k in want}
    check(seen == want, f"{what}: launched {got}, expected {want}")


def host_batch(batch: int, seed: int):
    """synthetic_batch's data on the host (numpy): what a Trainer's data
    iterable yields, staged to the card by its prefetch thread."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((batch, RN_IMAGE, RN_IMAGE, 3)).astype(
        np.float32)
    return x, rng.randint(0, RN_CLASSES, size=(batch,))


def _state_bits(state) -> list:
    """Params, buffers, every optimizer-state tensor and the
    hyperparameters of a train state (copies, either plane)."""
    opt = state.optimizer
    st = (opt.zero_state().inner if opt.zero else
          [opt.state.get(p, {}) for _, p in opt.named_parameters])
    return ([t.detach().clone() for t in state.model.parameters()]
            + [b.detach().clone() for b in state.model.buffers()]
            + [v.detach().clone() for d in st for _, v in sorted(d.items())
               if torch.is_tensor(v)]
            + [torch.tensor([float(v) for k, v in sorted(g.items())
                             if isinstance(v, float)], dtype=torch.float64)
               for g in opt.param_groups]
            + [torch.tensor(int(state.step))])


def _bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.cpu(), y.cpu()) for x, y in zip(a, b))


def _ckpt_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _leaf_file(path: str, prefix: str):
    """(leaf file, key path) of the largest leaf under ``prefix`` (a key
    path prefix such as ``.params``) in the checkpoint's index."""
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    leaves = [(s.file, ckpt.keystr(kp)) for kp, s in
              ckpt._flatten(ckpt.read_index(path))]
    cands = [(f, k) for f, k in leaves if k.startswith(prefix)]
    return max(cands, key=lambda fk: os.path.getsize(
        os.path.join(path, fk[0])))


def _corruption_checks(ckdir: str, step: int, make_state) -> dict:
    """A flipped byte and a truncated leaf raise CheckpointCorruptError
    naming the checkpoint and the leaf; a checkpoint without a manifest
    restores unverified. Each case works on its own copy."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.checkpoint import (MANIFEST_NAME,
                                                       verify_checkpoint)
    from horovod_tpu_torch.trainer import restore_checkpoint
    src = os.path.join(ckdir, f"ckpt_{step}")
    out = {}
    for case in ("flip", "truncate", "no_manifest"):
        root = tempfile.mkdtemp(prefix=f"hvd_ckpt_{case}_")
        try:
            path = os.path.join(root, f"ckpt_{step}")
            shutil.copytree(src, path)
            leaf_file, leaf = _leaf_file(path, ".params")
            victim = os.path.join(path, leaf_file)
            size = os.path.getsize(victim)
            if case == "flip":
                with open(victim, "r+b") as f:
                    f.seek(size // 2)
                    b = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([(b[0] + 1) & 0xFF]))
            elif case == "truncate":
                with open(victim, "r+b") as f:
                    f.truncate(size // 2)
            else:
                os.unlink(os.path.join(path, MANIFEST_NAME))
            if case == "no_manifest":
                check(verify_checkpoint(path) is False,
                      "manifest-less checkpoint reported as verified")
                state = make_state()
                restore_checkpoint(root, state)
                out[case] = dict(restored_step=int(state.step))
                del state
                continue
            for what, call in (("verify_checkpoint",
                                lambda: verify_checkpoint(path)),
                               ("restore_checkpoint",
                                lambda: restore_checkpoint(root,
                                                           make_state()))):
                try:
                    call()
                    raised = None
                except hvd.CheckpointCorruptError as e:
                    raised = str(e)
                check(raised is not None and path in raised
                      and leaf in raised,
                      f"{case}: {what} raised {raised!r}, expected "
                      f"CheckpointCorruptError naming {path} and {leaf}")
                out[f"{case}_{what}"] = raised[:240]
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return out


def _loop_times(run_step, n: int) -> list:
    """Completion-to-completion host times (ms) of ``n`` calls of
    ``run_step`` — no synchronize inside, as the Trainer's loop has none —
    then one synchronize; the last interval includes the drain."""
    stamps = [time.monotonic()]
    for _ in range(n):
        run_step()
        stamps.append(time.monotonic())
    torch.cuda.synchronize()
    stamps[-1] = time.monotonic()
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def phase_trainer(seed: int):
    """The fused ResNet-50 at full width through ``Trainer.fit`` with the
    callbacks and a save per epoch through ``AsyncCheckpointer``; the
    checkpoint's round trip, a resumed epoch, corruption, the bad-step
    budget; the Trainer's overhead and the checkpoint's costs."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.checkpoint import (snapshot_to_host,
                                                       state_tree,
                                                       verify_checkpoint,
                                                       write_manifest,
                                                       write_tree)
    from horovod_tpu_torch.trainer import (AsyncCheckpointer, Trainer,
                                           restore_checkpoint,
                                           save_checkpoint)
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)

    def make_state(s=seed + 1):
        return create_train_state(build_resnet("fused", s), sgd)
    x, y = host_batch(RN_BATCH, seed)
    data = lambda: [(x, y)] * TR_STEPS  # noqa: E731
    state = make_state(seed)
    step = make_train_step()
    ckdir = tempfile.mkdtemp(prefix="hvd_trainer_ckpt_")
    out = {}
    try:
        writer = AsyncCheckpointer(max_pending=2)
        lrs, snap_ms = [], []

        class Probe(cb.Callback):
            def on_batch_begin(self, batch, logs=None):
                lrs.append(self.trainer.state.optimizer.param_groups[0]["lr"])

            def on_epoch_end(self, epoch, logs=None):
                t0 = time.monotonic()
                save_checkpoint(ckdir, self.trainer.state,
                                max_to_keep=TR_KEEP, writer=writer)
                snap_ms.append((time.monotonic() - t0) * 1e3)
        warmup = cb.LearningRateWarmupCallback(warmup_epochs=1)
        trainer = Trainer(step, state, steps_per_epoch=TR_STEPS,
                          prefetch=TR_PREFETCH)
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.monotonic()
        history = trainer.fit(
            data, epochs=TR_EPOCHS,
            callbacks=[cb.BroadcastGlobalVariablesCallback(0),
                       cb.MetricAverageCallback(), warmup, Probe()])
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        launches = LAUNCHES.snapshot()
        steps = TR_EPOCHS * TR_STEPS
        want_launches(launches, {"fused_conv_bn_fwd": RN_SITES * steps,
                                 "fused_conv_bn_bwd": RN_SITES * steps},
                      "trainer fit")
        writer.wait()
        check(all(np.isfinite(h["loss"]) for h in history),
              f"trainer loss {history}")
        size = hvd.size()
        want_lr = [0.1 / size * ((e + (b + 1) / TR_STEPS) * (size - 1) + 1)
                   if e < 1 else 0.1
                   for e in range(TR_EPOCHS) for b in range(TR_STEPS)]
        check(lrs == want_lr, f"warmup lr per batch {lrs} vs {want_lr}")
        kept = sorted(os.listdir(ckdir))
        check(kept == [f"ckpt_{TR_STEPS * (e + 1)}"
                       for e in range(TR_EPOCHS - TR_KEEP, TR_EPOCHS)],
              f"retention kept {kept}")
        last = os.path.join(ckdir, f"ckpt_{steps}")
        check(verify_checkpoint(last) is True, "verify_checkpoint")
        out.update(fit_s=fit_s, history=history, lr_per_batch=lrs,
                   launches=launches, kept=kept,
                   snapshot_ms_async=snap_ms)

        # Round trip: a fresh state (other weights) restored from disk is
        # bitwise the live one: params, buffers, momentum, lr, step.
        live_bits = _state_bits(state)
        fresh = make_state()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        restore_checkpoint(ckdir, fresh)
        torch.cuda.synchronize()
        restore_ms = (time.monotonic() - t0) * 1e3
        check(_bits_equal(live_bits, _state_bits(fresh)),
              "restore_checkpoint: restored state differs from the live one")

        # Resume: one more epoch from each, cuDNN pinned deterministic
        # (the stock 3x3 convs' algorithms; K1 and K2 use no atomics).
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            resumed = []
            for st in (state, fresh):
                tr = Trainer(step, st, steps_per_epoch=TR_STEPS,
                             prefetch=TR_PREFETCH)
                tr.fit(data, epochs=TR_EPOCHS + 1, initial_epoch=TR_EPOCHS,
                       callbacks=[cb.LearningRateWarmupCallback(
                           warmup_epochs=1)])
                resumed.append(_state_bits(st))
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
        check(_bits_equal(*resumed), "resumed epoch: restored and live "
                                     "states diverged")
        del fresh, resumed
        out["corruption"] = _corruption_checks(ckdir, steps, make_state)

        # Costs: snapshot, write (leaf files + rename), manifest (CRCs),
        # the bytes; the stall of a synchronous vs an async save.
        torch.cuda.synchronize()
        t0 = time.monotonic()
        host = snapshot_to_host(state_tree(state))
        t1 = time.monotonic()
        path = os.path.join(ckdir, "ckpt_cost")
        write_tree(path, host)
        t2 = time.monotonic()
        write_manifest(path, host, step=int(state.step))
        t3 = time.monotonic()
        nbytes = _ckpt_bytes(path)
        shutil.rmtree(path)
        del host
        dev = hvd.runtime.device()
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        bare = lambda: step(state, (xd, yd))  # noqa: E731
        bare_ms = _loop_times(bare, TR_TIMED)
        stall = {}
        for mode in ("sync", "async"):
            torch.cuda.synchronize()
            t_0 = time.monotonic()
            save_checkpoint(ckdir, state, max_to_keep=TR_KEEP,
                            writer=writer if mode == "async" else None)
            call_ms = (time.monotonic() - t_0) * 1e3
            for _ in range(TR_STALL_STEPS):
                bare()
            torch.cuda.synchronize()
            window = (time.monotonic() - t_0) * 1e3
            writer.wait()
            stall[mode] = dict(
                save_call_ms=call_ms, window_ms=window,
                stall_ms=window - TR_STALL_STEPS * float(
                    np.median(bare_ms[1:])))
        writer.close()

        # The Trainer's per-step overhead against the bare loop, in turns:
        # fed host batches (staged by the prefetch thread) and batches
        # already on the card (the loop alone).
        def trainer_times(batch):
            tr = Trainer(step, state, steps_per_epoch=TR_TIMED,
                         prefetch=TR_PREFETCH, verbose=False)
            stamps = []

            class Stamp(cb.Callback):
                def on_batch_end(self, batch, logs=None):
                    stamps.append(time.monotonic())
            torch.cuda.synchronize()
            stamps.append(time.monotonic())
            tr.fit(lambda: [batch] * TR_TIMED, epochs=1,
                   callbacks=[Stamp()])
            torch.cuda.synchronize()
            return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])][1:]
        trainer_ms, resident_ms = [], []
        for _ in range(2):
            trainer_ms += trainer_times((x, y))
            bare_ms += _loop_times(bare, TR_TIMED)[1:]
            resident_ms += trainer_times((xd, yd))
        TRAINER_BARE_P50["ms"] = float(np.median(bare_ms))
        out.update(
            restore_ms=restore_ms, checkpoint_bytes=nbytes,
            snapshot_ms=(t1 - t0) * 1e3, write_ms=(t2 - t1) * 1e3,
            write_mb_per_s=nbytes / 1e6 / (t2 - t1),
            manifest_ms=(t3 - t2) * 1e3, stall=stall,
            bare_step_ms_p50=float(np.median(bare_ms)),
            trainer_step_ms_p50=float(np.median(trainer_ms)),
            trainer_resident_step_ms_p50=float(np.median(resident_ms)),
            trainer_overhead_ms=float(np.median(trainer_ms)
                                      - np.median(bare_ms)))

        # The bad-step budget: NaN batches under the guard raise
        # NonFiniteGradError after TR_BAD_BUDGET skips, state unchanged.
        bad_x = x.copy()
        bad_x[0, 0, 0, 0] = np.nan
        before = _state_bits(state)
        os.environ["HVD_MAX_BAD_STEPS"] = str(TR_BAD_BUDGET)
        try:
            tr = Trainer(make_train_step(guard_nonfinite=True), state,
                         steps_per_epoch=TR_STEPS, prefetch=TR_PREFETCH)
            LAUNCHES.reset()
            try:
                tr.fit(lambda: [(bad_x, y)] * TR_STEPS, epochs=1)
                raised = None
            except hvd.NonFiniteGradError as e:
                raised = str(e)
        finally:
            del os.environ["HVD_MAX_BAD_STEPS"]
        want_launches(LAUNCHES.snapshot(),
                      {"fused_conv_bn_fwd": RN_SITES * TR_BAD_BUDGET,
                       "fused_conv_bn_bwd": RN_SITES * TR_BAD_BUDGET},
                      "trainer guard")
        check(raised is not None and raised.startswith(
            f"{TR_BAD_BUDGET} consecutive non-finite-gradient steps at "
            f"global step {TR_BAD_BUDGET - 1}"),
              f"guard raised {raised!r}")
        after = _state_bits(state)
        # The step counter advances on a skipped step; nothing else moves.
        check(_bits_equal(before[:-1], after[:-1])
              and int(after[-1]) == int(before[-1]) + TR_BAD_BUDGET,
              "guard: state changed on skipped steps")
        out["guard"] = dict(raised=raised[:160], skipped=TR_BAD_BUDGET)
        emit("trainer", batch=RN_BATCH, epochs=TR_EPOCHS,
             steps_per_epoch=TR_STEPS, cudnn_deterministic_for_resume=True,
             **out)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()
    return launches


def _digest(bits: list) -> str:
    """sha256 over the bytes of a list of tensors (``_state_bits``)."""
    import hashlib
    h = hashlib.sha256()
    for t in bits:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def elastic_worker(seed: int) -> int:
    """One rank of the elastic phase's launched world (``--elastic-worker``,
    started by ``python -m horovod_tpu_torch.launcher``): the fused
    ResNet-50 through ``Trainer.fit`` under ``run_with_recovery`` with an
    async commit every EL_COMMIT_EVERY steps, made durable at each
    epoch's end. Writes its record to ``$HVD_SMOKE_OUT/epoch<e>.json``
    (also from the flight recorder's crash hook, which runs just before
    an injected kill)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.obs import flightrec
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.trainer import AsyncCheckpointer, Trainer
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    epoch = elastic.restart_epoch()
    rec = dict(epoch=epoch, t_start=_T_START)
    out = os.path.join(os.environ["HVD_SMOKE_OUT"], f"epoch{epoch}.json")

    def dump():
        with open(out, "w") as f:
            json.dump(rec, f)

    def on_kill():
        # The injected kill runs the crash hooks first: this process's
        # launches up to the kill, and the time of it.
        rec["t_kill"] = time.time()
        rec["launches"] = LAUNCHES.snapshot()
        print(f"elastic_worker epoch {epoch}: launches {rec['launches']} "
              f"at the kill", flush=True)
        dump()
    flightrec.add_crash_hook(on_kill)
    hvd.init()
    rec["t_init"] = time.time()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    state = create_train_state(build_resnet("fused", seed), sgd)
    step = make_train_step()
    x, y = host_batch(RN_BATCH, seed)
    base = os.environ["HVD_ELASTIC_DIR"]
    rec["markers_at_start"] = sorted(
        n for n in (os.listdir(base) if os.path.isdir(base) else [])
        if n.endswith(".committed"))
    writer = AsyncCheckpointer()
    es = elastic.ElasticState(state.model, state.optimizer, directory=base,
                              commit_every=EL_COMMIT_EVERY, writer=writer)
    commit_ms, wait_ms, stamps = [], [], []

    class Commit(cb.Callback):
        def on_batch_end(self, batch, logs=None):
            if not stamps:
                torch.cuda.synchronize()   # the first step, completed
                rec["t_first"] = time.time()
            t0 = time.monotonic()
            es.advance()
            if es.step % EL_COMMIT_EVERY == 0:
                commit_ms.append((time.monotonic() - t0) * 1e3)
            stamps.append(time.monotonic())

        def on_epoch_end(self, ep, logs=None):
            t0 = time.monotonic()
            es.wait()
            wait_ms.append((time.monotonic() - t0) * 1e3)

    def train(es):
        rec["t_restored"] = time.time()
        rec["resumed_from"] = es.step
        check(es.step % EL_EPOCH_STEPS == 0,
              f"resumed mid-epoch at step {es.step}")
        state.step = es.step
        tr = Trainer(step, state, steps_per_epoch=EL_EPOCH_STEPS,
                     prefetch=TR_PREFETCH)
        torch.cuda.synchronize()
        LAUNCHES.reset()
        tr.fit(lambda: [(x, y)] * EL_EPOCH_STEPS, epochs=EL_EPOCHS,
               initial_epoch=es.step // EL_EPOCH_STEPS,
               callbacks=[Commit()])
        torch.cuda.synchronize()
        rec["launches"] = LAUNCHES.snapshot()
        return es
    rec["t_walk"] = time.time()
    es = elastic.run_with_recovery(train, state=es)
    writer.close()
    steps = EL_EPOCHS * EL_EPOCH_STEPS - rec["resumed_from"]
    print(f"elastic_worker epoch {epoch}: launches {rec['launches']}",
          flush=True)
    want_launches(rec["launches"], {"fused_conv_bn_fwd": RN_SITES * steps,
                                    "fused_conv_bn_bwd": RN_SITES * steps},
                  f"elastic worker epoch {epoch}")
    bits = _state_bits(state)
    rec.update(
        step=int(state.step), es_step=es.step, commit_call_ms=commit_ms,
        epoch_end_wait_ms=wait_ms,
        step_ms=[(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
        params_digest=_digest(bits[:len(list(state.model.parameters()))]),
        state_digest=_digest(bits),
        loss_finite=bool(all(torch.isfinite(p).all()
                             for p in state.model.parameters())),
        t_end=time.time())
    dump()
    hvd.shutdown()
    return 0


def elastic_worker_cmd(seed: int) -> list:
    """The command the launcher runs for each rank of the elastic phase."""
    return [sys.executable, os.path.abspath(__file__), "--elastic-worker",
            "--seed", str(seed)]


def _launch_elastic(tag: str, root: str, seed: int, extra_env: dict,
                    restarts: int) -> dict:
    """Run ``--elastic-worker`` through the launcher (-np 1) with
    ``extra_env``; the launcher's output lines stamped with the wall
    clock as they arrive, and each epoch's record."""
    out_dir = os.path.join(root, tag)
    os.makedirs(out_dir)
    env = dict(os.environ, HVD_SMOKE_OUT=out_dir,
               HVD_ELASTIC_DIR=os.path.join(out_dir, "commits"),
               HVD_FLIGHTREC_DIR=out_dir, HVD_RESTART_BACKOFF_MAX="0",
               **extra_env)
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "1",
           "--restarts", str(restarts), *elastic_worker_cmd(seed)]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []

    def pump(stream, name):
        for ln in stream:
            lines.append((time.time(), name, ln.rstrip("\n")))
    pumps = [threading.Thread(target=pump, args=(proc.stdout, "out")),
             threading.Thread(target=pump, args=(proc.stderr, "err"))]
    for t in pumps:
        t.start()
    try:
        rc = proc.wait(timeout=EL_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.terminate()
        proc.wait(timeout=30)
        raise AssertionError(f"elastic {tag}: the launcher ran past "
                             f"{EL_TIMEOUT} s")
    finally:
        for t in pumps:
            t.join(timeout=30)
    text = "\n".join(ln for _, _, ln in lines)
    check(rc == 0, f"elastic {tag}: launcher exited {rc}:\n{text[-4000:]}")
    epochs = {}
    for e in range(restarts + 1):
        path = os.path.join(out_dir, f"epoch{e}.json")
        if os.path.exists(path):
            with open(path) as f:
                epochs[e] = json.load(f)
    return dict(t_launch=t0, seconds=time.time() - t0, lines=lines,
                text=text, epochs=epochs, out_dir=out_dir)


def phase_elastic(seed: int):
    """The launcher and elastic recovery on the card at full width: a
    clean launched run, a killed-and-relaunched run that must resume
    from EL_RESUME and end bitwise as the clean one, the time to
    recover, and in this process the Trainer's rollback past a corrupt
    commit plus the commit's stall and bytes."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.testing import faults
    from horovod_tpu_torch.trainer import AsyncCheckpointer, Trainer
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    root = tempfile.mkdtemp(prefix="hvd_elastic_")
    out = {}
    torch.cuda.empty_cache()
    try:
        # (a) clean and (b) killed after global step EL_KILL_STEP, then
        # relaunched once.
        clean = _launch_elastic("clean", root, seed, {}, restarts=0)
        killed = _launch_elastic(
            "killed", root, seed,
            {"HVD_FAULT_SPEC": f"rank=0:kill@step={EL_KILL_STEP}"},
            restarts=1)
        a = clean["epochs"].get(0)
        check(a is not None and a["resumed_from"] == 0
              and a["step"] == EL_EPOCHS * EL_EPOCH_STEPS,
              f"elastic clean run: {a}")
        relaunches = [ln for _, _, ln in killed["lines"]
                      if ln.startswith("tpurun: world failed")]
        check(len(relaunches) == 1, f"elastic: relaunched "
                                    f"{len(relaunches)} times")
        k0, k1 = killed["epochs"].get(0), killed["epochs"].get(1)
        check(k0 is not None and "t_kill" in k0 and k1 is not None,
              f"elastic killed run records: {sorted(killed['epochs'])}")
        # The kill fires after global step EL_KILL_STEP, its batch done.
        killed_steps = EL_KILL_STEP + 1
        want_launches(k0["launches"],
                      {"fused_conv_bn_fwd": RN_SITES * killed_steps,
                       "fused_conv_bn_bwd": RN_SITES * killed_steps},
                      "elastic killed process (epoch 0)")
        check(f"[elastic] recovery: resumed from committed step {EL_RESUME}"
              in killed["text"], "elastic: epoch 1 did not log 'resumed "
                                 f"from committed step {EL_RESUME}'")
        check(k1["resumed_from"] == EL_RESUME,
              f"elastic: resumed from {k1['resumed_from']}")
        check(k1["markers_at_start"] == [
            f"ckpt_{s}.committed" for s in range(
                EL_COMMIT_EVERY, EL_RESUME + 1, EL_COMMIT_EVERY)],
              f"elastic: markers at relaunch {k1['markers_at_start']}")
        check(k1["params_digest"] == a["params_digest"]
              and k1["state_digest"] == a["state_digest"],
              "elastic: the relaunched run's final state is not bitwise "
              "the clean run's")
        for what, r in (("clean", a), ("killed epoch 0", k0),
                        ("killed epoch 1", k1)):
            print(f"elastic {what}: launches {r['launches']}", flush=True)
        t_reap = next(t for t, _, ln in killed["lines"]
                      if ln.startswith("tpurun: world failed"))
        recover = dict(
            kill_to_reap_ms=(t_reap - k0["t_kill"]) * 1e3,
            relaunch_to_init_ms=(k1["t_init"] - t_reap) * 1e3,
            process_start_to_init_ms=(k1["t_init"] - k1["t_start"]) * 1e3,
            init_to_state_built_ms=(k1["t_walk"] - k1["t_init"]) * 1e3,
            walk_and_restore_ms=(k1["t_restored"] - k1["t_walk"]) * 1e3,
            first_step_ms=(k1["t_first"] - k1["t_restored"]) * 1e3,
            kill_to_first_step_ms=(k1["t_first"] - k0["t_kill"]) * 1e3)
        commits = os.path.join(clean["out_dir"], "commits")
        last = EL_EPOCHS * EL_EPOCH_STEPS
        # a["step_ms"][i] ends at step i + 2; the intervals that carry no
        # commit and no epoch-end wait.
        quiet = [ms for i, ms in enumerate(a["step_ms"])
                 if (i + 2) % EL_COMMIT_EVERY and (i + 1) % EL_EPOCH_STEPS]
        out.update(
            clean=dict(seconds=clean["seconds"], launches=a["launches"],
                       step_ms=a["step_ms"],
                       step_ms_p50=float(np.median(a["step_ms"])),
                       step_ms_without_commit=quiet,
                       commit_call_ms=a["commit_call_ms"],
                       epoch_end_wait_ms=a["epoch_end_wait_ms"],
                       first_step_ms=(a["t_first"] - a["t_restored"]) * 1e3,
                       start_to_init_ms=(a["t_init"] - a["t_start"]) * 1e3),
            killed=dict(seconds=killed["seconds"],
                        launches_epoch0=k0["launches"],
                        launches=k1["launches"],
                        resumed_from=k1["resumed_from"],
                        markers_at_relaunch=k1["markers_at_start"]),
            time_to_recover=recover,
            commit_bytes=_ckpt_bytes(os.path.join(commits, f"ckpt_{last}")),
            params_bitwise=True)

        # (c) In this process: commits at 2 and 4 (the step-4 bytes
        # flipped), NaN batches until the budget runs out, the rollback
        # past step 4 to step 2, then EL_AFTER finite steps.
        hvd.init()
        check(hvd.size() == 1, "expected a 1-rank world")
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        os.environ["HVD_FAULT_SPEC"] = f"ckpt:flip@step={EL_RESUME}"
        os.environ["HVD_MAX_BAD_STEPS"] = str(EL_BAD_BUDGET)
        faults.reset()
        try:
            sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
            state = create_train_state(build_resnet("fused", seed), sgd)
            step = make_train_step(guard_nonfinite=True)
            x, y = host_batch(RN_BATCH, seed)
            bad_x = x.copy()
            bad_x[0, 0, 0, 0] = np.nan
            cdir = os.path.join(root, "rollback")
            es = elastic.ElasticState(state.model, state.optimizer,
                                      directory=cdir,
                                      commit_every=EL_COMMIT_EVERY)
            at = {}

            class Commit(cb.Callback):
                def on_batch_end(self, batch, logs=None):
                    es.advance()
                    if es.step % EL_COMMIT_EVERY == 0:
                        at[es.step] = _state_bits(state)
            Trainer(step, state, steps_per_epoch=EL_RESUME,
                    prefetch=TR_PREFETCH).fit(
                lambda: [(x, y)] * EL_RESUME, epochs=1,
                callbacks=[Commit()])
            check(sorted(at) == [2, 4], f"rollback commits {sorted(at)}")
            rolled = {}

            class Watch(cb.Callback):
                def on_batch_end(self, batch, logs=None):
                    if batch == EL_BAD_BUDGET - 1:
                        rolled["bits"] = _state_bits(state)
                        rolled["step"] = int(state.step)
            data = [(bad_x, y)] * EL_BAD_BUDGET + [(x, y)] * EL_AFTER
            tr = Trainer(step, state, elastic=es, steps_per_epoch=len(data),
                         prefetch=TR_PREFETCH)
            torch.cuda.synchronize()
            LAUNCHES.reset()
            t0 = time.monotonic()
            hist = tr.fit(lambda: data, epochs=1, callbacks=[Watch()])
            torch.cuda.synchronize()
            fit_ms = (time.monotonic() - t0) * 1e3
            launches = LAUNCHES.snapshot()
            want_launches(launches,
                          {"fused_conv_bn_fwd": RN_SITES * len(data),
                           "fused_conv_bn_bwd": RN_SITES * len(data)},
                          "elastic rollback fit")
            check(es.discarded_corrupt == 1,
                  f"rollback walk discarded {es.discarded_corrupt}")
            check(rolled.get("step") == 2 and _bits_equal(
                rolled["bits"], at[2]),
                  "rollback: the state after the rollback is not bitwise "
                  "the step-2 commit")
            check(hist[0]["bad_steps"] == EL_BAD_BUDGET
                  and np.isfinite(hist[0]["loss"])
                  and int(state.step) == 2 + EL_AFTER,
                  f"rollback: history {hist}, step {int(state.step)}")
            # The two finite steps after the rollback are those of a fresh
            # state restored from the step-2 commit.
            after = _state_bits(state)
            ref = create_train_state(build_resnet("fused", seed + 7), sgd)
            elastic.ElasticState(ref.model, ref.optimizer, directory=cdir
                                 ).restore(step=2)
            ref.step = 2
            dev = hvd.runtime.device()
            for _ in range(EL_AFTER):
                ref, _m = step(ref, tuple(torch.from_numpy(a).to(dev)
                                          for a in (x, y)))
            check(_bits_equal(after, _state_bits(ref)),
                  "rollback: training after the rollback diverged from a "
                  "restore of the step-2 commit")
            del ref, at, rolled
            out["rollback"] = dict(
                discarded_corrupt=es.discarded_corrupt, rolled_back_to=2,
                bad_steps=hist[0]["bad_steps"], loss=hist[0]["loss"],
                launches=launches, fit_ms=fit_ms)

            # The commit's stall on the step loop: EL_STALL_STEPS steps
            # after a synchronous and after an async commit, against the
            # bare loop's p50; then the bare loop against the run (a)
            # Trainer's step p50.
            del os.environ["HVD_FAULT_SPEC"]
            faults.reset()
            xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            plain = make_train_step()
            bare = lambda: plain(state, (xd, yd))  # noqa: E731
            bare_ms = _loop_times(bare, TR_TIMED)[1:]
            stall = {}
            writer = AsyncCheckpointer()
            for mode in ("sync", "async"):
                es_s = elastic.ElasticState(
                    state.model, state.optimizer, int(state.step),
                    directory=os.path.join(root, f"stall_{mode}"),
                    writer=writer if mode == "async" else None)
                torch.cuda.synchronize()
                t_0 = time.monotonic()
                es_s.commit()
                call_ms = (time.monotonic() - t_0) * 1e3
                for _ in range(EL_STALL_STEPS):
                    bare()
                torch.cuda.synchronize()
                window = (time.monotonic() - t_0) * 1e3
                es_s.wait()
                stall[mode] = dict(
                    commit_call_ms=call_ms, window_ms=window,
                    stall_ms=window - EL_STALL_STEPS * float(
                        np.median(bare_ms)))
            writer.close()
            bare_ms += _loop_times(bare, TR_TIMED)[1:]
            out.update(stall=stall, bare_step_ms_p50=float(
                np.median(bare_ms)),
                trainer_phase_bare_step_ms_p50=TRAINER_BARE_P50.get("ms"),
                clean_step_ms_p50_minus_bare=float(
                    np.median(a["step_ms"]) - np.median(bare_ms)))
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
            os.environ.pop("HVD_FAULT_SPEC", None)
            del os.environ["HVD_MAX_BAD_STEPS"]
            faults.reset()
        emit("elastic", batch=RN_BATCH, epochs=EL_EPOCHS,
             steps_per_epoch=EL_EPOCH_STEPS, commit_every=EL_COMMIT_EVERY,
             kill_step=EL_KILL_STEP, **out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()


@contextlib.contextmanager
def _count_loads():
    """Count the ``.npy`` files ``numpy.load`` opens in the block."""
    opened = []
    real = np.load

    def counting(file, *a, **k):
        opened.append(str(file))
        return real(file, *a, **k)
    np.load = counting
    try:
        yield opened
    finally:
        np.load = real


def _greedy_tokens(model, prompts) -> tuple:
    """CK_REQUESTS greedy requests through a paged engine of CK_SLOTS
    slots; the tokens, and the launches of the round."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine
    eng = GenerationEngine(model, GenerationConfig(
        max_slots=CK_SLOTS, max_len=MAX_LEN, block_size=BLOCK,
        default_max_new_tokens=CK_NEW_TOKENS), device="cuda")
    try:
        eng.warmup()
        torch.cuda.synchronize()
        steps0 = eng.stats()["batches_total"]
        LAUNCHES.reset()
        results = [h.result(600) for h in [eng.submit(p) for p in prompts]]
        torch.cuda.synchronize()
        launches = LAUNCHES.snapshot()
        steps = eng.stats()["batches_total"] - steps0
    finally:
        eng.shutdown()
    return [r["tokens"] for r in results], launches, steps


def phase_lm_ckpt_serve(seed: int):
    """The full-width LM: ZeRO steps, save_sharded, verify, restore into a
    fresh state (bitwise), one more step from each (bitwise), then
    restore_for_inference into the paged engine, whose greedy tokens must
    equal those of an engine built from the live weights."""
    import shutil
    import tempfile
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.checkpoint import (
        read_index, restore_for_inference, restore_sharded, save_sharded,
        verify_checkpoint)
    from horovod_tpu_torch.parallel.transformer import (
        TransformerConfig, make_parallel_train_step)
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    cfg = lm_config()
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    adamw = functools.partial(torch.optim.AdamW, **ADAMW, foreach=True)
    init_state, step = make_parallel_train_step(cfg, adamw, zero=True)
    per_step = {k: cfg.n_layers for k in ATTN_KERNELS}
    state = init_state(seed)
    losses = []
    for i in range(CK_STEPS):
        torch.cuda.synchronize()
        LAUNCHES.reset()
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
        want_launches(LAUNCHES.snapshot(), per_step, f"lm_ckpt step {i}")
    check(all(np.isfinite(losses)), f"lm_ckpt losses {losses}")
    ckdir = tempfile.mkdtemp(prefix="hvd_lm_ckpt_")
    out = dict(losses=losses)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = save_sharded(ckdir, state.step, state.model, state.optimizer)
        save_ms = (time.monotonic() - t0) * 1e3
        live_params = convert.params_to_numpy(state.model)   # as saved
        nbytes = _ckpt_bytes(path)
        t0 = time.monotonic()
        check(verify_checkpoint(path) is True, "lm verify_checkpoint")
        verify_ms = (time.monotonic() - t0) * 1e3
        fresh = init_state(seed + 1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, _, got_step = restore_sharded(ckdir, fresh.model, fresh.optimizer)
        fresh.step = got_step
        torch.cuda.synchronize()
        restore_ms = (time.monotonic() - t0) * 1e3
        check(_bits_equal(_state_bits(state), _state_bits(fresh)),
              "restore_sharded: restored state differs from the live one")
        for st in (state, fresh):
            LAUNCHES.reset()
            step(st, tokens, labels)
            want_launches(LAUNCHES.snapshot(), per_step, "lm_ckpt resume")
        check(all(torch.equal(a, b) for a, b in zip(
            state.model.parameters(), fresh.model.parameters())),
              "resumed LM step: params of the restored and live states "
              "differ")
        del state, fresh
        gc.collect()
        torch.cuda.empty_cache()

        from horovod_tpu_torch.parallel import checkpoint as ckpt
        n_params = sum(1 for kp, _ in ckpt._flatten(read_index(path))
                       if ckpt.keystr(kp).startswith("['params']"))
        with _count_loads() as opened:
            t0 = time.monotonic()
            variables = restore_for_inference(ckdir)
            rfi_ms = (time.monotonic() - t0) * 1e3
        check(sorted(variables) == ["params"] and len(opened) == n_params,
              f"restore_for_inference read {len(opened)} files, "
              f"{n_params} params leaves")
        serve_cfg = TransformerConfig(**LM, dtype=torch.bfloat16,
                                      unembed_dtype=torch.float32)
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(0, cfg.vocab, n) for n in CK_PROMPT_LENS]
        runs = {}
        for name, tree in (("restored", variables["params"]),
                           ("live", live_params)):
            model = convert.params_from_jax(tree, serve_cfg)
            toks, launches, dsteps = _greedy_tokens(model, prompts)
            want_launches(launches, {
                "flash_attention": cfg.n_layers * len(prompts),
                "paged_decode_attention": cfg.n_layers * dsteps},
                f"lm_ckpt engine {name}")
            runs[name] = dict(tokens=toks, launches=launches,
                              decode_steps=dsteps)
            del model
            torch.cuda.empty_cache()
        check(runs["restored"]["tokens"] == runs["live"]["tokens"],
              "greedy tokens of the restored LM differ from the live one's")
        check(all(len(t) == CK_NEW_TOKENS for t in runs["live"]["tokens"]),
              "engine requests did not finish")
        out.update(checkpoint_bytes=nbytes, save_ms=save_ms,
                   save_mb_per_s=nbytes / 1e6 / (save_ms / 1e3),
                   verify_ms=verify_ms, restore_ms=restore_ms,
                   restore_for_inference_ms=rfi_ms,
                   restore_for_inference_files=len(opened),
                   engine=runs)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    emit("lm_ckpt_serve", batch=LM_BATCH, seq=LM_SEQ, zero=True, **out)
    torch.cuda.empty_cache()
    hvd.shutdown()
    return runs["restored"]["launches"]


# -- the mesh axes on one card (slice 13) ------------------------------------

def _mesh_run(cfg, mesh, batch: int, seed: int, steps: int = MESH_STEPS):
    """``steps`` four-axis (or, ``mesh`` None, dp-only) LM steps from
    ``seed`` on the LM batch cut to ``batch`` rows, counters zeroed just
    before them. Returns the state, the losses, the step seconds (host
    clock, each step ending in a read of its loss), the launches and the
    peak bytes."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.transformer import \
        make_parallel_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_state, step = make_parallel_train_step(
        cfg, functools.partial(torch.optim.AdamW, **ADAMW), mesh=mesh)
    state = init_state(seed)
    tokens, labels = lm_batch(LM_BATCH, LM_SEQ, seed)
    tokens, labels = tokens[:batch], labels[:batch]
    torch.cuda.synchronize()
    LAUNCHES.reset()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
        times.append(time.monotonic() - t0)
    return (state, losses, times, LAUNCHES.snapshot(),
            torch.cuda.max_memory_allocated())


def _mesh_line(name, losses, times, launches, peak, **kw) -> dict:
    line = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                step_ms_p50=float(np.median(times)) * 1e3,
                peak_bytes=int(peak), launches=launches, **kw)
    emit("lm_mesh", part=name, **line)
    check(all(np.isfinite(losses)), f"lm_mesh {name}: loss {losses}")
    return line


def phase_lm_mesh(seed: int, peaks, smi: str):
    """(a) the spec-grouped plane bitwise against the dp-only step, (b)
    the ring path, (c) the one-expert MoE, (d) the flash kernels at the
    tp-local shapes."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.parallel.transformer import forward_hidden
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    cfg = lm_config()
    per_step = {k: cfg.n_layers for k in ATTN_KERNELS}
    # (a) dp-only, then the hand-built one-rank mesh with tp named.
    st, l_dp, t_dp, n_dp, pk_dp = _mesh_run(cfg, None, LM_BATCH, seed)
    # On the host: a card copy (1.9 GB) would count in the next run's peak.
    dp_params = [p.detach().cpu() for p in st.model.parameters()]
    del st
    mesh = make_mesh({"dp": 1, "pp": 1, "ep": 1, "tp": 1})
    st, l_m, t_m, n_m, pk_m = _mesh_run(cfg, mesh, LM_BATCH, seed)
    groups = sorted({s.psum for s in st.optimizer._grouped.syncs})
    bitwise = all(torch.equal(a, b.detach().cpu()) for a, b in
                  zip(dp_params, st.model.parameters()))
    del st, dp_params
    want = {k: v * MESH_STEPS for k, v in per_step.items()}
    _mesh_line("a_dp_only", l_dp, t_dp, n_dp, pk_dp, batch=LM_BATCH,
               gpu=smi)
    _mesh_line("a_spec_grouped", l_m, t_m, n_m, pk_m, batch=LM_BATCH,
               mesh=dict(mesh.shape), groups=[list(g) for g in groups],
               params_bitwise_equal_dp_only=bitwise, gpu=smi)
    check(bitwise and l_m == l_dp, "lm_mesh (a): the spec-grouped step's "
          "params or losses differ from the dp-only step's")
    want_launches(n_dp, want, "lm_mesh (a) dp-only")
    want_launches(n_m, want, "lm_mesh (a) spec-grouped")
    # (b) the ring with sp named at size 1, against flash at its batch.
    _, l_fl, _, _, _ = _mesh_run(cfg, None, MESH_RING_BATCH, seed, steps=1)
    ring_mesh = make_mesh({"dp": 1, "pp": 1, "sp": 1})
    st, l_r, t_r, n_r, pk_r = _mesh_run(cfg, ring_mesh, MESH_RING_BATCH,
                                        seed)
    del st
    rel = abs(l_r[0] - l_fl[0]) / abs(l_fl[0])
    _mesh_line("b_ring_sp1", l_r, t_r, n_r, pk_r, batch=MESH_RING_BATCH,
               flash_first_loss=l_fl[0], first_loss_rel_diff=rel,
               tolerance=TOL_RING_LOSS, gpu=smi,
               cut="batch 8 -> 2: one f32 [B,16,2048,2048] block a layer, "
                   "several kept for the backward")
    check(rel <= TOL_RING_LOSS, f"lm_mesh (b): ring loss {l_r[0]} vs "
          f"flash {l_fl[0]} (rel {rel} > {TOL_RING_LOSS})")
    want_launches(n_r, {k: 0 for k in ATTN_KERNELS}, "lm_mesh (b) ring")
    # (c) one expert on ep of size 1.
    moe_cfg = dataclasses.replace(cfg, n_experts=1)
    ep_mesh = make_mesh({"dp": 1, "pp": 1, "ep": 1})
    st, l_e, t_e, n_e, pk_e = _mesh_run(moe_cfg, ep_mesh, LM_BATCH, seed)
    tokens, _ = lm_batch(LM_BATCH, LM_SEQ, seed)
    with torch.no_grad():
        _, aux = forward_hidden(st.model, tokens)
    aux = aux.item()
    del st
    _mesh_line("c_moe_ep1", l_e, t_e, n_e, pk_e, batch=LM_BATCH, aux=aux,
               capacity=20480, dispatch_bytes=20480 * LM["d_model"] * 2,
               gpu=smi)
    check(abs(aux - cfg.n_layers) < 1e-3, f"lm_mesh (c): aux {aux}, "
          f"expected {cfg.n_layers} (one expert takes every token)")
    want_launches(n_e, want, "lm_mesh (c) MoE")
    torch.cuda.empty_cache()
    hvd.shutdown()
    # (d) the kernels at the per-rank shapes of tp > 1.
    rows = {}
    for tp in MESH_TP:
        H = LM["n_heads"] // tp
        got, _ = phase_timing_attn(seed + tp, peaks, H=H, suffix=f"_tp{tp}",
                                   unembed=False)
        rows.update(got)
    H = LM["n_heads"] // 2
    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    q, k, v, do = bhtd_inputs(LM_BATCH // PP_MICRO, LM_SEQ, gen, H)
    bhtd_parity(q, k, v, do, True, f"[B,T,H,D] B={LM_BATCH // PP_MICRO} "
                f"T={LM_SEQ} H={H} causal", phase="parity_attn_bhtd_tp2")
    del q, k, v, do
    torch.cuda.empty_cache()
    rows.update(phase_timing_attn_bhtd(seed, peaks, H=H, suffix="_pptp2"))
    emit("lm_mesh_kernels", gpu=smi, rows=rows,
         note="per-rank shapes of tp=2/4 (K3-qkv, dq, dkv: B=8, T=2048) "
              "and pp x tp=2 (K3-lse, dq/dk/dv [B,T,H,D]: B=4); launches "
              "a step at any tp: n_layers of each")


# -- ZeRO and overlap on every axis (slice 14) ---------------------------------

def _mz_steps(state, step, data, per_step, what: str):
    """MZ_STEPS steps, the launch counters zeroed before each and held to
    ``per_step``. Returns the state, the losses and the step ms (host
    clock, each step ending in a read of its loss)."""
    from horovod_tpu_torch.ops import LAUNCHES
    losses, times = [], []
    for i in range(MZ_STEPS):
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.monotonic()
        state, loss = step(state, *data)
        losses.append(loss.item())
        times.append((time.monotonic() - t0) * 1e3)
        want_launches(LAUNCHES.snapshot(), per_step,
                      f"lm_mesh_zero {what} step {i}")
    check(all(np.isfinite(losses)), f"lm_mesh_zero {what}: {losses}")
    return state, losses, times


def _mz_report(opt, losses, times, peak, smi) -> dict:
    """A variant's line: losses, step p50, peak bytes, the optimizer
    state elements this rank holds (one state tensor's) and the buckets
    of each spec group."""
    if opt.zero:
        plan = opt.plan
        elems = sum(plan.shard_len(i) for i in range(len(plan.buckets)))
        groups: dict = {}
        for i in range(len(plan.buckets)):
            key = f"shard{list(plan.bucket_shard_axes(i))}" \
                  f"+extra{list(plan.bucket_extra(i))}"
            groups[key] = groups.get(key, 0) + 1
    else:
        elems = sum(p.numel() for _, p in opt.named_parameters)
        groups = {"world": None}
        if opt._grouped is not None:
            groups = {}
            for b in opt._grouped.buckets:
                key = f"psum{list(opt._grouped.syncs[b[0]].psum)}"
                groups[key] = groups.get(key, 0) + 1
    return dict(losses=losses, step_ms=times,
                step_ms_p50=float(np.median(times[1:])),
                peak_bytes=int(peak), state_elems_per_rank=int(elems),
                buckets_per_group=groups, zero=opt.zero,
                overlap=opt.overlap, overlap_order=opt.grad_order_source,
                gpu=smi)


def _mz_checkpoint(name, state, params, init, step, data, per_step,
                   seed: int, infer=None) -> dict:
    """``save_sharded`` of a ZeRO state (2-D canonical form), verify,
    restore into a fresh state from another seed (its parameters and
    shards bitwise the live ones), one more step from each (bitwise);
    ``infer(ckdir)`` checks the serving restore. Bytes and times."""
    import shutil
    import tempfile
    from horovod_tpu_torch.parallel.checkpoint import (
        restore_sharded, save_sharded, verify_checkpoint)

    def bits(st):
        return ([p.detach().clone() for p in _leaf_list(params(st))]
                + [v.clone() for d in st.optimizer.zero_state().inner
                   for _, v in sorted(d.items()) if torch.is_tensor(v)])
    ckdir = tempfile.mkdtemp(prefix=f"hvd_mz_{name}_")
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = save_sharded(ckdir, MZ_STEPS, params(state), state.optimizer)
        save_ms = (time.monotonic() - t0) * 1e3
        nbytes = _ckpt_bytes(path)
        t0 = time.monotonic()
        check(verify_checkpoint(path) is True, f"{name} verify_checkpoint")
        verify_ms = (time.monotonic() - t0) * 1e3
        extra = infer(ckdir) if infer is not None else {}
        fresh = init(seed + 1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        restore_sharded(ckdir, params(fresh), fresh.optimizer)
        torch.cuda.synchronize()
        restore_ms = (time.monotonic() - t0) * 1e3
        check(_bits_equal(bits(state), bits(fresh)),
              f"lm_mesh_zero {name}: the restored state differs")
        from horovod_tpu_torch.ops import LAUNCHES
        losses = []
        for st in (state, fresh):
            LAUNCHES.reset()
            st, loss = step(st, *data)
            losses.append(loss.item())
            want_launches(LAUNCHES.snapshot(), per_step,
                          f"lm_mesh_zero {name} resume")
        resumed = losses[0] == losses[1] and all(
            torch.equal(a, b) for a, b in zip(_leaf_list(params(state)),
                                              _leaf_list(params(fresh))))
        check(resumed, f"lm_mesh_zero {name}: the resumed step differs from "
                       f"the uninterrupted one")
        del fresh
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return dict(checkpoint_bytes=nbytes, save_ms=save_ms,
                save_mb_per_s=nbytes / 1e6 / (save_ms / 1e3),
                verify_ms=verify_ms, restore_ms=restore_ms,
                resumed_bitwise=resumed, **extra)


def _leaf_list(params) -> list:
    """The parameters of a module or of the pipelined stages' dict."""
    from horovod_tpu_torch.parallel.pp_transformer import named_leaves
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return [t for _, t in named_leaves(params)]


def phase_lm_mesh_zero(seed: int, smi: str):
    """ZeRO-1 and overlap on the four-axis and the pipelined steps at
    full width on one-rank meshes naming every axis, bitwise their plain
    steps; the hybrid ZeRO checkpoints and the sharded serving
    restore."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel.checkpoint import restore_for_inference
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.parallel.pp_transformer import (
        make_pp_transformer_train_step, named_leaves)
    from horovod_tpu_torch.parallel.transformer import (
        make_parallel_train_step, param_specs)
    hvd.init()
    check(hvd.size() == 1, "expected a 1-rank world")
    cfg = lm_config()
    data = lm_batch(LM_BATCH, LM_SEQ, seed)
    adamw = functools.partial(torch.optim.AdamW, **ADAMW, foreach=True)
    out: dict = {"a": {}, "b": {}}

    # (a) the four-axis step.
    mesh4 = make_mesh({"dp": 1, "pp": 1, "ep": 1, "tp": 1})
    per4 = {k: cfg.n_layers for k in ATTN_KERNELS}
    refs: dict = {}
    for name, on_mesh, kw in MZ_FOUR:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init, step = make_parallel_train_step(
            cfg, adamw, mesh=mesh4 if on_mesh else None, **kw)
        state = init(seed)
        state, losses, times = _mz_steps(state, step, data, per4,
                                         f"(a) {name}")
        peak = torch.cuda.max_memory_allocated()
        host = [p.detach().cpu() for p in state.model.parameters()]
        row = _mz_report(state.optimizer, losses, times, peak, smi)
        for ref in ("dp_zero", "plain"):
            if ref in refs and ref != name:
                r_losses, r_host = refs[ref]
                row[f"bitwise_{ref}"] = losses == r_losses and all(
                    torch.equal(a, b) for a, b in zip(host, r_host))
                check(row[f"bitwise_{ref}"], f"lm_mesh_zero (a) {name}: "
                      f"params or losses differ from the {ref} step's")
        if name in ("dp_zero", "plain"):
            refs[name] = (losses, host)
        if name == "zero":
            specs = param_specs(cfg, mesh4)

            def spec_fn(path, leaf):
                node = specs
                for k in path[1:]:
                    node = node[k]
                return node

            def infer(ckdir, live=convert.params_to_numpy(state.model)):
                t0 = time.monotonic()
                got = restore_for_inference(ckdir, mesh=mesh4,
                                            spec_fn=spec_fn)
                ms = (time.monotonic() - t0) * 1e3
                flat = dict(_tree_leaves(got["params"]))
                same = flat.keys() == dict(_tree_leaves(live)).keys() and \
                    all(np.array_equal(flat[k], v)
                        for k, v in _tree_leaves(live))
                check(same, "lm_mesh_zero (c): restore_for_inference(mesh=) "
                            "differs from the live model")
                return dict(restore_for_inference_ms=ms,
                            restore_for_inference_equal=same)
            row["checkpoint"] = _mz_checkpoint(
                "four_axis", state, lambda st: st.model, init, step, data,
                per4, seed, infer)
        del state, host
        out["a"][name] = row
    del refs

    # (b) the pipelined step.
    mesh3 = make_mesh({"dp": 1, "pp": 1, "tp": 1})
    perpp = {k: cfg.n_layers * PP_MICRO for k in BHTD_KERNELS}
    base = None
    for name, kw in MZ_PP:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init, step = make_pp_transformer_train_step(
            cfg, mesh3, adamw, PP_MICRO, **kw)
        state = init(seed)
        state, losses, times = _mz_steps(state, step, data, perpp,
                                         f"(b) {name}")
        peak = torch.cuda.max_memory_allocated()
        host = [t.detach().cpu() for _, t in named_leaves(state.params)]
        row = _mz_report(state.optimizer, losses, times, peak, smi)
        if base is None:
            base = (losses, host)
        else:
            row["bitwise_plain"] = losses == base[0] and all(
                torch.equal(a, b) for a, b in zip(host, base[1]))
            check(row["bitwise_plain"], f"lm_mesh_zero (b) {name}: params "
                  f"or losses differ from the plain pipelined step's")
        if name == "zero":
            row["checkpoint"] = _mz_checkpoint(
                "pipelined", state, lambda st: st.params, init, step, data,
                perpp, seed)
        del state, host
        out["b"][name] = row
    emit("lm_mesh_zero", batch=LM_BATCH, seq=LM_SEQ, steps=MZ_STEPS,
         microbatches=PP_MICRO, four_axis_mesh=dict(mesh4.shape),
         pp_mesh=dict(mesh3.shape), gpu=smi, **out,
         note="one card: every non-scatter axis has size 1, so the "
              "exchange moves nothing; step_ms_p50 leaves out the first "
              "step (first use, and the overlap probe)")
    torch.cuda.empty_cache()
    hvd.shutdown()


def _tree_leaves(tree, prefix=""):
    """``(key path, numpy leaf)`` of a flax-form tree of dicts and
    lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--elastic-worker", action="store_true",
                    help="run as one rank of the elastic phase's launched "
                         "world (started by the launcher, not by hand)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import horovod_tpu_torch ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 2
    if args.elastic_worker:
        return elastic_worker(args.seed)
    errs, launches, times = {}, {}, {}
    try:
        smi = phase_device()
        peaks = peaks_for(smi)
        phase_build()
        errs.update(phase_parity(args.seed))
        model = build_model(args.seed)
        launches.update(phase_engine(model, args.seed))
        phase_e2e(model, args.seed)
        del model
        torch.cuda.empty_cache()
        times.update(phase_timing(args.seed, peaks))
        errs.update(phase_parity_conv(args.seed))
        launches.update(phase_train(args.seed))
        phase_e2e_train(args.seed)
        times.update(phase_timing_conv(args.seed, peaks))
        phase_parity_attn(args.seed)
        launches.update(phase_lm_train(args.seed, peaks))
        phase_e2e_lm_train(args.seed)
        attn_times, attn_errs = phase_timing_attn(args.seed, peaks)
        times.update(attn_times)
        errs.update(attn_errs)
        errs.update(phase_parity_attn_bhtd(args.seed))
        launches.update(phase_pp_lm_train(args.seed, peaks))
        phase_e2e_pp_lm_train(args.seed)
        times.update(phase_timing_attn_bhtd(args.seed, peaks))
        phase_train_knobs(args.seed)
        phase_guard(args.seed)
        phase_zero_overlap(args.seed)
        phase_trainer(args.seed)
        phase_elastic(args.seed)
        phase_lm_ckpt_serve(args.seed)
        phase_lm_mesh(args.seed, peaks, smi)
        phase_lm_mesh_zero(args.seed, smi)
        phase_bench(smi)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches.get(name, 0),
                    max_abs_err=errs[name], **times[name])
               for name in ("flash_attention", "paged_decode_attention",
                            "fused_conv_bn_fwd", "fused_conv_bn_bwd")
               + ATTN_KERNELS + BHTD_KERNELS]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
