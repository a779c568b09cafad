#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's four main paths, the training-plane knobs (ZeRO-1
and the overlapped exchange among them), the Trainer with its
checkpoints, the launcher with elastic recovery, the checkpoint-to-serving
chain, and the tool entries (the bench, the serving bench and the step
profiler), and
holds every CUDA kernel on them against its plain PyTorch version on the
card:

* serving — the generation engine serving the bench LM at full width
  (paged and contiguous layouts, prefix reuse with the chunked prefill,
  the host tier, speculative decoding, LoRA tenants, int8 weights; a
  fleet of thread and subprocess replicas behind one router; a one-rank
  tp mesh, and a tp=2 world of two gloo ranks sharing the card)
  (``bench.py``'s ``_LM_TPU``: vocab 32768, d_model 2048, 16 heads
  of 128, 8 layers, d_ff 8192; random weights from a seed), and the
  single-shot engine serving ResNet-50 beside it over HTTP;
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
* the other conv families — the bench's ResNet-101 (``--conv-backend
  fused``, K1/K2 in stages 0–1), VGG-16 and Inception V3 rows at full
  width (batch 96), ResNet-101 fused and each new family (VGG, Inception,
  the pre-activation CIFAR ResNet, the space-to-depth stem) card against
  CPU, cross-replica BatchNorm in two gloo ranks sharing the card, and
  the ImageNet example under the launcher with its resume;
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
               its largest value, six launches bitwise equal; and as the
               speculative verify launches it (S·W rows, ``plan_rows=S``),
               each column bitwise the S-row decode launch.
4. engine   — ``GenerationEngine`` (8 slots, max_len 2048, paged with
               ``paged_kernel=True``, block 16), ``warmup()``, 8
               concurrent requests of 32 new tokens with prompts from 9 to
               1500 tokens, one over
               ``HttpServer`` ``POST /generate``. Launch counters are
               zeroed just before the requests and read just after: the
               flash kernel must run n_layers times per prefill, the
               paged kernel n_layers times per decode step. The same
               load runs again under ``torch.profiler`` for the device's
               busy share and the kernels that take its time.
5. e2e      — a 256-token prompt + 4 decode steps through the port on
               the card and, from the same weights, on the CPU (where
               the plain versions run); last logits compared.
6. engine_kv — the KV and decoding plane on the same model, launch
               counters zeroed before each run and read after: (a) the
               contiguous layout on the engine phase's 7 prompts (n_layers
               K3-fwd a prefill, no K8; token agreement with the paged
               streams and the first step's logits against the paged
               functions', reported); (b) prefix reuse with the chunked
               prefill (chunks of 128): a 1536-token system prompt with 8
               suffixes of 64–300 tokens, each cold on a fresh engine, then
               one by one and all together on a warm one: every hit's
               stream equal to its cold one, the hits and skipped chunks in
               ``stats()``, no block held by a stream after the drain, TTFT
               p50 of hits and colds; (c) the host tier: a prompt that
               fills the pool offloads the registered prefix, the next
               admission waits for its prefetch; fetched bytes equal the
               offloaded ones, the stream the resident one's, offload and
               prefetch ms a block; (d) speculation (k = 4) on repetitive
               prompts in both layouts, spec off and on: n_layers K8 a
               decode or verify step (paged), acceptance, decode tokens/s,
               the greedy streams' agreement and the verify rows against
               sequential decode rows (bitwise or max |Δ|, and which GEMM
               shapes give a row other bits at M = S·W than at M = S).
               Every paged engine of the serving phases passes
               ``kv_layout="paged", paged_kernel=True``: K8 is measured.
6a. engine_lora — multi-tenant LoRA on the same model: rank 16, alpha
               32, all four targets, a table of 4 rows with 3 tenants
               resident, 8 slots, paged with K8. A base-only round and a
               round mixing base and the three tenants on fresh engines
               (decode step p50, TTFT p50, K3-fwd and K8 launches; the
               mixed round again under ``torch.profiler``); each
               tenant alone bitwise the same tenant mixed (greedy and
               seeded); the mixed round's base streams bitwise a plain
               engine's; one tenant's prefill and 4 paged decode steps
               with ``adapters=`` on the card against the CPU's plain
               versions from the same table (TOL_E2E), the card at most
               half as far from them as the CPU's wrong-delta controls
               (base, another row, unscaled); a preempt-by-evict drill (one slot, a priority-1
               tenant evicts a base stream) whose evicted stream ends
               bitwise its unpreempted run, spec off (checked) and on
               (reported); an adapter saved, restored, reloaded and
               generating the same tokens.
6b. routing — F1 and F2: the default paged engine (``paged_kernel=False``,
               the gather) bitwise the contiguous engine of engine_kv (a)
               with no K8 launch; an f32 model (the bench widths, 2
               layers) through the prefill and paged decode on the card
               against the CPU (TOL_F32), no kernel launched; a bf16
               d_head-64 engine with ``paged_kernel=True`` generating
               (the model routes to the plain versions: no kernel
               launched, ``stats()["kernels"]`` all False); one f32
               fused-backend ResNet-50 step (plain K1/K2 versions) against
               the f32 stock step's loss.
6c. engine_int8 — int8 serving weights: the engine phase's model
               quantized on the host (``quantize_tree``), an int8 engine
               (``params_from_jax`` of the int8 tree) beside a plain engine
               on the dequantized f32 weights, both the engine phase's
               configuration and prompts: (a) the bytes each model plus
               ``gen_weights`` holds on the card (int8 at most
               INT8_MAX_BYTES); (b) greedy and seeded streams, bitwise
               equal; (c) TTFT and decode step p50; (d) n_layers K3-fwd a
               prefill and K8 a step on the int8 path; (e) the int8 path's
               logits on the card against the CPU's (e2e's prompt,
               TOL_E2E); one int8 round under ``torch.profiler``.
6d. serve_single — ResNet-50 (stock convs, bf16, ``train=False``)
               through the single-shot ``Engine`` (max_batch 32, 5 ms):
               the six buckets warmed (seconds), 256 one-image requests in
               bursts of 1, 3, 8 and 32, every served row bitwise
               ``apply_fn`` rerun on its recorded executed batch;
               request, queue and execute p50/p99, images/s, fill ratio;
               4 images' card logits against the CPU's (TOL_SS_CPU); then
               ``HttpServer(engine=..., generate=<the int8 engine>)``: one
               ``/predict`` (bitwise the served row), one ``/generate``,
               ``/healthz`` and a ``/metrics`` scrape holding
               ``hvd_request_seconds``, ``hvd_generate_ttft_seconds`` and
               ``hvd_build_info`` for both ``engine=`` labels.
6e. fleet   — the serving fleet on the engine phase's model and load
               (paged with K8; 16 requests of 16 new tokens, greedy and
               seeded in turns) against one uninterrupted engine's
               streams: (a) two thread replicas behind
               ``HttpServer(generate=FleetRouter)`` with
               ``replica_kill=r1@stream=3``: every stream bitwise its
               reference, resumed >= 1, exhausted 0, ``/healthz`` with the
               membership, ``/metrics`` with ``replica=`` labels, K3-fwd
               and K8 launched; (b) a ``python -m
               horovod_tpu_torch.serve.proc_replica`` child on the card
               (the same seed; it loads the kernels the build phase built)
               beside a thread replica: its first stream alone, then
               SIGKILLed mid-stream (``replica_proc_kill``), its streams
               resumed on the thread replica bitwise; (c) the autoscaler
               (1 to 2 replicas) over two bursts: one grow, one shrink,
               every stream bitwise. TTFT and decode step p50 against the
               single engine, the dispatch split, spawn → ready, kill →
               detection and → each stream's first resumed token. Every
               child is reaped, on failure too.
6f. serve_tp — serving under a tp mesh: (a) the bench LM on a one-rank
               tp mesh (``make_mesh({"tp": 1})``, the same weights) at the
               engine phase's load in both layouts (paged with K8), one
               request over ``HttpServer`` on the leader: every stream
               bitwise the plain engine's, n_layers K3-fwd a prefill and
               K8 a step, decode step p50 beside the plain engine's; (b)
               K3-fwd at T=2048 and K8 in the balanced and engine-mix
               plans at 8 and 4 heads (tp 2 and 4) against their plain
               versions, timed beside their bounds (K3-fwd beside SDPA);
               (c) a tp=2 world of two processes on the one card (this
               script's ``--serve-tp-rank`` mode: ``dist.init_process_group
               ("gloo")``, then ``hvd.init(device="cuda")``), the bench LM
               at full width with 8 heads a rank: 16 requests of 16 new
               tokens, greedy and seeded in turns, in both layouts, then a
               follower SIGKILLed mid-round. Each stream's agreement with
               the one-rank engine's (greedy streams checked identical up
               to a token whose top-2 margin is within 2 x the measured
               |Δ|), the logits' max |Δ| on one prefill and one decode
               step, the plane's host ms a descriptor, the followers'
               K3-fwd and K8 launches against the leader's, kill → the
               leader's error (its started streams fail with the
               group's error, the others are refused as closed). Step
               times in (c) are not tp speed: both ranks share one card
               and a gloo link.
6g. fleet_tp — a fleet of tp groups: ``FleetRouter`` over two tp = 2
               groups of the bench LM (``spawn_replica_factory`` with
               ``"tp": 2``: four processes, two gloo worlds sharing the
               card, 8 heads a rank), paged with K8, the fleet phase's 16
               requests of 16 tokens, submitted at once (the router
               spreads the burst over both groups): each rank's K3-fwd
               and K8 launches
               (its counters, read from its heartbeat just before and
               just after the round; each follower's equal to its
               leader's, K3-fwd n_layers a prefill); then the same round
               with a follower of r0 SIGKILLed after r0's third stream's
               first token: every stream bitwise its undisturbed stream,
               strands resumed, r0's leader gone within the world's
               timeout. Spawn → ready, kill → detection and → first
               resumed token, decode step p50 a group, peak bytes a rank;
               no rank outlives the shutdown.
7. timing   — each kernel's median time beside its bound, its plain
               version's time and a library yardstick's; the flash
               forward's and K8's host time per call. K8 at four shapes
               (PAGED_TIMED), each launch on the next of 8 layer views
               of the engine's pool.
8. parity_conv — K1/K2 (``fused_conv_bn.cu``) vs their plain versions at
               every distinct (M, Cin, Cout, prologue) of the 16 fused
               sites and a ragged M, with non-zero stats cotangents, and
               at a ragged M with an O(1) prologue shift and ds1 (rows past
               M must add nothing to the sums), and at shapes that take the
               kernels' other paths (CONV_EDGE); two launches must agree
               bitwise.
9. train    — the fused ResNet-50 train step: 2 warmup + 10 timed steps
               on the bench's fixed synthetic batch; launch counters
               zeroed before the timed steps (16 K1 + 16 K2 per step);
               the loss must be finite and fall. Then the same with the
               stock backend (cuDNN convs, PyTorch BatchNorm) as the
               model-level yardstick.
10. train_profile — one fused step under ``torch.profiler``.
11. e2e_train — one step of full-width ResNet-50 at batch 8 on the card
               and on the CPU from the same weights and batch: loss,
               logits, updated params and running statistics compared.
12. timing_conv — K1 and K2 at each of the eight site shapes beside
               their bounds and a GEMM-only yardstick (plain versions at
               two of them), and the per-step sums over the 16 sites.
13. parity_attn — the packed forward with lse (K3-qkv) and the dq/dkv
               backward pair vs their plain versions at B=1, H=16,
               d=128: T in {128, 1024, 2048} causal, T=256 non-causal
               and T in {1000, 129, 2, 65, 191} causal (lengths that the
               kernels' 64- and 128-row tiles cut raggedly); six launches
               must agree bitwise.
14. lm_train — the full-width LM train step: 2 warmup + 10 timed steps
               on a fixed random batch; launch counters zeroed before the
               timed steps (8 K3-qkv + 8 dq + 8 dkv per step, no prefill
               K3-fwd); step p50, tokens/s, MFU, peak memory; the loss
               must be finite and fall.
15. lm_train_profile — one LM step under ``torch.profiler``.
16. e2e_lm_train — one full-width step (4 of the 8 layers) at batch 1,
               T=256 on the card and
               on the CPU from the same weights and batch: loss, logits,
               gradients and updates compared.
16a. coord — the host coordination plane (``horovod_tpu_torch/coord``,
               built by g++ from ``coord/csrc/coordinator.cc``): two ranks
               sharing the card on a gloo group that ``init()`` adopts
               (this script's ``--coord-rank`` mode), first a plain world
               (``coordinator=False``), then a coordinated one on the
               loopback. (a) the eager API on CUDA tensors (f32, bf16,
               int32 allreduces on the star and, above
               ``HOROVOD_RING_THRESHOLD``, the ring; a ragged allgather,
               a broadcast from rank 1, alltoall, reducescatter,
               ``broadcast_object``) bitwise a host numpy reference and
               the plain world; (b) the full-width LM (COORD_LAYERS of
               its 8 layers, batch COORD_BATCH a rank, T=2048), 3 dp
               steps whose loss is averaged and whose step is resolved
               through the coordinator, every loss bitwise the plain
               world's, K3-qkv and the dq/dkv pair launched; (c) rank 1
               submits another shape: both ranks raise
               ``FailedPreconditionError`` within COORD_MISMATCH_S; (e)
               eager allreduce at 4 KiB, 1 MiB, 64 MiB on the star and
               the ring (median ms, GB/s); (d) rank 1 SIGKILLed mid-step:
               rank 0 raises ``WorkerFailureError`` naming rank 1 within
               ``HVD_HEARTBEAT_TIMEOUT`` + COORD_KILL_SLACK_S.
17. timing_attn — K3-qkv and the dq/dkv pair at the LM step's shape
               (B=8, H=16, T=2048, causal) vs their plain versions (the
               kernels line's max_abs_err; six launches bitwise equal),
               then timed beside their bounds, plain versions and SDPA;
               the Delta pass outside the kernels (``timing_delta``).
18. parity_attn_bhtd — the [B,T,H,D] forward with lse and the dq and
               dk/dv kernels (K6's constants) vs their plain versions at
               the pp step's shape (B=4, H=16, T=2048, causal; q/k/v
               strided slices of a packed [B,T,H,3,d] projection, q
               prescaled; the kernels line's max_abs_err), at B=1,
               T=1000 causal and T=256 non-causal, and at B=2, T=191
               causal; six launches must agree bitwise.
19. pp_lm_train — the full-width pipelined step: 2 warmup + 10 timed
               steps on lm_train's batch; counters zeroed before the timed
               steps (16 lse forwards + 16 dq + 16 dkv per step, no packed
               K3-qkv and no forward without lse); step p50, tokens/s,
               MFU, peak memory; the loss must be finite and fall.
20. pp_lm_train_profile — one pipelined step under ``torch.profiler``.
21. e2e_pp_lm_train — one full-width pipelined step (4 of the 8 layers)
               at batch 2 (2
               microbatches of 1), T=256, on the card (NCCL world) and on
               the CPU (gloo world) from the same weights and batch: loss,
               gradients and the update compared.
22. timing_attn_bhtd — the three [B,T,H,D] launches and the pair at
               B=4, T=2048 beside their bounds, plain versions and SDPA;
               the Delta pass (``timing_delta``).
22a. serve_bench — ``python -m horovod_tpu_torch.serve_bench``'s
               ``main`` in this process, counters zeroed just before and
               read just after: ``--mode generate --model bench_lm``
               (the bench LM, paged with ``--paged-kernel``, block 16, 8
               slots, max_len 2048, 32 new tokens; JAX's open-loop
               schedule with a 1024-token system prompt on half the
               arrivals; deadline 10 s) at 4 and 16 qps for 4 s each:
               exit 0, no in-deadline drop at 4 qps, tokens/s > 0 at
               both points, K3-fwd n_layers a prefill (the completed
               requests and the warmup's buckets) and K8 a multiple of
               n_layers, both > 0 and added to the ``kernels`` line;
               TTFT p50/p99, aggregate and per-user tokens/s, slot fill
               and peak bytes a point. Then ``--mode predict --qps 200
               --duration 2`` (the MLP through ``serve.Engine``): every
               request served, no kernel launched.
22b. profile_step — ``python -m horovod_tpu_torch.profile_step``'s
               ``main`` in this process: ``--model transformer_lm
               --steps 3`` (the bench's LM step) and ``--model resnet50
               --conv-backend fused --steps 3``: the trace's step count
               3, the categories summing to the busy total, busy a step
               at most the step's wall, the hand-kernel categories
               non-zero (``flash_fwd_wgmma``, ``flash_bwd_dq``,
               ``flash_bwd_dkv`` in the LM; ``conv_bn_fwd``,
               ``conv_bn_bwd`` in the ResNet), each printed beside
               ``PERF.md`` §5's device time of the same step.
23. train_knobs — the full-width LM, two steps per variant from the same
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
24. guard   — the fused ResNet-50 at batch 128 with the bad-step guard: a
               NaN image leaves params, momentum and BatchNorm buffers
               bit-unchanged with bad_step 1 and loss 0 (16 K1 + 16 K2
               still launched), the next finite step trains; the step
               time with the guard off and on, in turns.
25. zero_overlap — ZeRO-1 and the backward-overlapped exchange on the
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
26. trainer — the fused ResNet-50 at batch 128 through ``Trainer.fit``
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
27. elastic — the launcher and elastic recovery: the fused ResNet-50 at
               batch 128 through ``Trainer.fit`` under
               ``run_with_recovery`` with ``ElasticState(commit_every=2,
               writer=AsyncCheckpointer)`` (durable at each epoch's end),
               2 epochs of 4 steps, cuDNN pinned deterministic, run by
               ``python -m horovod_tpu_torch.launcher -np 1`` as this
               script's ``--elastic-worker`` mode: (a) a clean run of
               the worker's function in this process; (b) the worker
               launched with ``--restarts 1``,
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
28. lm_ckpt_serve — the full-width LM (4 of its 8 layers) with
               ``zero=True``: 2 steps (4 K3-qkv + 4 dq + 4 dkv each), ``save_sharded``,
               ``verify_checkpoint``, ``restore_sharded`` into a fresh
               state bitwise equal to the live one, one more step from
               each with bitwise-equal params; ``restore_for_inference``
               (reads only the params' files) through
               ``convert.params_from_jax`` into a paged engine (8 slots,
               max_len 2048, block 16): 4 greedy requests of 16 new tokens
               give the same tokens as an engine built from the live
               weights, the flash kernel running n_layers times per
               prefill and K8 n_layers times per decode step; then
               ``restore_for_inference(dtype="int8")`` of the same
               checkpoint served the same way, its tokens equal to
               ``quantize_model`` of the f32 restore's (engine_int8 (f));
               bytes,
               save, verify, restore and ``restore_for_inference`` times.
               Checkpoints go to a temporary directory removed after each
               of these two phases.
29. lm_mesh — the mesh axes of the full-width LM on one card, counters
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
30. lm_mesh_zero — ZeRO-1 and overlap on every axis of the full-width
               LM cut to MZ_LAYERS layers, on one card, AdamW with
               ``foreach`` pinned, counters
               zeroed before each step: (a) the four-axis step on the
               one-rank ``make_mesh({"dp", "pp", "ep", "tp"})`` (the
               hybrid ZeRO plane with every non-scatter axis at size 1)
               plain, ``zero``, ``overlap`` and both, MZ_STEPS steps
               each, params and losses bitwise the dp-only ``zero=True``
               step's and the plain step's, one K3-qkv, dq and dkv a
               layer a step; (b) the pipelined step on ``make_mesh({"dp",
               "pp", "tp"})`` (2 microbatches of 4) plain, ``zero``,
               ``overlap`` and both, bitwise the plain step's, 2 K3-lse
               and 2 of its dq/dkv pair a layer a step; step p50,
               peak bytes, optimizer-state elements and buckets per spec
               group of each; (c) ``save_sharded`` of (a)'s and (b)'s
               ZeRO states in the 2-D canonical form, restore (verified
               against the manifest) into a fresh state, one more step
               from each, bitwise; ``restore_for_inference(mesh=,
               spec_fn=)`` of (a)'s leaf for leaf the live model's;
               bytes, save and restore times.
31. bench   — ``python -m horovod_tpu_torch.bench``'s ``main`` twice in
               this process, over one timed region each (no flags: the
               stock ResNet and the plain LM lines; ``--model
               transformer_lm --zero --overlap --accum-steps 2``): names,
               finite positive values, 0 < mfu <= 1, the knob fields, the
               peak bytes, the card; then ``--scaling --model resnet50
               --conv-backend fused --rounds 1`` in a process of its own
               (a launcher world of 1 timed over one region: the scaling
               line of 1 GPU, then the per-GPU line, the fused ResNet's,
               with its phases).
32. models  — the bench's other conv rows and the other families:
               (a) the bench's ``main`` in this process for ``--model
               resnet101 --conv-backend fused``, ``--model vgg16`` and
               ``--model inception3`` (``--rounds 1`` each; full width:
               224², 224² and 299², batch 96, bf16, local BatchNorm):
               each line's name, a finite positive value, 0 < mfu <= 1
               over ``FWD_GMACS``, the peak bytes, the card, and
               ``conv_backend: "fused"`` for resnet101, whose run must
               launch K1 and K2 16 times a forward-backward (counters
               zeroed before it, read after: the ``kernels`` line's
               totals), the others none; (b) ResNet-101 fused at flax's
               init, batch MD_RN101_BATCH at MD_RN101_IMAGE² (both
               stages' rows pass the ``M % 128`` gate), one SGD step on
               the card (K1/K2 at all 16 sites) and on the CPU (their
               plain versions) from the same weights: loss, logits, the
               update's cosine, per-leaf updates and running statistics
               within TOL_E2E_TRAIN; (c) VGG-16 (at 32², dense 4096),
               Inception V3 (160²), ``cifar_resnet_v2(56)`` (32²) and
               ResNet-50 with the space-to-depth stem (64²), in f32 (no
               TF32) at a small batch, dropout off, card against CPU
               from the same seeded weights: loss, logits, running
               statistics and the gradients' cosine in f32, every
               gradient leaf in f64, within TOL_FAMILY.
33. sync_bn — cross-replica BatchNorm: two gloo ranks share the card
               (this script's ``--sync-bn-rank`` mode; a gloo group, then
               ``hvd.init(device="cuda")`` adopts it), each with half of
               a global batch of 8 whose halves differ in statistics, two
               SGD steps with ``axis_name=hvd.AXIS``: ``cifar_resnet_v1
               (20)`` in f32 at 32², and ResNet-50 at 64² on the fused
               backend (K1/K2 at every site: ``fold``'s group mean). The
               ranks' running statistics must be bitwise equal; losses,
               params, statistics and whole-batch eval logits must match
               one card process training on the whole batch (local BN)
               within TOL_SYNC; the same ranks with local BatchNorm (the
               control) must miss it.
34. conv_examples — ``python -m horovod_tpu_torch.launcher -np 1``
               running ``horovod_tpu_torch.examples.imagenet_resnet50
               --image 64 --classes 10 --epochs 2 --ckpt-dir <tmp>``
               (synthetic data, cross-replica BatchNorm, rank-0
               asynchronous checkpoints), then again with ``--epochs
               3``: it must resume from the saved step and print its
               allreduced final eval.

Every line carries ``phase_s``, the seconds since its phase began, and
a ``phase_seconds`` line lists each phase's wall seconds. Then, before
the last line, the card's ``name, power.limit`` and one
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
import io
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Optional

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
E2E_T, E2E_STEPS = 256, 4      # e2e's (and engine_int8 (e)'s) prompt, steps
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
# e2e_lm_train's and e2e_pp_lm_train's depth: the bench LM's width, 4 of
# its 8 layers (cut for the script's time: the CPU's side of each
# comparison is most of its phase).
E2E_LM_LAYERS = 4
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
# arguments, each through its main() in this process; its metric names
# per run.
# Each run times one region: the phase checks the entry's lines, not its
# rates (train, lm_train, zero_overlap and train_knobs time those steps
# at depth). The plain run gives the stock ResNet and the plain LM lines
# from one process, the LM's knobs (ZeRO, overlap, accumulation) share
# another, and the fused ResNet line comes from the --scaling world of 1.
BENCH_RUNS = ((("--rounds", "1"),
               ("resnet50_synthetic_images_per_sec_per_gpu",
                "transformer_lm_tokens_per_sec_per_gpu")),
              (("--model", "transformer_lm", "--zero", "--overlap",
                "--accum-steps", "2", "--rounds", "1"),
               ("transformer_lm_tokens_per_sec_per_gpu",)))
BENCH_TIMEOUT = 400
# The --scaling sweep through the launcher: one world of 1 on one card,
# over one timed region; its per-GPU line is the fused ResNet line.
BENCH_SCALING = ("--scaling", "--model", "resnet50", "--conv-backend",
                 "fused", "--rounds", "1")
# The bench's other conv rows (models (a)), each through the bench's main
# in this process over one timed region; resnet101's must launch K1 and
# K2 RN_SITES times a forward-backward.
MD_BENCH = (("resnet101", ("--model", "resnet101", "--conv-backend",
                           "fused", "--rounds", "1")),
            ("vgg16", ("--model", "vgg16", "--rounds", "1")),
            ("inception3", ("--model", "inception3", "--rounds", "1")))
# models (b): ResNet-101 fused, card vs CPU, at flax's init: batch 4 at
# 128² (stage rows 4096 and 1024 pass the M % 128 gate).
MD_RN101_BATCH, MD_RN101_IMAGE = 4, 128
MD_RN101_PARAMS = ("stem.kernel", "BottleneckBlock_0.shortcut.kernel",
                   "BottleneckBlock_3.shortcut.kernel",
                   "BottleneckBlock_1.BatchNorm_2.scale",
                   "BottleneckBlock_5.BatchNorm_2.scale",
                   "BottleneckBlock_32.BatchNorm_2.scale", "head.kernel")
MD_RN101_STATS = ("stem_bn.var", "BottleneckBlock_0.BatchNorm_0.mean",
                  "BottleneckBlock_2.BatchNorm_2.var",
                  "BottleneckBlock_3.shortcut_bn.mean",
                  "BottleneckBlock_32.BatchNorm_1.var")
# models (c): each family on the card and the CPU from the same seeded
# weights, dropout off: (name, input hw, batch). In f32 (TF32 off): loss,
# logits, running statistics, and the gradients' whole-model cosine at
# TOL_E2E_TRAIN's bound; in f64 every gradient leaf too. (f32 leaves are
# not held one by one: through Inception's random-init BatchNorm chains
# the CPU's own f32 gradients are up to 0.40 of a leaf off its f64 ones,
# at a cosine of 0.999.) Errors are max|card - cpu| / max|cpu| per leaf
# (logits: over the batch); each bound well inside TOL_E2E_TRAIN's.
MD_FAMILY = (("vgg16", 32, 2), ("inception3", 160, 2),
             ("cifar_resnet_v2_56", 32, 4), ("resnet50_s2d", 64, 2))
TOL_FAMILY = {"loss": 1e-4, "logits": 1e-3, "grads": 1e-2,
              "batch_stats": 1e-4, "grad_cosine": 0.9999}
# sync_bn: two gloo ranks on the card, each half of a global batch of
# SB_BATCH (the second half shifted and scaled), SB_STEPS SGD steps,
# against one process training on the whole batch. f32 (no TF32): the
# CPU test's tolerances (loss 1e-4 relative; params, running statistics
# and eval logits 1e-3 of each leaf's largest entry). bf16 fused: the
# loss as e2e_train's, the update's cosine, the statistics and the eval
# logits 3e-2 relative (a CPU rehearsal measured 2.8e-3 and 4.6e-3; the
# local-BN control 0.97 and 0.48). The control must miss the reference
# by more than the tolerance in statistics and logits.
SB_BATCH, SB_STEPS = 8, 2
SB_WORLD_S = 240.0
TOL_SYNC = {"f32": {"loss": 1e-4, "params": 1e-3, "batch_stats": 1e-3,
                    "logits": 1e-3, "update_cosine": 0.9999},
            "bf16": {"loss": 2e-3, "batch_stats": 3e-2, "logits": 3e-2,
                     "update_cosine": 0.99}}
# conv_examples: the imagenet example under the launcher, then resumed.
EX_ARGS = ("--image", "64", "--classes", "10")
EX_TIMEOUT = 300
# The serving bench entry (serve_bench): two generate-mode operating
# points of the bench LM through the port's serve_bench main, then one
# predict-mode point of its MLP Engine.
SB_GEN = ("--mode", "generate", "--model", "bench_lm", "--kv-layout",
          "paged", "--paged-kernel", "--block-size", "16", "--slots", "8",
          "--max-len", "2048", "--gen-tokens", "32", "--prefix-tokens",
          "1024", "--prefix-mix", "0.5", "--deadline-ms", "10000", "--qps",
          "4,16", "--duration", "4")
SB_PREDICT = ("--mode", "predict", "--qps", "200", "--duration", "2")
# The step profiler entry (profile_step): each run's arguments, the
# hand-written kernel categories its trace must show, and PERF.md §5's
# device ms a step of the same step (the earlier torch.profiler
# readings of the LM and the fused ResNet-50) printed beside its own.
PS_RUNS = (("transformer_lm", ("--model", "transformer_lm", "--steps", "3"),
            ("flash_fwd_wgmma", "flash_bwd_dq", "flash_bwd_dkv"), 150.9),
           ("resnet50_fused", ("--model", "resnet50", "--conv-backend",
                               "fused", "--steps", "3"),
            ("conv_bn_fwd", "conv_bn_bwd"), 92.2))
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
# of the full-width LM cut to CK_LAYERS of its 8 layers (for the script's
# time: the coord phase came in beside it), save_sharded, restore into a
# fresh state, one more step from each; restore_for_inference into
# engines of CK_SLOTS slots, CK_REQUESTS greedy requests of CK_NEW_TOKENS
# new tokens.
CK_STEPS, CK_LAYERS = 2, 4
CK_SLOTS, CK_REQUESTS, CK_NEW_TOKENS = 8, 4, 16
CK_PROMPT_LENS = (37, 300, 900, 1500)
# The launcher and elastic recovery (elastic): the fused ResNet-50 at
# batch 128 through Trainer.fit under run_with_recovery, EL_EPOCHS
# epochs of EL_EPOCH_STEPS steps, an async commit every EL_COMMIT_EVERY
# steps (durable at each epoch's end), in a world of 1: (a) clean, in
# this process; (b) started by the launcher, killed after global step
# EL_KILL_STEP of restart epoch 0 and relaunched once (--restarts 1, no
# backoff), which must resume from EL_RESUME and end bitwise as (a); (c)
# in this process, commits at steps 2 and 4, the step-4 commit's bytes
# flipped, then NaN batches until HVD_MAX_BAD_STEPS=EL_BAD_BUDGET runs
# out: the rollback walks past step 4 to step 2, then EL_AFTER finite
# steps. EL_STALL_STEPS steps after a sync and after an async commit give
# the stall.
EL_EPOCHS, EL_EPOCH_STEPS, EL_COMMIT_EVERY = 2, 4, 2
EL_KILL_STEP, EL_RESUME = 5, 4
EL_BAD_BUDGET, EL_AFTER, EL_STALL_STEPS = 2, 2, 4
EL_TIMEOUT = 300
# The mesh axes (slice 13) on one card.
MESH_STEPS = 5
MZ_STEPS = 4             # lm_mesh_zero: steps of each variant (p50 of the last 3)
MZ_LAYERS = 4            # lm_mesh_zero's depth (the bench LM's 8, cut in half)
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
# engine_kv: the KV and decoding plane on the bench LM. A shared system
# prompt with 8 suffixes (prefix reuse, chunks of KV_CHUNK_BLOCKS blocks);
# a host-tier engine with a pool of KV_HOST_POOL blocks that a
# KV_PRESSURE_LEN-token prompt fills; speculation at k = KV_SPEC_K on
# prompts of a random KV_SPEC_PERIOD-token period repeated.
KV_NEW_TOKENS = 16
KV_SYSTEM_LEN = 1536
KV_SUFFIX_LENS = (64, 300, 100, 180, 240, 128, 77, 211)
KV_CHUNK_BLOCKS = 8
KV_HOST_POOL = 128
KV_PRESSURE_LEN = 2033
KV_SPEC_K = 4
KV_SPEC_PERIOD, KV_SPEC_REPEATS, KV_SPEC_NEW = 37, 8, 64
# The engine phase's paged streams and decode step p50, which engine_kv's
# contiguous run is set beside.
PAGED_STREAMS = {}
# engine_kv (a)'s contiguous streams, which the routing phase's default
# paged engine must equal bitwise.
CONTIGUOUS_STREAMS = {}
# engine_lora: rank, alpha, table rows, tenants resident, B's scale (so
# the tenants differ), new tokens a stream, the preempt drill's lengths.
LORA_RANK, LORA_ALPHA, LORA_CAPACITY, LORA_TENANTS = 16, 32.0, 4, 3
LORA_B_SCALE = 0.01
LORA_NEW_TOKENS = 32
LORA_PROMPT_LENS = (9, 100, 300, 1000, 64, 200, 600, 40)
LORA_PREEMPT_LEN, LORA_PREEMPT_NEW = 37 * 4, 48
# The tenant's card-vs-CPU reference: a LORA_REF_T-token prompt and
# LORA_REF_STEPS paged decode steps; the card must sit within TOL_E2E of
# the CPU's logits and at most half as far from them as any of the CPU
# controls a wrong delta would produce (base, another row, unscaled).
LORA_REF_T, LORA_REF_STEPS = 256, 4
# routing: the f32 model's depth (bench widths), prompt and decode steps,
# and the card-vs-CPU tolerance on f32 logits (cuBLAS vs MKL summation
# order over K up to 8192); the d_head-64 engine's heads.
ROUTE_LAYERS, ROUTE_T, ROUTE_STEPS = 2, 128, 3
TOL_F32 = 2e-3
ROUTE_HEADS64 = 32
ROUTE_H64_PROMPTS, ROUTE_H64_NEW = (9, 300, 1000, 77), 16
ROUTE_RN_BATCH = 8
TOL_RN_F32 = 1e-3
# engine_int8: the engine phase's configuration and prompts on int8
# weights (quantize_model of the same random weights) beside a plain
# engine on their dequantized f32 weights; the seeded round's sampling;
# the most the int8 engine's weights may hold on the card.
INT8_SAMPLED = dict(temperature=0.8, top_k=50, seed=7)
INT8_MAX_BYTES = 0.55e9
# serve_single: ResNet-50 (stock cuDNN convs, bf16 compute, train=False)
# through the single-shot Engine: SS_REQUESTS one-image requests in
# bursts cycling through SS_BURSTS, each burst answered before the next;
# SS_CPU_IMAGES of them also on the CPU, whose logits the card's must
# match within TOL_SS_CPU (bf16 activations through 53 convs; e2e_train's
# logits bound).
SS_MAX_BATCH, SS_TIMEOUT_MS = 32, 5.0
SS_REQUESTS, SS_BURSTS = 256, (1, 3, 8, 32)
SS_CPU_IMAGES = 4
TOL_SS_CPU = 1e-2
# fleet: the serving fleet on the bench LM at the engine phase's load (8
# slots, max_len 2048, block 16, paged with K8): FLEET_REQUESTS requests
# of FLEET_NEW_TOKENS, greedy and seeded in turns, prompts cycling
# FLEET_PROMPT_LENS; the thread fleet's r1 killed at its
# FLEET_KILL_STREAM-th admitted stream, the subprocess replica SIGKILLed
# at its FLEET_PROC_KILL_STREAM-th (its first stream served alone); the
# routers' membership sweep every FLEET_POLL_S; the autoscaler's knobs.
FLEET_REQUESTS, FLEET_NEW_TOKENS = 16, 16
FLEET_PROMPT_LENS = (9, 100, 300, 1000, 64, 200, 600, 40)
FLEET_SAMPLED = dict(temperature=0.8, top_k=50)
FLEET_KILL_STREAM, FLEET_PROC_KILL_STREAM = 3, 3
FLEET_POLL_S = 0.05
FLEET_READY_TIMEOUT_S = 240.0
FLEET_SCALE = dict(min_replicas=1, max_replicas=2, high_watermark=4.0,
                   low_watermark=1.0, breach_up=1, breach_down=2,
                   cooldown_s=0.0)
# serve_tp: serving under a tp mesh. (b) times K3-fwd at T = TP_FLASH_T
# and K8 in the balanced and engine-mix plans at the per-rank head counts
# of TP_SIZES; (c) is a tp = 2 world of two gloo ranks sharing the card:
# TP_REQUESTS requests of TP_NEW_TOKENS (prompts cycling
# FLEET_PROMPT_LENS, greedy and seeded in turns) in both layouts, then a
# third round whose follower SIGKILLs itself TP_KILL_CALLS descriptors
# in. The world's collective timeout, TP_PLANE_S, bounds every wait of
# the step plane; TP_WORLD_S bounds the world. The tp = 2 forward's
# logits must lie within TP_DELTA_CAPS of the one-rank engine's (bf16
# sums in another order: 0.049 and 0.030 measured on an H100); a forward
# with its row-parallel sums dropped must not.
TP_SIZES = (2, 4)
TP_FLASH_T = 2048
TP_REQUESTS, TP_NEW_TOKENS = 16, 16
TP_SAMPLED = dict(temperature=0.8, top_k=50)
TP_KILL_CALLS = 20
TP_PLANE_S, TP_WORLD_S = 60.0, 240.0
TP_DELTA_CAPS = {"prefill": 0.25, "decode": 0.25}
# fleet_tp: a FleetRouter over two tp = 2 groups of subprocesses
# (spawn_replica_factory with "tp": 2), each on the device set FTP_DEVICES
# (all four ranks share the card over gloo), paged with K8: the fleet
# phase's load (FLEET_REQUESTS requests of FLEET_NEW_TOKENS, greedy and
# seeded in turns), then the same round with a follower of r0 SIGKILLed
# after r0's FTP_KILL_STREAM-th stream's first token. FTP_WORLD_S is each
# group's collective timeout; its dead leader must exit within it plus
# FTP_EXIT_MARGIN_S.
FTP_DEVICES = ("cuda:0", "cuda:0")
FTP_KILL_STREAM = 3
FTP_WORLD_S, FTP_EXIT_MARGIN_S = 60.0, 10.0
FTP_READY_TIMEOUT_S, FTP_PROBE_S = 300.0, 5.0
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


# Wall seconds of each phase, in run order (run_phase), and the start of
# the phase running now: every line a phase prints carries ``phase_s``,
# the seconds since its phase began.
PHASE_SECONDS = {}
_PHASE_T0 = [time.monotonic()]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "phase_s": round(
        time.monotonic() - _PHASE_T0[0], 3)}), flush=True)


def run_phase(name: str, fn, *args):
    """``fn(*args)`` as the phase ``name``: its wall seconds go into
    PHASE_SECONDS."""
    _PHASE_T0[0] = time.monotonic()
    out = fn(*args)
    PHASE_SECONDS[name] = time.monotonic() - _PHASE_T0[0]
    return out


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
                 bs: int = BLOCK, heads: int = LM["n_heads"]):
    """The engine's pool (one layer's, or ``layers`` layers' stacked; in
    blocks of ``bs``; ``heads`` heads, a tp rank's), random tables over
    blocks 1.. (block 0 is the trash block) and q, for ``len(positions)``
    slots."""
    nb = -(-MAX_LEN // bs)
    n_blocks = MAX_SLOTS * nb + 1
    H, S = heads, len(positions)
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
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.coord import _build as coord_build
    from horovod_tpu_torch.ops import _build
    t0 = time.monotonic()
    # The coordination plane's g++ build runs beside the nvcc builds.
    with ThreadPoolExecutor(max_workers=1) as pool:
        coord = pool.submit(lambda: (coord_build.build(),
                                     time.monotonic() - t0))
        path = _build.build()
        lib = _build.library()
        secs = time.monotonic() - t0
        coord_lib, coord_s = coord.result()
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
         coord_library=coord_lib, coord_seconds=coord_s,
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
                       for bs in PAGED_PARITY_BS]
                    + [paged_verify_parity(gen)])
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


def paged_verify_parity(gen) -> float:
    """K8 launched as the speculative verify launches it: S·W rows, each
    slot's table repeated W times, positions pos + j (past the table's
    last key for the last slots), ``plan_rows=S``. Held against the
    dense plain version (max abs error, row ulps), and each column's
    rows bitwise equal to an S-row decode launch at pos + j: the verify
    sums every row's keys in the decode step's chunks and order."""
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_decode_attention)
    S, W, H = MAX_SLOTS, KV_SPEC_K + 1, LM["n_heads"]
    base = [0, 5, 127, 128, 1000, 1500, MAX_LEN - 3, MAX_LEN - 1]
    _, kp, vp, tables, pos = paged_inputs(base, gen)
    q = torch.randn((S * W, H, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tw = tables.repeat_interleave(W, dim=0)
    offs = torch.arange(W, dtype=torch.int32, device="cuda")
    pw = (pos[:, None] + offs[None, :]).reshape(-1).contiguous()
    out = paged_decode_attention(q, kp, vp, tw, pw, plan_rows=S)
    cols = [paged_decode_attention(q.view(S, W, H, 128)[:, j].contiguous(),
                                   kp, vp, tables, (pos + j).contiguous())
            for j in range(W)]
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, kp, vp, tw, pw)
    same = [bool(torch.equal(out.view(S, W, H, 128)[:, j], c))
            for j, c in enumerate(cols)]
    errs = {"max_abs_err": _abs_err(out, ref), "row_ulps": row_ulps(out, ref)}
    emit("parity", kernel="paged_decode_attention", case="verify_rows",
         S=S, W=W, plan_rows=S, positions=pw.tolist(), **errs,
         tolerance=TOL_PAGED, row_tolerance=TOL_ATTN_ULPS,
         columns_bitwise_decode=same,
         shapes=f"H=16 d=128 {tables.shape[1]} blocks/slot bf16")
    check(all(same), f"paged_decode_attention verify_rows: columns differ "
                     f"from the decode launches: {same}")
    check(errs["max_abs_err"] <= TOL_PAGED
          and errs["row_ulps"] <= TOL_ATTN_ULPS,
          f"paged_decode_attention verify_rows: {errs}")
    del q, kp, vp, out, cols, ref
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
        max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
        paged_kernel=True, block_size=BLOCK,
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
        srv = HttpServer(generate=eng).start()
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
        PAGED_STREAMS.update(
            tokens=[r["tokens"] for r in results],
            decode_step_ms_p50=stats["latency_ms"]["execute_p50"])
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


def _kv_engine(model, **kw):
    """A serving engine on the card; paged (with K8: ``paged_kernel=True``)
    unless ``kv_layout`` says otherwise."""
    from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine
    kw.setdefault("kv_layout", "paged")
    if kw["kv_layout"] == "paged":
        kw.setdefault("paged_kernel", True)
    kw.setdefault("max_slots", MAX_SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("default_max_new_tokens", KV_NEW_TOKENS)
    kw.setdefault("max_queue", 64)
    spec = kw.pop("spec", None)
    adapters = kw.pop("adapters", None)
    return GenerationEngine(model, GenerationConfig(**kw), device="cuda",
                            spec=spec, adapters=adapters)


def _kv_serve(eng, prompts, one_by_one: bool = False, sampling=None):
    """Serve ``prompts`` (all at once, or each alone; greedy, or with
    ``sampling``: one SamplingParams for every request, or a list of each
    request's, None for greedy) with the launch counters zeroed just
    before and read just after; returns the results, the launches, the
    decode and verify steps run and the wall time."""
    from horovod_tpu_torch.ops import LAUNCHES
    per = (sampling if isinstance(sampling, list)
           else [sampling] * len(prompts))
    kws = [{} if s is None else {"sampling": s} for s in per]
    torch.cuda.synchronize()
    steps0 = eng.stats()["batches_total"]
    LAUNCHES.reset()
    t0 = time.monotonic()
    if one_by_one:
        results = [eng.submit(p, **kw).result(600)
                   for p, kw in zip(prompts, kws)]
    else:
        results = [h.result(600) for h in [
            eng.submit(p, **kw) for p, kw in zip(prompts, kws)]]
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = LAUNCHES.snapshot()
    return results, launches, eng.stats()["batches_total"] - steps0, wall_s


def _add_launches(total: dict, launches: dict) -> None:
    for k in ("flash_attention", "paged_decode_attention"):
        total[k] = total.get(k, 0) + launches.get(k, 0)


def _first_step_delta(model, prompt) -> float:
    """One prompt's prefill and first decode step through the paged
    functions (K3-fwd, K8) and the contiguous ones (K3-fwd, torch): the
    first decode step's logits' max |Δ|."""
    from horovod_tpu_torch.parallel import kv_blocks as kv
    from horovod_tpu_torch.parallel import transformer as tr
    cfg = model.cfg
    T = len(prompt)
    nb = MAX_LEN // BLOCK
    row = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        w = tr.gen_weights(model)
        pc = kv.init_paged_kv_cache(cfg, nb + 1, BLOCK, 1, device="cuda")
        cc = tr.init_kv_cache(cfg, 1, MAX_LEN, device="cuda")
        _, lp = kv.paged_prefill(w, toks, pc, 0, row, cfg)
        _, lc = tr.prefill(w, toks, cc, 0, cfg)
        nxt = lp[T - 1].argmax()[None].to(torch.int32)
        pos = torch.tensor([T], dtype=torch.int32, device="cuda")
        _, dp = kv.paged_decode_step(w, nxt, pc, pos, row[None], cfg,
                                     kernel=True)
        _, dc = tr.decode_step(w, nxt, cc, pos, cfg)
    return {"prefill_logits_bitwise": bool(torch.equal(lp[T - 1],
                                                       lc[T - 1])),
            "first_step_max_abs_diff": (dp - dc).abs().max().item()}


def _verify_vs_sequential(model, layout: str, prompts) -> dict:
    """MAX_SLOTS prompts prefilled, then KV_SPEC_K + 1 greedy decode steps
    one at a time against one verify of the same tokens from the same
    cache: whether the verify rows' logits are bitwise the decode rows'
    (max |Δ| otherwise), and for each of the step's GEMM shapes whether
    a row's bits at M = S·W equal its bits at M = S (cuBLAS's choice of
    algorithm by M)."""
    from horovod_tpu_torch.parallel import kv_blocks as kv
    from horovod_tpu_torch.parallel import transformer as tr
    cfg = model.cfg
    S, W = len(prompts), KV_SPEC_K + 1
    nb = MAX_LEN // BLOCK
    dev = torch.device("cuda")
    with torch.no_grad():
        w = tr.gen_weights(model)
        if layout == "paged":
            cache = kv.init_paged_kv_cache(cfg, S * nb + 1, BLOCK, S,
                                           device=dev)
            tables = (1 + torch.arange(S * nb, dtype=torch.int32,
                                       device=dev)).reshape(S, nb)
        else:
            cache = tr.init_kv_cache(cfg, S, MAX_LEN, device=dev)
        last = []
        for s, p in enumerate(prompts):
            toks = torch.tensor(p, dtype=torch.int32, device=dev)
            if layout == "paged":
                _, lg = kv.paged_prefill(w, toks, cache, s, tables[s], cfg)
            else:
                _, lg = tr.prefill(w, toks, cache, s, cfg)
            last.append(int(lg[-1].argmax()))
        pos0 = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device=dev)
        seq = {n: x.clone() for n, x in cache.items()}
        cur = torch.tensor(last, dtype=torch.int32, device=dev)
        pos, drafts, logs = pos0.clone(), [], []
        for _ in range(W):
            drafts.append(cur.clone())
            if layout == "paged":
                _, lg = kv.paged_decode_step(w, cur, seq, pos, tables, cfg,
                                             kernel=True)
            else:
                _, lg = tr.decode_step(w, cur, seq, pos, cfg)
            logs.append(lg)
            cur = lg.argmax(-1).to(torch.int32)
            pos = pos + 1
        drafts = torch.stack(drafts, dim=1)
        if layout == "paged":
            _, vl = kv.paged_verify_step(w, drafts, cache, pos0, tables, cfg,
                                         kernel=True)
        else:
            _, vl = tr.verify_step(w, drafts, cache, pos0, cfg)
        ref = torch.stack(logs, dim=1)
        gen = torch.Generator(device="cuda").manual_seed(7)
        layer = w["layers"][0]
        gemm = {}
        for name, mat in (("wqkv", layer["wqkv"]), ("wo", layer["wo"]),
                          ("w1", layer["w1"]), ("w2", layer["w2"])):
            x = torch.randn((S * W, mat.shape[0]), generator=gen,
                            device="cuda").to(mat.dtype)
            gemm[name] = bool(torch.equal((x @ mat)[:S], x[:S] @ mat))
        x = torch.randn((S * W, cfg.d_model), generator=gen, device="cuda")
        gemm["unembed_f32"] = bool(torch.equal(
            tr.unembed(w, x, cfg)[:S], tr.unembed(w, x[:S], cfg)))
    return {"logits_bitwise": bool(torch.equal(vl, ref)),
            "max_abs_diff": (vl - ref).abs().max().item(),
            "argmax_equal": bool(torch.equal(vl.argmax(-1),
                                             ref.argmax(-1))),
            "gemm_rows_invariant": gemm}


def phase_engine_kv(model, seed: int) -> dict:
    """The engine's KV and decoding plane on the full-width model: (a) the
    contiguous layout; (b) prefix reuse with the chunked prefill, cold
    then warm; (c) the host tier's offload and prefetch; (d) speculative
    decoding on both layouts. Returns the K3-fwd and K8 launches of the
    driven runs."""
    cfg = model.cfg
    L = cfg.n_layers
    rng = np.random.RandomState(seed + 15)
    total: dict = {}
    out: dict = {}

    # (a) contiguous: the engine phase's PROMPT_LENS prompts, greedy;
    # K3-fwd for every prefill, no K8
    rng0 = np.random.RandomState(seed)
    prompts = [rng0.randint(0, cfg.vocab, n) for n in PROMPT_LENS]
    eng = _kv_engine(model, kv_layout="contiguous",
                     default_max_new_tokens=NEW_TOKENS)
    try:
        res, launches, steps, wall_s = _kv_serve(eng, prompts)
        stats = eng.stats()
    finally:
        eng.shutdown()
    del eng
    _add_launches(total, launches)
    check(launches.get("flash_attention", 0) == L * len(prompts),
          f"contiguous: flash_attention launched {launches}, expected "
          f"{L} x {len(prompts)} prefills")
    check(launches.get("paged_decode_attention", 0) == 0,
          f"contiguous: paged_decode_attention launched {launches}")
    for r in res:
        check(r["n_tokens"] == NEW_TOKENS and all(
            0 <= t < cfg.vocab for t in r["tokens"]),
              f"contiguous request did not finish: {r}")
    CONTIGUOUS_STREAMS.update(
        tokens=[r["tokens"] for r in res],
        decode_step_ms_p50=stats["latency_ms"]["execute_p50"])
    paged = PAGED_STREAMS.get("tokens")
    agree = ([a == b["tokens"] for a, b in zip(paged, res)]
             if paged else None)
    out["contiguous"] = dict(
        launches=launches, decode_steps=steps, wall_s=wall_s,
        decode_step_ms_p50=stats["latency_ms"]["execute_p50"],
        paged_decode_step_ms_p50=PAGED_STREAMS.get("decode_step_ms_p50"),
        decode_tokens_per_s=(stats["batch_live_rows_total"]
                             / stats["execute_seconds_total"]),
        streams_equal_paged=agree,
        tokens_equal_paged=(sum(x == y for a, b in zip(paged, res)
                                for x, y in zip(a, b["tokens"]))
                            if paged else None),
        **_first_step_delta(model, prompts[2]))
    torch.cuda.empty_cache()

    # (b) prefix reuse + chunked prefill: each prompt cold on a fresh
    # engine, then twice on one warm engine (one by one, then together)
    system = rng.randint(0, cfg.vocab, KV_SYSTEM_LEN)
    kv_prompts = [np.concatenate([system, rng.randint(0, cfg.vocab, n)])
                  for n in KV_SUFFIX_LENS]
    chunked = dict(prefix_reuse=True, chunked_prefill=True,
                   chunk_blocks=KV_CHUNK_BLOCKS)
    ct = KV_CHUNK_BLOCKS * BLOCK
    cold, cold_ttft = [], []
    warm = _kv_engine(model, **chunked)
    try:
        t0 = time.monotonic()
        warm.warmup()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        for p in kv_prompts:
            eng = _kv_engine(model, **chunked)
            try:
                r, launches, _, _ = _kv_serve(eng, [p])
                check(eng.stats()["generation"]["prefix_misses_total"] == 1,
                      "chunked: a cold admission hit")
            finally:
                eng.shutdown()
            del eng
            _add_launches(total, launches)
            cold.append(r[0]["tokens"])
            cold_ttft.append(r[0]["ttft_ms"])
        g0 = warm.stats()["generation"]
        first, launches, _, _ = _kv_serve(warm, kv_prompts[:1])
        _add_launches(total, launches)
        g1 = warm.stats()["generation"]
        hit, launches, steps, _ = _kv_serve(warm, kv_prompts,
                                            one_by_one=True)
        _add_launches(total, launches)
        g2 = warm.stats()["generation"]
        together, launches2, steps2, _ = _kv_serve(warm, kv_prompts)
        _add_launches(total, launches2)
        g3 = warm.stats()["generation"]
        blocks = warm.stats()["blocks"]
    finally:
        warm.shutdown()
    del warm
    check(first[0]["tokens"] == cold[0],
          "chunked: the warm engine's cold admission differs from a fresh "
          "engine's")
    hit_equal = [h["tokens"] == c for h, c in zip(hit, cold)]
    together_equal = [h["tokens"] == c for h, c in zip(together, cold)]
    # Expected hits: the prompt registered before it (the first: its own
    # full blocks; the others: the system prompt's), capped to whole
    # chunks short of the prompt's last token.
    want_skipped = 0
    for i, p in enumerate(kv_prompts):
        reg = len(p) // BLOCK if i == 0 else KV_SYSTEM_LEN // BLOCK
        cap = ((len(p) - 1) // ct) * KV_CHUNK_BLOCKS
        n_hit = min(reg, cap)
        want_skipped += (n_hit - n_hit % KV_CHUNK_BLOCKS) * BLOCK // ct
    got = {k: g2[k] - g1[k] for k in ("prefix_hits_total",
                                      "prefix_misses_total",
                                      "prefill_chunks_skipped_total")}
    check(g1["prefix_misses_total"] - g0["prefix_misses_total"] == 1,
          "chunked: the warm engine's first admission was not a miss")
    check(got == {"prefix_hits_total": len(kv_prompts),
                  "prefix_misses_total": 0,
                  "prefill_chunks_skipped_total": want_skipped},
          f"chunked: stats {got}, expected {len(kv_prompts)} hits and "
          f"{want_skipped} skipped chunks")
    check(g3["prefix_hits_total"] - g2["prefix_hits_total"]
          == len(kv_prompts), "chunked: the batched round missed")
    check(all(hit_equal) and all(together_equal),
          f"chunked: hit streams differ from the cold ones: {hit_equal}, "
          f"{together_equal}")
    check(blocks["used"] == blocks["registered_prefix_blocks"],
          f"chunked: blocks still held by streams after the drain: "
          f"{blocks}")
    check(launches.get("flash_attention", 0) == 0,
          "chunked: a prefill took the flash kernel")
    check(launches2.get("paged_decode_attention", 0) == L * steps2,
          f"chunked: K8 launched {launches2}, expected {L} x {steps2}")
    hit_ttft = [h["ttft_ms"] for h in hit]
    out["chunked"] = dict(
        system_len=KV_SYSTEM_LEN, suffix_lens=list(KV_SUFFIX_LENS),
        chunk_tokens=ct, warmup_s=warm_s,
        ttft_cold_ms=cold_ttft, ttft_hit_ms=hit_ttft,
        ttft_cold_p50_ms=float(np.median(cold_ttft)),
        ttft_hit_p50_ms=float(np.median(hit_ttft)),
        stats_delta=got, hit_streams_equal_cold=hit_equal,
        batched_streams_equal_cold=together_equal,
        blocks_after_drain=blocks)
    torch.cuda.empty_cache()

    # (c) the host tier: a pressure prompt as long as the pool offloads
    # the whole registered prefix; the next admission of the prompt waits
    # for its prefetch
    p = kv_prompts[2]
    pressure = rng.randint(0, cfg.vocab, KV_PRESSURE_LEN)
    eng = _kv_engine(model, max_slots=1, n_blocks=KV_HOST_POOL + 1,
                     host_blocks=KV_HOST_POOL, host_admission="wait",
                     **chunked)
    try:
        r_cold, launches, _, _ = _kv_serve(eng, [p])
        _add_launches(total, launches)
        r_res, launches, _, _ = _kv_serve(eng, [p])
        _add_launches(total, launches)
        r_pres, launches, _, _ = _kv_serve(eng, [pressure])
        _add_launches(total, launches)
        g0 = eng.stats()["generation"]
        keys = [eng._blocks._key(p, j, b"\x00")
                for j in range(len(p) // BLOCK)]
        staged = {k: eng._blocks._host[k] for k in keys
                  if k in eng._blocks._host}
        r_back, launches, _, _ = _kv_serve(eng, [p])
        _add_launches(total, launches)
        g1 = eng.stats()["generation"]
        landed = {k: eng._blocks._registry[k] for k in staged
                  if k in eng._blocks._registry}
        bytes_equal = all(torch.equal(eng._cache[n][:, blk].cpu(),
                                      staged[k][n])
                          for k, blk in landed.items() for n in ("k", "v"))
        blocks = eng.stats()["blocks"]
        # the copies the tier makes, one block at a time, timed alone
        blks = list(landed.values())
        torch.cuda.synchronize()
        t0 = time.monotonic()
        copies = [{n: eng._cache[n][:, b].to("cpu", copy=True)
                   for n in ("k", "v")} for b in blks]
        off_ms = (time.monotonic() - t0) * 1e3 / max(1, len(blks))
        t0 = time.monotonic()
        for b, c in zip(blks, copies):
            for n in ("k", "v"):
                eng._cache[n][:, b] = c[n].to("cuda")
        torch.cuda.synchronize()
        pre_ms = (time.monotonic() - t0) * 1e3 / max(1, len(blks))
    finally:
        eng.shutdown()
    del eng
    check(g0["kv_offload_blocks_total"] >= len(keys) and len(staged)
          == len(keys), f"host tier: {len(staged)} of the prompt's "
                        f"{len(keys)} blocks offloaded")
    check(g1["kv_prefetch_blocks_total"] - g0["kv_prefetch_blocks_total"]
          >= len(keys) and len(landed) == len(keys),
          f"host tier: {len(landed)} of {len(keys)} blocks fetched back")
    check(g1["prefix_hits_total"] - g0["prefix_hits_total"] == 1,
          "host tier: the fetched-back admission missed")
    check(bytes_equal, "host tier: fetched blocks differ from the "
                       "offloaded bytes")
    check(r_back[0]["tokens"] == r_res[0]["tokens"] == r_cold[0]["tokens"],
          "host tier: the fetched-back stream differs from the resident "
          "one's")
    out["host_tier"] = dict(
        prompt_len=len(p), pressure_len=KV_PRESSURE_LEN,
        pool_blocks=KV_HOST_POOL, offloaded_blocks=g0[
            "kv_offload_blocks_total"],
        prefetched_blocks=g1["kv_prefetch_blocks_total"],
        prefetch_wait_ms_p50=g1["kv_prefetch_ms_p50"],
        block_bytes=2 * L * BLOCK * cfg.d_model * 2,
        offload_ms_per_block=off_ms, prefetch_ms_per_block=pre_ms,
        ttft_fetched_back_ms=r_back[0]["ttft_ms"],
        ttft_resident_ms=r_res[0]["ttft_ms"], blocks_after=blocks)
    torch.cuda.empty_cache()

    # (d) speculative decoding on repetitive prompts, both layouts
    from horovod_tpu_torch.serve.spec import SpecConfig
    spec_prompts = [np.tile(rng.randint(0, cfg.vocab, KV_SPEC_PERIOD),
                            KV_SPEC_REPEATS) for _ in range(MAX_SLOTS)]
    runs, agree = {}, {}
    for layout in ("paged", "contiguous"):
        for name, spec in (("off", None),
                           ("on", SpecConfig(k=KV_SPEC_K))):
            eng = _kv_engine(model, kv_layout=layout, spec=spec,
                             default_max_new_tokens=KV_SPEC_NEW)
            try:
                eng.warmup()
                res, launches, steps, wall_s = _kv_serve(eng, spec_prompts)
                stats = eng.stats()
            finally:
                eng.shutdown()
            del eng
            _add_launches(total, launches)
            k8 = launches.get("paged_decode_attention", 0)
            check(k8 == (L * steps if layout == "paged" else 0),
                  f"spec {layout}/{name}: K8 launched {k8}, expected "
                  f"{L} x {steps} steps")
            for r in res:
                check(r["n_tokens"] == KV_SPEC_NEW and all(
                    0 <= t < cfg.vocab for t in r["tokens"]),
                      f"spec {layout}/{name}: request did not finish: {r}")
            tokens = sum(r["n_tokens"] - 1 for r in res)
            runs[(layout, name)] = dict(
                launches=launches, steps=steps, wall_s=wall_s,
                decode_tokens_per_s=tokens / stats["execute_seconds_total"],
                step_ms_p50=stats["latency_ms"]["execute_p50"],
                spec=stats["spec"] if spec is not None else None,
                tokens=[r["tokens"] for r in res])
            torch.cuda.empty_cache()
        off, on = runs[(layout, "off")], runs[(layout, "on")]
        agree[layout] = dict(
            streams_equal=[a == b for a, b in zip(off["tokens"],
                                                  on["tokens"])],
            tokens_equal=sum(x == y for a, b in zip(off["tokens"],
                                                    on["tokens"])
                             for x, y in zip(a, b)),
            tokens_total=sum(len(a) for a in off["tokens"]),
            verify_vs_sequential=_verify_vs_sequential(
                model, layout, spec_prompts))
        torch.cuda.empty_cache()
    out["spec"] = {
        f"{layout}_{name}": {k: v for k, v in r.items() if k != "tokens"}
        for (layout, name), r in runs.items()}
    # Greedy spec-on streams equal spec-off ones only where every GEMM of
    # the verify (M = S·W rows) gives a row the bits it has at M = S: on
    # the card cuBLAS picks another algorithm for some shapes
    # (gemm_rows_invariant), so the agreement is reported, not checked.
    out["spec"]["agreement"] = agree
    out["spec"]["k"] = KV_SPEC_K
    out["launches"] = total
    emit("engine_kv", **out)
    return total


def _lora_round(eng, prompts, tenants, sampling=None) -> tuple:
    """Serve ``prompts`` (``tenants[i]`` the adapter of prompt ``i``, None
    for base) all at once with the launch counters zeroed just before
    and read just after; returns the results, the launches and the
    decode steps run."""
    from horovod_tpu_torch.ops import LAUNCHES
    torch.cuda.synchronize()
    steps0 = eng.stats()["batches_total"]
    LAUNCHES.reset()
    hs = [eng.submit(p, adapter=t, sampling=sampling)
          for p, t in zip(prompts, tenants)]
    res = [h.result(600) for h in hs]
    torch.cuda.synchronize()
    return res, LAUNCHES.snapshot(), eng.stats()["batches_total"] - steps0


def _probe_round(model, reg, prompt, names) -> list:
    """One prompt under the base and each tenant in one round."""
    eng = _kv_engine(model, adapters=reg,
                     default_max_new_tokens=LORA_NEW_TOKENS)
    try:
        return _lora_round(eng, [prompt] * (len(names) + 1),
                           [None] + list(names))[0]
    finally:
        eng.shutdown()


def _preempt_drill(model, reg, spec=None) -> dict:
    """One decode slot, tenant t0 in priority class 1: an unpreempted run
    of a long base stream, then the same stream evicted by a t0 admission
    after its first token. Returns whether the evicted stream ended
    equal to its unpreempted run, the counters, and the error the replay
    raised, if any (reported, never hidden)."""
    from horovod_tpu_torch.serve import SamplingParams
    rng = np.random.RandomState(37)
    prompt = np.tile(rng.randint(0, model.cfg.vocab, 37),
                     LORA_PREEMPT_LEN // 37)
    other = rng.randint(0, model.cfg.vocab, 40)
    out = {}
    reg.set_priority("t0", 1)
    try:
        for name, sampling in (("greedy", None), ("seeded", SamplingParams(
                temperature=0.9, top_k=50, seed=5))):
            eng = _kv_engine(model, max_slots=1, adapters=reg, spec=spec,
                             default_max_new_tokens=LORA_PREEMPT_NEW)
            try:
                ref = eng.generate(prompt, sampling=sampling, timeout=600)
                h = eng.submit(prompt, sampling=sampling)
                kind, _ = h.next_event(timeout=600)
                check(kind == "token", f"preempt drill: {kind} first")
                hp = eng.submit(other, adapter="t0", max_new_tokens=8)
                got, err = None, None
                try:
                    got = h.result(600)
                except RuntimeError as e:   # a diverged replay, reported
                    err = repr(e)[:300]
                hp.result(600)
                gen = eng.stats()["generation"]
            finally:
                eng.shutdown()
            out[name] = dict(
                equal=(got is not None and got["tokens"] == ref["tokens"]),
                error=err, preemptions=gen["preemptions_total"],
                resumed=gen["preempt_resumed_total"],
                exhausted=gen["preempt_exhausted_total"],
                spec_accept_rate=(got or {}).get("spec_accept_rate"))
    finally:
        reg.set_priority("t0", None)
    return out


def _lora_reference(model, reg, tenant: str, other: str, seed: int) -> dict:
    """One tenant's prefill and LORA_REF_STEPS paged decode steps through
    the port's functions with ``adapters=`` on the card (K3-fwd, K8 and
    the delta's gather and products) and on the CPU (the plain versions)
    from the same weights and table, beside three CPU controls that a
    wrong delta on the card would reproduce: no delta (the base), another
    tenant's row, and the delta unscaled (``alpha = rank``)."""
    from horovod_tpu_torch.parallel.kv_blocks import (blocks_for,
                                                      init_paged_kv_cache,
                                                      paged_decode_step,
                                                      paged_prefill)
    from horovod_tpu_torch.parallel.lora import LoraConfig, _tree_map
    from horovod_tpu_torch.parallel.transformer import gen_weights
    cfg, lora = model.cfg, reg.lora
    T, steps = LORA_REF_T, LORA_REF_STEPS
    rng = np.random.RandomState(seed + 20)
    prompt = rng.randint(0, cfg.vocab, T).astype(np.int32)
    feed = rng.randint(0, cfg.vocab, steps).astype(np.int32)
    nb = blocks_for(T + steps, BLOCK)
    blocks = np.arange(1, nb + 1, dtype=np.int32)

    def run(w, table, idx, lcfg, device):
        with torch.no_grad():
            cache = init_paged_kv_cache(cfg, nb + 1, BLOCK, 1, device=device)
            t = lambda a: torch.tensor(a, device=device)  # noqa: E731
            kw = dict(adapters=table, lora=lcfg)
            _, lg = paged_prefill(w, t(prompt), cache, 0, t(blocks), cfg,
                                  adapter_idx=idx, **kw)
            out = [lg[T - 1].float().cpu()]
            for i in range(steps):
                _, lg = paged_decode_step(
                    w, t(feed[i:i + 1]), cache,
                    t(np.array([T + i], np.int32)), t(blocks[None]), cfg,
                    kernel=True, adapter_idx=t(np.array([idx], np.int32)),
                    **kw)
                out.append(lg[0].float().cpu())
        return torch.stack(out)

    row, other_row = reg.index_of(tenant), reg.index_of(other)
    table = reg.table()
    with torch.no_grad():
        w = gen_weights(model)
    t0 = time.monotonic()
    card = run(w, table, row, lora, "cuda")
    card_s = time.monotonic() - t0
    del w
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        w = gen_weights(cpu_model)
    del cpu_model
    ctable = _tree_map(lambda x: x.cpu(), table)
    t0 = time.monotonic()
    cpu = run(w, ctable, row, lora, "cpu")
    cpu_s = time.monotonic() - t0
    unscaled = LoraConfig(rank=lora.rank, alpha=float(lora.rank),
                          targets=lora.targets)
    controls = {
        "base": run(w, ctable, -1, lora, "cpu"),
        "other_row": run(w, ctable, other_row, lora, "cpu"),
        "unscaled": run(w, ctable, row, unscaled, "cpu")}
    del w, ctable
    diff = (card - cpu).abs().max().item()
    dist = {k: (v - cpu).abs().max().item() for k, v in controls.items()}
    check(bool(torch.isfinite(card).all()),
          "engine_lora reference: card logits not finite")
    check(diff <= TOL_E2E, f"engine_lora reference: card vs CPU logits of "
                           f"tenant {tenant} differ by {diff} > {TOL_E2E}")
    check(2 * diff < min(dist.values()),
          f"engine_lora reference: the card's {diff} from the CPU's logits "
          f"does not separate from the wrong-delta controls {dist}")
    return dict(tenant=tenant, positions=T + steps, max_abs_diff=diff,
                bound=TOL_E2E, control_max_abs_diff=dist,
                top1_card=card.argmax(-1).tolist(),
                top1_cpu=cpu.argmax(-1).tolist(), card_s=card_s,
                cpu_s=cpu_s)


def phase_engine_lora(model, seed: int) -> dict:
    """Multi-tenant LoRA serving on the full-width model (see the module
    docstring, 6a). Returns the K3-fwd and K8 launches of the driven
    rounds."""
    import shutil
    import tempfile
    from horovod_tpu_torch.parallel.checkpoint import (restore_adapter,
                                                       save_adapter)
    from horovod_tpu_torch.parallel.lora import (LoraConfig, adapter_bytes,
                                                 init_adapter)
    from horovod_tpu_torch.serve import AdapterRegistry, SamplingParams
    from horovod_tpu_torch.serve.spec import SpecConfig
    cfg = model.cfg
    L = cfg.n_layers
    lora = LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA)
    reg = AdapterRegistry(cfg, lora, capacity=LORA_CAPACITY, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    trees = {}
    for i in range(LORA_TENANTS):
        trees[f"t{i}"] = init_adapter(gen, cfg, lora, b_scale=LORA_B_SCALE,
                                      device="cuda")
        reg.load(f"t{i}", trees[f"t{i}"])
    rng = np.random.RandomState(seed + 16)
    prompts = [rng.randint(0, cfg.vocab, n) for n in LORA_PROMPT_LENS]
    names = [f"t{i}" for i in range(LORA_TENANTS)]
    mixed_tenants = [None] + names + [None] + names
    seeded = SamplingParams(temperature=0.9, top_k=50, seed=3)
    total: dict = {}
    rounds = {}
    mixed_res = {}
    for rname, tenants in (("base_only", [None] * len(prompts)),
                           ("mixed", mixed_tenants)):
        eng = _kv_engine(model, adapters=reg,
                         default_max_new_tokens=LORA_NEW_TOKENS)
        try:
            eng.warmup()
            res, launches, steps = _lora_round(eng, prompts, tenants)
            stats = eng.stats()
            if rname == "mixed":
                seeded_res, _, _ = _lora_round(eng, prompts, tenants,
                                               seeded)
                # the mixed round again under torch.profiler: the
                # device's busy share and what takes its time
                def serve_mixed():
                    for h in [eng.submit(p, adapter=t)
                              for p, t in zip(prompts, tenants)]:
                        h.result(600)
                wall_s, rows = device_profile(serve_mixed)
                profiled = {"wall_s": wall_s, **busy_shares(
                    rows, wall_s, {"k3_fwd": "flash_fwd_wgmma_kernel",
                                   "k8": "paged_decode"}),
                    "top": [{"name": k[:80], "ms": us / 1e3, "count": n}
                            for us, k, n in rows[:8]]}
                alone = {s: {i: eng.submit(prompts[i], adapter=t,
                                           sampling=smp).result(600)["tokens"]
                             for i, t in enumerate(tenants) if t is not None}
                         for s, smp in (("greedy", None),
                                        ("seeded", seeded))}
        finally:
            eng.shutdown()
        del eng
        _add_launches(total, launches)
        check(launches.get("flash_attention", 0) == L * len(prompts),
              f"engine_lora {rname}: K3-fwd launched {launches}, expected "
              f"{L} x {len(prompts)} prefills")
        check(launches.get("paged_decode_attention", 0) == L * steps,
              f"engine_lora {rname}: K8 launched {launches}, expected "
              f"{L} x {steps} decode steps")
        for r in res:
            check(r["n_tokens"] == LORA_NEW_TOKENS and all(
                0 <= t < cfg.vocab for t in r["tokens"]),
                  f"engine_lora {rname}: request did not finish: {r}")
        ttft = [r["ttft_ms"] for r in res]
        rounds[rname] = dict(
            decode_step_ms_p50=stats["latency_ms"]["execute_p50"],
            decode_step_ms_p99=stats["latency_ms"]["execute_p99"],
            ttft_ms_p50=float(np.median(ttft)), decode_steps=steps,
            launches=launches, decode_tokens_per_s=(
                stats["batch_live_rows_total"]
                / stats["execute_seconds_total"]))
        mixed_res[rname] = res
        torch.cuda.empty_cache()
    res = mixed_res["mixed"]
    # each tenant alone bitwise the same tenant mixed, greedy and seeded
    alone_equal = {s: [alone[s][i] == r[i]["tokens"] for i in alone[s]]
                   for s, r in (("greedy", res), ("seeded", seeded_res))}
    check(all(v for d in alone_equal.values() for v in d),
          f"engine_lora: a tenant alone differs from it mixed: "
          f"{alone_equal}")
    base_streams = [rr["tokens"] for t, rr in zip(mixed_tenants, res)
                    if t is None]
    # the mixed round's base streams bitwise a plain engine's
    plain = _kv_engine(model, default_max_new_tokens=LORA_NEW_TOKENS)
    try:
        base_idx = [i for i, t in enumerate(mixed_tenants) if t is None]
        plain_res, _, _ = _lora_round(plain, [prompts[i] for i in base_idx],
                                      [None] * len(base_idx))
    finally:
        plain.shutdown()
    del plain
    base_equal = [a == b["tokens"] for a, b in zip(base_streams, plain_res)]
    check(all(base_equal), f"engine_lora: base streams through the adapter "
                           f"engine differ from a plain engine's: "
                           f"{base_equal}")
    # the same prompt under the base and each tenant: all streams differ
    probe = {t: rr["tokens"] for t, rr in zip(
        [None] + names, _probe_round(model, reg, prompts[0], names))}
    distinct = len({tuple(v) for v in probe.values()})
    check(distinct == LORA_TENANTS + 1,
          f"engine_lora: tenants' streams on one prompt are not distinct: "
          f"{probe}")
    # one tenant against the CPU's plain versions from the same table
    reference = _lora_reference(model, reg, names[0], names[1], seed)
    torch.cuda.empty_cache()
    # preempt-by-evict: spec off (the contract, checked), spec on
    # (reported)
    preempt = {"spec_off": _preempt_drill(model, reg)}
    check(all(v["equal"] and v["preemptions"] >= 1 and v["resumed"] >= 1
              for v in preempt["spec_off"].values()),
          f"engine_lora: the evicted stream differs from its unpreempted "
          f"run: {preempt['spec_off']}")
    preempt["spec_on"] = _preempt_drill(model, reg,
                                        spec=SpecConfig(k=KV_SPEC_K))
    # an adapter saved, restored, reloaded: the same tokens
    tmp = tempfile.mkdtemp()
    try:
        t0 = time.monotonic()
        save_adapter(tmp, "t1", trees["t1"])
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        restored = restore_adapter(tmp, "t1")
        restore_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reg.evict("t1")
    t0 = time.monotonic()
    reg.load("t1", restored)
    load_ms = (time.monotonic() - t0) * 1e3
    eng = _kv_engine(model, adapters=reg,
                     default_max_new_tokens=LORA_NEW_TOKENS)
    try:
        i1 = mixed_tenants.index("t1")
        again = eng.generate(prompts[i1], adapter="t1", timeout=600)
    finally:
        eng.shutdown()
    del eng
    check(again["tokens"] == res[i1]["tokens"],
          "engine_lora: the restored adapter generates other tokens")
    out = dict(
        rank=LORA_RANK, alpha=LORA_ALPHA, targets=list(lora.targets),
        capacity=LORA_CAPACITY, resident=LORA_TENANTS,
        adapter_bytes=adapter_bytes(cfg, lora),
        table_bytes=adapter_bytes(cfg, lora) * LORA_CAPACITY,
        b_scale=LORA_B_SCALE, slots=MAX_SLOTS, new_tokens=LORA_NEW_TOKENS,
        prompt_lens=list(LORA_PROMPT_LENS),
        round_tenants=[t or "base" for t in mixed_tenants],
        rounds=rounds,
        decode_step_ratio_mixed_over_base=(
            rounds["mixed"]["decode_step_ms_p50"]
            / rounds["base_only"]["decode_step_ms_p50"]),
        mixed_profile=profiled,
        distinct_streams=distinct, alone_equal_mixed=alone_equal,
        base_equal_plain=base_equal, reference=reference, preempt=preempt,
        checkpoint=dict(save_s=save_s, restore_s=restore_s,
                        load_ms=load_ms, tokens_equal=True),
        launches=total, gpu=smi_line())
    emit("engine_lora", **out)
    torch.cuda.empty_cache()
    return total


def _route_f32_logits(seed: int) -> dict:
    """An f32 model at the bench widths (ROUTE_LAYERS layers): a prompt's
    prefill (the transformer routes it to the plain version) and
    ROUTE_STEPS paged decode steps (the gather, the engine's route for a
    model K8 does not take), then one training forward and backward over
    the prompt (the packed flash route gives way to the dense attention),
    on the card and on the CPU from the same weights; the kernels take no
    f32 input, so none may launch."""
    from horovod_tpu_torch.ops import LAUNCHES, paged_attention_supported
    from horovod_tpu_torch.parallel.kv_blocks import (blocks_for,
                                                      init_paged_kv_cache,
                                                      paged_decode_step,
                                                      paged_prefill)
    from horovod_tpu_torch.parallel.transformer import (Transformer,
                                                        TransformerConfig,
                                                        dense_nll, forward,
                                                        gen_weights)
    cfg = TransformerConfig(**dict(LM, n_layers=ROUTE_LAYERS),
                            dtype=torch.float32, unembed_dtype=torch.float32)
    model = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + 17), device="cuda")
    rng = np.random.RandomState(seed + 17)
    prompt = rng.randint(0, cfg.vocab, ROUTE_T).astype(np.int32)
    feed = rng.randint(0, cfg.vocab, ROUTE_STEPS).astype(np.int32)
    nb = blocks_for(ROUTE_T + ROUTE_STEPS, BLOCK)
    row = np.arange(1, nb + 1, dtype=np.int32)

    def run(m, device):
        with torch.no_grad():
            w = gen_weights(m)
            cache = init_paged_kv_cache(cfg, nb + 1, BLOCK, 1, device=device)
            t = lambda a: torch.tensor(a, device=device)  # noqa: E731
            _, lg = paged_prefill(w, t(prompt), cache, 0, t(row), cfg)
            out = [lg[ROUTE_T - 1].cpu()]
            for i in range(ROUTE_STEPS):
                _, lg = paged_decode_step(
                    w, t(feed[i:i + 1]), cache,
                    t(np.array([ROUTE_T + i], np.int32)), t(row[None]), cfg,
                    kernel=paged_attention_supported(
                        cfg.d_head, BLOCK, cfg.dtype, device))
                out.append(lg[0].cpu())
        return torch.stack(out)

    def train(m, device):
        tok = torch.tensor(prompt[None], device=device)
        loss = dense_nll(forward(m, tok), torch.roll(tok, -1, 1)).mean()
        loss.backward()
        norm = torch.sqrt(sum(p.grad.double().pow(2).sum()
                              for p in m.parameters()))
        return loss.item(), norm.item()

    cpu_model = copy.deepcopy(model).to("cpu")
    torch.cuda.synchronize()
    LAUNCHES.reset()
    card = run(model, "cuda")
    card_train = train(model, "cuda")
    torch.cuda.synchronize()
    launches = LAUNCHES.snapshot()
    cpu = run(cpu_model, "cpu")
    cpu_train = train(cpu_model, "cpu")
    del model, cpu_model
    loss_rel = abs(card_train[0] - cpu_train[0]) / abs(cpu_train[0])
    norm_rel = abs(card_train[1] - cpu_train[1]) / cpu_train[1]
    check(max(loss_rel, norm_rel) <= TOL_F32,
          f"routing f32: card vs CPU training loss / grad norm differ by "
          f"{loss_rel} / {norm_rel} relative > {TOL_F32}")
    diff = (card - cpu).abs().max().item()
    check(bool(torch.isfinite(card).all()), "routing f32: logits not finite")
    check(not launches, f"routing f32: a kernel launched on f32: {launches}")
    check(diff <= TOL_F32, f"routing f32: card vs CPU logits differ by "
                           f"{diff} > {TOL_F32}")
    return dict(layers=ROUTE_LAYERS, prompt_len=ROUTE_T, steps=ROUTE_STEPS,
                max_abs_diff=diff, bound=TOL_F32,
                logits_absmax=card.abs().max().item(),
                top1_equal=card.argmax(-1).tolist() == cpu.argmax(-1)
                .tolist(), train_loss_card_cpu=[card_train[0], cpu_train[0]],
                train_loss_rel_diff=loss_rel,
                grad_norm_card_cpu=[card_train[1], cpu_train[1]],
                grad_norm_rel_diff=norm_rel, launches=launches)


def _route_head64(seed: int) -> dict:
    """A bf16 model with d_head 64 (bench widths, ROUTE_HEADS64 heads,
    ROUTE_LAYERS layers) served by a paged engine with
    ``paged_kernel=True``: the kernels take d_head 128 only, so the
    transformer and the engine route every prefill and decode step to
    the plain versions."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(**dict(LM, n_layers=ROUTE_LAYERS,
                                   n_heads=ROUTE_HEADS64),
                            dtype=torch.bfloat16, unembed_dtype=torch.float32)
    model = Transformer(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + 18), device="cuda")
    rng = np.random.RandomState(seed + 18)
    prompts = [rng.randint(0, cfg.vocab, n) for n in ROUTE_H64_PROMPTS]
    eng = _kv_engine(model, default_max_new_tokens=ROUTE_H64_NEW)
    try:
        eng.warmup()
        torch.cuda.synchronize()
        LAUNCHES.reset()
        res = [h.result(600) for h in [eng.submit(p) for p in prompts]]
        torch.cuda.synchronize()
        launches = LAUNCHES.snapshot()
        step_ms = eng.stats()["latency_ms"]["execute_p50"]
        kernels = eng.stats()["kernels"]
    finally:
        eng.shutdown()
    del eng, model
    check(not any(kernels.values()),
          f"routing d_head 64: the engine chose a kernel: {kernels}")
    for r in res:
        check(r["n_tokens"] == ROUTE_H64_NEW and all(
            0 <= t < cfg.vocab for t in r["tokens"]),
              f"routing d_head 64: request did not finish: {r}")
    check(not launches, f"routing d_head 64: a kernel launched: {launches}")
    return dict(d_head=cfg.d_head, heads=cfg.n_heads, layers=ROUTE_LAYERS,
                requests=len(res), decode_step_ms_p50=step_ms,
                kernels=kernels, launches=launches)


def _route_resnet_f32(seed: int) -> dict:
    """One f32 ResNet-50 step with the fused backend (K1/K2 take bf16
    only: their plain versions run) against the f32 stock (``"xla"``)
    step from the same weights and batch."""
    from horovod_tpu_torch.models import resnet50
    from horovod_tpu_torch.ops import LAUNCHES
    x, y = synthetic_batch(ROUTE_RN_BATCH, seed + 19)
    out = {}
    for backend in ("fused", "xla"):
        model = resnet50(RN_CLASSES, conv_backend=backend, device="cuda",
                         dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        LAUNCHES.reset()
        loss, _ = _one_step(model, x, y)
        torch.cuda.synchronize()
        out[backend] = dict(loss=loss, launches=LAUNCHES.snapshot())
        del model
        torch.cuda.empty_cache()
    rel = abs(out["fused"]["loss"] - out["xla"]["loss"]) / abs(
        out["xla"]["loss"])
    check(np.isfinite(out["fused"]["loss"]), "routing ResNet f32: loss")
    check(not out["fused"]["launches"],
          f"routing ResNet f32: a kernel launched: {out['fused']}")
    check(rel <= TOL_RN_F32, f"routing ResNet f32: fused loss off the stock "
                             f"loss by {rel} > {TOL_RN_F32}")
    return dict(batch=ROUTE_RN_BATCH, loss_rel_diff=rel, bound=TOL_RN_F32,
                **out)


def phase_routing(model, seed: int):
    """F1 and F2 on the card (see the module docstring, 6b)."""
    from horovod_tpu_torch.ops import LAUNCHES
    cfg = model.cfg
    # F2: the default paged engine (the gather) against engine_kv (a)'s
    # contiguous streams, the same prompts and greedy sampling
    rng0 = np.random.RandomState(seed)
    prompts = [rng0.randint(0, cfg.vocab, n) for n in PROMPT_LENS]
    eng = _kv_engine(model, paged_kernel=False,
                     default_max_new_tokens=NEW_TOKENS)
    try:
        res, launches, steps, _ = _kv_serve(eng, prompts)
        step_ms = eng.stats()["latency_ms"]["execute_p50"]
    finally:
        eng.shutdown()
    del eng
    torch.cuda.empty_cache()
    contiguous = CONTIGUOUS_STREAMS.get("tokens")
    check(contiguous is not None, "routing: engine_kv (a) did not run")
    equal = [a["tokens"] == b for a, b in zip(res, contiguous)]
    check(all(equal), f"routing: the default paged engine's streams differ "
                      f"from the contiguous engine's: {equal}")
    check(launches.get("paged_decode_attention", 0) == 0,
          f"routing: K8 launched without paged_kernel: {launches}")
    check(launches.get("flash_attention", 0) == cfg.n_layers * len(prompts),
          f"routing: K3-fwd launched {launches}")
    f2 = dict(streams_equal_contiguous=equal, decode_steps=steps,
              decode_step_ms_p50=step_ms, launches=launches)
    LAUNCHES.reset()
    out = dict(f2_default_paged=f2, f1_f32=_route_f32_logits(seed),
               f1_head64=_route_head64(seed),
               f1_resnet_f32=_route_resnet_f32(seed), gpu=smi_line())
    emit("routing", **out)
    torch.cuda.empty_cache()


def _resident_bytes(build):
    """``build()``'s result and the device bytes it holds: the change of
    ``torch.cuda.memory_allocated()`` across it (allocations, not the
    caching allocator's reserve)."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = build()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def phase_engine_int8(model, seed: int):
    """int8 serving weights at full width: the weights quantized on the
    host (``quantize_tree`` of ``params_to_numpy``: the card never holds
    an f32 copy of the int8 model), then (a) the bytes each engine's
    weights hold on the card, int8 against the plain model of the
    dequantized f32 weights, across the model's build and
    ``gen_weights``; (b) both engines' greedy and seeded streams of the
    engine phase's 8 prompts, expected bitwise equal (the same f32
    products cast to bf16 at the same point); (c) TTFT and decode step
    p50; (d) K3-fwd and K8 launched n_layers times a prefill and a step
    on the int8 path; (e) the int8 path's logits on the card against the
    CPU's, e2e's prompt and steps. Returns the int8 engine (kept for
    serve_single) and its rounds' launches."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.ops.quant import dequantize_tree, quantize_tree
    from horovod_tpu_torch.parallel.transformer import gen_weights
    from horovod_tpu_torch.serve import SamplingParams
    cfg = model.cfg
    t0 = time.monotonic()
    qtree = quantize_tree(convert.params_to_numpy(model))
    quantize_s = time.monotonic() - t0

    def build(tree):
        def run():
            with torch.no_grad():
                m = convert.params_from_jax(tree, cfg)
                return m, gen_weights(m)
        return run
    (m8, w8), int8_bytes = _resident_bytes(build(qtree))
    (m32, w32), plain_bytes = _resident_bytes(build(dequantize_tree(qtree)))
    del w8, w32
    check(m8.quantized and not m32.quantized, "int8 model not int8")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab, n) for n in PROMPT_LENS]
    prompts.append(rng.randint(0, cfg.vocab, HTTP_PROMPT_LEN))
    rounds, stats, launches = {}, {}, {}
    engines = {"plain": _kv_engine(m32, default_max_new_tokens=NEW_TOKENS)}
    del m32
    try:
        engines["int8"] = _kv_engine(m8, default_max_new_tokens=NEW_TOKENS)
        for name, eng in engines.items():
            eng.warmup()
            for mode, sp in (("greedy", None),
                             ("seeded", SamplingParams(**INT8_SAMPLED))):
                res, got, steps, wall_s = _kv_serve(eng, prompts,
                                                    sampling=sp)
                want_launches(got, {
                    "flash_attention": cfg.n_layers * len(prompts),
                    "paged_decode_attention": cfg.n_layers * steps},
                    f"engine_int8 {name} {mode}")
                check(steps > 0, f"engine_int8 {name} {mode}: no step")
                rounds[name, mode] = dict(
                    tokens=[r["tokens"] for r in res],
                    ttft_ms=[r["ttft_ms"] for r in res], wall_s=wall_s,
                    decode_steps=steps)
                if name == "int8":
                    _add_launches(launches, got)
            stats[name] = eng.stats()
            if name == "plain":      # its 2.7 GB go before the int8 rounds
                eng.shutdown()
                engines[name] = None
                gc.collect()
                torch.cuda.empty_cache()
        profiled = profile_round(engines["int8"], prompts)
        t0 = time.monotonic()
        card = _e2e_logits(m8, "cuda", seed)
        card_s = time.monotonic() - t0
        cpu_model = convert.params_from_jax(qtree, cfg, device="cpu")
        t0 = time.monotonic()
        cpu = _e2e_logits(cpu_model, "cpu", seed)
        cpu_s = time.monotonic() - t0
        del cpu_model, qtree
    except BaseException:
        for eng in engines.values():
            if eng is not None:
                eng.shutdown()
        raise
    int8_eng = engines["int8"]
    diff = (card - cpu).abs().max().item()
    equal = {mode: rounds["int8", mode]["tokens"]
             == rounds["plain", mode]["tokens"]
             for mode in ("greedy", "seeded")}
    emit("engine_int8", weight_bytes={"int8": int8_bytes,
                                      "plain": plain_bytes},
         weight_ratio=plain_bytes / int8_bytes, quantize_s=quantize_s,
         streams_bitwise_equal=equal,
         distinct_seeded_tokens=len({t for toks in
                                     rounds["int8", "seeded"]["tokens"]
                                     for t in toks}),
         ttft_p50_ms={n: float(np.median(rounds[n, "greedy"]["ttft_ms"]))
                      for n in ("plain", "int8")},
         decode_step_ms_p50={n: stats[n]["latency_ms"]["execute_p50"]
                             for n in ("plain", "int8")},
         decode_step_ms_p99={n: stats[n]["latency_ms"]["execute_p99"]
                             for n in ("plain", "int8")},
         launches=launches, kernels=stats["int8"]["kernels"],
         e2e={"max_abs_diff": diff, "bound": TOL_E2E,
              "top1_card": card.argmax(-1).tolist(),
              "top1_cpu": cpu.argmax(-1).tolist(), "card_s": card_s,
              "cpu_s": cpu_s})
    emit("engine_int8_profile", **profiled)
    try:
        check(0 < int8_bytes <= INT8_MAX_BYTES,
              f"int8 weights hold {int8_bytes} bytes > {INT8_MAX_BYTES}")
        check(plain_bytes > 4 * int8_bytes,
              f"plain {plain_bytes} vs int8 {int8_bytes} bytes")
        check(all(equal.values()), f"int8 streams differ from the plain "
                                   f"engine's on dequantized weights: "
                                   f"{equal}")
        check(bool(torch.isfinite(card).all()),
              "int8 card logits not finite")
        check(diff <= TOL_E2E, f"int8 logits differ by {diff} > {TOL_E2E}")
        check(card.argmax(-1).tolist()[-1] == cpu.argmax(-1).tolist()[-1],
              "int8 e2e top-1 differs")
    except BaseException:
        int8_eng.shutdown()
        raise
    return int8_eng, launches


def _post(port: int, path: str, body: dict) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port: int, path: str) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def phase_serve_single(gen_eng, seed: int):
    """ResNet-50 (stock convs, bf16, train=False) through the single-shot
    ``Engine`` (max_batch 32, 5 ms flush): every bucket warmed, then
    SS_REQUESTS one-image requests in bursts of SS_BURSTS, each served
    row bitwise ``apply_fn`` rerun on its recorded executed batch;
    request/queue/execute p50 and p99, images/s and the fill ratio;
    SS_CPU_IMAGES images' card logits against the CPU's; then
    ``HttpServer(engine=..., generate=gen_eng)`` (the int8 engine): one
    ``/predict``, one ``/generate``, ``/healthz`` and a ``/metrics``
    scrape holding both engines' series. Shuts ``gen_eng`` down."""
    from horovod_tpu_torch.obs.registry import parse_exposition
    from horovod_tpu_torch.serve import Engine, HttpServer, ServeConfig
    try:
        model = build_resnet("xla", seed + 5)

        def apply_fn(m, x):
            return m(x, train=False)
        eng = Engine(apply_fn, model, item_shape=(RN_IMAGE, RN_IMAGE, 3),
                     config=ServeConfig(max_batch=SS_MAX_BATCH,
                                        batch_timeout_ms=SS_TIMEOUT_MS,
                                        record_executed_batch=True))
        srv = None
        try:
            t0 = time.monotonic()
            buckets = eng.warmup()
            torch.cuda.synchronize()
            warm_s = time.monotonic() - t0
            rng = np.random.RandomState(seed + 6)
            images = rng.standard_normal(
                (SS_REQUESTS, RN_IMAGE, RN_IMAGE, 3)).astype(np.float32)
            futs, bursts, i = [], [], 0
            t0 = time.monotonic()
            while i < SS_REQUESTS:
                n = min(SS_BURSTS[len(bursts) % len(SS_BURSTS)],
                        SS_REQUESTS - i)
                burst = [eng.submit(images[j]) for j in range(i, i + n)]
                for f in burst:
                    f.result(600)
                futs += burst
                bursts.append(n)
                i += n
            serve_s = time.monotonic() - t0
            stats = eng.stats()
            # each executed batch once: every served row bitwise its row
            mismatched, batches = 0, {}
            for f in futs:
                batches.setdefault(id(f.request.executed_batch),
                                   (f.request.executed_batch, []))[1] \
                    .append(f)
            with torch.inference_mode():
                for batch, members in batches.values():
                    again = apply_fn(model, torch.from_numpy(batch).to(
                        "cuda")).float().cpu().numpy()
                    for f in members:
                        mismatched += (f.result().tobytes()
                                       != again[f.request.row].tobytes())
            sizes = sorted({f.request.bucket for f in futs})
            cpu_model = copy.deepcopy(model).to("cpu")
            with torch.inference_mode():
                cpu = cpu_model(torch.from_numpy(images[:SS_CPU_IMAGES]),
                                train=False).float().numpy()
            del cpu_model
            card = np.stack([futs[j].result()
                             for j in range(SS_CPU_IMAGES)])
            cpu_diff = float(np.abs(card - cpu).max())

            srv = HttpServer(engine=eng, generate=gen_eng).start()
            code, body = _post(srv.port, "/predict",
                               {"inputs": images[0].tolist()})
            check(code == 200, f"/predict {code}: {body[:200]}")
            pred = np.asarray(json.loads(body)["outputs"], np.float32)
            pred_diff = float(np.abs(pred - futs[0].result()).max())
            code, body = _post(srv.port, "/generate",
                               {"tokens": list(range(1, 65)),
                                "max_new_tokens": 8, "stream": False})
            check(code == 200, f"/generate {code}: {body[:200]}")
            gen_tokens = json.loads(body)["tokens"]
            hz_code, _, hz = _get(srv.port, "/healthz")
            m_code, ctype, text = _get(srv.port, "/metrics")
            parsed = parse_exposition(text.decode())
        finally:
            if srv is not None:
                srv.stop()
            eng.shutdown()
    finally:
        gen_eng.shutdown()
    lat = stats["latency_ms"]
    per_engine = {e: sorted({k[0] for k in parsed
                             if ("engine", e) in k[1]})
                  for e in ("predict", "generate")}
    want_series = ("hvd_request_seconds_count",
                   "hvd_generate_ttft_seconds_count", "hvd_build_info")
    emit("serve_single", buckets=list(buckets), warmup_s=warm_s,
         requests=len(futs), bursts=bursts[:len(SS_BURSTS)],
         buckets_run=sizes, serve_s=serve_s,
         images_per_s=len(futs) / serve_s,
         batches=stats["batches_total"],
         fill_ratio=stats["batch_fill_ratio"],
         request_ms={"p50": lat["request_p50"], "p99": lat["request_p99"]},
         queue_ms={"p50": lat["queue_p50"], "p99": lat["queue_p99"]},
         execute_ms={"p50": lat["execute_p50"], "p99": lat["execute_p99"]},
         rows_not_bitwise=mismatched, executed_batches=len(batches),
         cpu_images=SS_CPU_IMAGES, cpu_max_abs_diff=cpu_diff,
         cpu_bound=TOL_SS_CPU, logits_std=float(cpu.std()),
         http={"predict_max_abs_diff": pred_diff,
               "generate_tokens": len(gen_tokens), "healthz": hz_code,
               "metrics": m_code, "content_type": ctype,
               "series": {e: len(v) for e, v in per_engine.items()}})
    check(mismatched == 0, f"{mismatched} served rows differ from their "
                           f"executed batch's rows")
    check(len(futs) == SS_REQUESTS and set(sizes) >= {1, 4, 8, 32},
          f"served {len(futs)} requests in buckets {sizes}")
    check(cpu_diff <= TOL_SS_CPU, f"serve_single card vs CPU logits "
                                  f"{cpu_diff} > {TOL_SS_CPU}")
    check(pred_diff == 0.0, f"/predict differs from the served row by "
                            f"{pred_diff}")
    check(len(gen_tokens) == 8, f"/generate gave {gen_tokens}")
    check(hz_code == 200, f"/healthz {hz_code}: {hz[:200]}")
    check(m_code == 200 and ctype.startswith("text/plain; version=0.0.4"),
          f"/metrics {m_code} {ctype}")
    for e, names in per_engine.items():
        for series in want_series:
            check(series in names, f"/metrics lacks {series} for "
                                   f"engine={e}")


def _fleet_engine(model):
    """A replica of the fleet phase: the engine phase's configuration
    (paged with K8), FLEET_NEW_TOKENS a stream."""
    return _kv_engine(model, default_max_new_tokens=FLEET_NEW_TOKENS)


def _fleet_load(vocab: int, seed: int):
    """The fleet phase's prompts and per-request sampling (None: greedy),
    and the same as ``/generate`` bodies."""
    from horovod_tpu_torch.serve import SamplingParams
    rng = np.random.RandomState(seed + 11)
    prompts = [rng.randint(0, vocab, FLEET_PROMPT_LENS[
        i % len(FLEET_PROMPT_LENS)]).tolist() for i in range(FLEET_REQUESTS)]
    samplings = [None if i % 2 == 0 else
                 SamplingParams(**FLEET_SAMPLED, seed=100 + i)
                 for i in range(FLEET_REQUESTS)]
    bodies = [{"tokens": p, "max_new_tokens": FLEET_NEW_TOKENS,
               **({} if s is None else dict(FLEET_SAMPLED, seed=s.seed))}
              for p, s in zip(prompts, samplings)]
    return prompts, samplings, bodies


def _http_stream(port: int, body: dict, out: dict) -> None:
    """POST ``body`` to ``/generate`` and read the chunked stream line by
    line, each line's arrival time beside it."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        out["t0"] = time.time()
        conn.request("POST", "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        lines, times = [], []
        for raw in iter(resp.readline, b""):
            raw = raw.strip()
            if raw:
                lines.append(json.loads(raw))
                times.append(time.time())
        conn.close()
        out.update(lines=lines, times=times)
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        out["error"] = repr(e)


def _timed_handle(handle, out: dict) -> None:
    """Drain a generation handle, each token's arrival time beside it."""
    try:
        times = []
        while True:
            kind, val = handle.next_event(600)
            if kind == "token":
                times.append(time.time())
            elif kind == "done":
                out.update(info=val, times=times)
                return
            else:
                raise val
    except Exception as e:  # noqa: BLE001 — reported by the main thread
        out["error"] = repr(e)


def _run_threads(fn, items) -> list:
    outs = [{} for _ in items]
    threads = [threading.Thread(target=fn, args=(*it, o))
               for it, o in zip(items, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "a stream did not end")
    return outs


def _events(kind: str, **match) -> list:
    from horovod_tpu_torch.obs import flightrec
    return [e for e in flightrec.recorder().events()
            if e["kind"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def _resume_ms(kill_t: float, outs: list) -> Optional[dict]:
    """From a replica's death to the first token each stranded stream's
    client received from its replay (the end of the stream's longest
    pause that ends after the death: tokens sent before the death may
    still arrive after it, and the replay's suppressed prefix never
    reaches the client); min and max over the streams that failed
    over."""
    ms = []
    for o in outs:
        t = o["times"]
        if o.get("failovers", 0) < 1 or len(t) < 2:
            continue
        pauses = [(t[j + 1] - t[j], t[j + 1]) for j in range(len(t) - 1)
                  if t[j + 1] > kill_t]
        if pauses:
            ms.append((max(pauses)[1] - kill_t) * 1e3)
    return {"min": min(ms), "max": max(ms), "streams": len(ms)} \
        if ms else None


def phase_fleet(model, seed: int, smi: str):
    """The serving fleet on the bench LM, every replica at the engine
    phase's load with K3-fwd prefills and K8 decode steps; the reference
    is one uninterrupted engine serving the same FLEET_REQUESTS streams.
    (a) Two thread replicas sharing the weights, each with its own pool,
    behind ``HttpServer(generate=router)``; ``replica_kill`` on r1 at its
    FLEET_KILL_STREAM-th stream: every stream bitwise its reference,
    ``resumed`` >= 1, ``exhausted`` 0; ``/healthz`` with the membership,
    ``/metrics`` parsed with ``replica=`` labels and the fleet series; the
    K3-fwd and K8 launches. (b) A subprocess replica
    (``spawn_replica_factory``, ``"device": "cuda"``, the same seed)
    beside a thread replica: its first stream alone, then the fleet's
    half; ``replica_proc_kill`` SIGKILLs it mid-stream and its streams
    resume on the thread replica bitwise their references; spawn → ready
    and kill → first resumed token. (c) ``FleetAutoscaler`` (1 to 2
    replicas) over two bursts: exactly one grow and one shrink, every
    stream bitwise its reference. Every child is reaped."""
    import shutil
    import tempfile

    from horovod_tpu_torch.testing import faults
    run_dir = tempfile.mkdtemp(prefix="hvd-fleet-")
    saved = {k: os.environ.get(k)
             for k in ("HVD_FAULT_SPEC", "HVD_FLIGHTREC_DIR")}
    # The replicas' post-mortems go to the run's directory, not the cwd.
    os.environ["HVD_FLIGHTREC_DIR"] = os.path.join(run_dir, "flightrec")
    try:
        return _fleet_run(model, seed, smi, run_dir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
        shutil.rmtree(run_dir, ignore_errors=True)


def _fleet_run(model, seed: int, smi: str, run_dir: str):
    from horovod_tpu_torch.obs.registry import parse_exposition
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.serve import (FleetAutoscaler, FleetRouter,
                                         HttpServer)
    from horovod_tpu_torch.serve.proc_replica import spawn_replica_factory
    from horovod_tpu_torch.testing import faults
    cfg = model.cfg
    prompts, samplings, bodies = _fleet_load(cfg.vocab, seed)
    launches: dict = {}

    def arm(spec: Optional[str]) -> None:
        if spec is None:
            os.environ.pop("HVD_FAULT_SPEC", None)
        else:
            os.environ["HVD_FAULT_SPEC"] = spec
        faults.reset()

    def want_streams(tokens, what: str) -> None:
        bad = [i for i, t in tokens if list(t) != ref_tokens[i]]
        check(not bad, f"{what}: streams {bad} differ from the "
                       f"uninterrupted engine's")

    # The reference: one uninterrupted engine, all streams at once.
    ref = _fleet_engine(model)
    try:
        ref.warmup()
        t0 = time.monotonic()
        refs = [h.result(600) for h in
                [ref.submit(p, sampling=s) for p, s in zip(prompts,
                                                           samplings)]]
        ref_s = time.monotonic() - t0
        ref_stats = ref.stats()
    finally:
        ref.shutdown()
    ref_tokens = [r["tokens"] for r in refs]
    single = {"wall_s": ref_s,
              "ttft_p50_ms": float(np.median([r["ttft_ms"] for r in refs])),
              "decode_step_ms_p50": ref_stats["latency_ms"]["execute_p50"]}

    # (a) the thread fleet over HTTP, r1 killed mid-stream.
    engines, srv, router = [], None, None
    try:
        arm(f"replica_kill=r1@stream={FLEET_KILL_STREAM}")
        for _ in range(2):
            engines.append(_fleet_engine(model))
            engines[-1].warmup()
        router = FleetRouter(engines=engines, poll_interval_s=FLEET_POLL_S)
        srv = HttpServer(generate=router).start()
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.monotonic()
        outs = _run_threads(lambda b, o: _http_stream(srv.port, b, o),
                            [(b,) for b in bodies])
        torch.cuda.synchronize()
        a_wall = time.monotonic() - t0
        a_launches = LAUNCHES.snapshot()
        hz_code, _, hz = _get(srv.port, "/healthz")
        m_code, _, text = _get(srv.port, "/metrics")
        a_stats = router.stats()
        per_replica = [e.stats() for e in engines]
    finally:
        if srv is not None:
            srv.stop()
        if router is not None:
            router.shutdown()
        for e in engines:
            e.shutdown(drain=False)
        arm(None)
    _add_launches(launches, a_launches)
    for o in outs:
        check("error" not in o and o.get("status") == 200
              and o["lines"] and o["lines"][-1].get("done") is True
              and "error" not in o["lines"][-1],
              f"(a) /generate failed: {o.get('error') or o.get('lines')}")
        done = o["lines"][-1]
        o["failovers"] = done["failovers"]
        check([x["token"] for x in o["lines"][:-1]] == done["tokens"],
              "(a) the streamed tokens are not the done line's")
    want_streams([(i, o["lines"][-1]["tokens"]) for i, o in
                  enumerate(outs)], "(a) the thread fleet")
    fo = a_stats["fleet"]["failover_total"]
    check(fo["resumed"] >= 1 and fo["exhausted"] == 0,
          f"(a) failover outcomes {fo}")
    k3 = a_launches.get("flash_attention", 0)
    k8 = a_launches.get("paged_decode_attention", 0)
    check(k3 >= cfg.n_layers * FLEET_REQUESTS and k3 % cfg.n_layers == 0,
          f"(a) flash_attention launched {k3} times")
    check(k8 > 0 and k8 % cfg.n_layers == 0,
          f"(a) paged_decode_attention launched {k8} times")
    hz = json.loads(hz)
    check(hz_code == 200 and hz.get("replicas") == {
        "ready": 1, "warming": 0, "draining": 0, "dead": 0},
        f"(a) /healthz {hz_code}: {hz}")
    parsed = parse_exposition(text.decode())
    check(m_code == 200 and parsed.get(
        ("hvd_fleet_replicas", (("state", "ready"),))) == 1.0
        and parsed.get(("hvd_failover_total", (("outcome", "resumed"),)),
                       0) >= 1
        and any(dict(lb).get("replica") == "r0" for n, lb in parsed
                if n == "hvd_generate_ttft_seconds_count"),
        "(a) /metrics lacks the fleet series or the replica= labels")
    crash = _events("serve_crash", replica="r1")
    check(bool(crash) and crash[-1]["inflight"],
          "(a) no serve_crash event naming r1's streams")
    kill_t = crash[-1]["t"]
    failed = [e["t"] for e in _events("serve_failover") if e["t"] >= kill_t]
    client_ttft = [(o["times"][0] - o["t0"]) * 1e3 for o in outs]
    thread_fleet = {
        "wall_s": a_wall, "dispatch": a_stats["fleet"]["dispatch_total"],
        "failover": fo, "stranded": a_stats["fleet"][
            "streams_stranded_total"],
        "ttft_p50_ms": float(np.median(
            [o["lines"][-1]["ttft_ms"] for o in outs])),
        "client_ttft_p50_ms": float(np.median(client_ttft)),
        "decode_step_ms_p50": [p["latency_ms"]["execute_p50"]
                               for p in per_replica],
        "kill_to_detect_ms": (min(failed) - kill_t) * 1e3 if failed
        else None,
        "kill_to_resumed_token_ms": _resume_ms(kill_t, outs),
        "launches": a_launches, "healthz": hz,
        "metrics_samples": len(parsed)}

    # (b) a subprocess replica beside a thread replica, SIGKILLed.
    factory, router, thread = None, None, None
    try:
        arm(f"replica_proc_kill=r1@stream={FLEET_PROC_KILL_STREAM}")
        spec = {"model": dict(LM, dtype="bfloat16",
                              unembed_dtype="float32"),
                "seed": seed, "device": "cuda",
                "generation": dict(
                    max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                    paged_kernel=True, block_size=BLOCK,
                    default_max_new_tokens=FLEET_NEW_TOKENS, max_queue=64)}
        factory = spawn_replica_factory(
            spec, run_dir=run_dir, ready_timeout_s=FLEET_READY_TIMEOUT_S)
        thread = _fleet_engine(model)
        thread.warmup()
        router = FleetRouter(engines=[thread], factory=factory,
                             liveness_factory=factory.liveness_factory,
                             poll_interval_s=FLEET_POLL_S)
        t0 = time.monotonic()
        child = router.add_replica(warm=False)
        spawn_s = time.monotonic() - t0
        child.engine.warmup()       # raises if the child dies or times out
        ready_s = time.monotonic() - t0
        check(router.counts()["ready"] == 2, f"(b) {router.counts()}")
        alone = child.engine.generate(prompts[0], sampling=samplings[0],
                                      timeout=600)
        want_streams([(0, alone["tokens"])], "(b) the child alone")
        half = range(FLEET_REQUESTS // 2, FLEET_REQUESTS)
        LAUNCHES.reset()
        handles = [router.submit(prompts[i], sampling=samplings[i])
                   for i in half]
        b_outs = _run_threads(_timed_handle, [(h,) for h in handles])
        torch.cuda.synchronize()
        b_launches = LAUNCHES.snapshot()
        b_stats = router.stats()
        pid = child.engine.pid
        rc = child.engine._proc.wait(60)
    finally:
        if router is not None:
            router.shutdown(timeout=30)
        if thread is not None:
            thread.shutdown(drain=False)
        for c in (factory.clients.values() if factory else ()):
            if c._proc.poll() is None:
                c._proc.kill()
            c._proc.wait(60)
        arm(None)
    _add_launches(launches, b_launches)
    for o in b_outs:
        check("error" not in o, f"(b) a stream failed: {o.get('error')}")
        o["failovers"] = o["info"]["failovers"]
    want_streams([(i, o["info"]["tokens"]) for i, o in zip(half, b_outs)],
                 "(b) the subprocess fleet")
    fo_b = b_stats["fleet"]["failover_total"]
    check(rc == -9, f"(b) the child exited {rc}, not by SIGKILL")
    check(fo_b["resumed"] >= 1 and fo_b["exhausted"] == 0,
          f"(b) failover outcomes {fo_b}")
    with open(os.path.join(run_dir, "flightrec", "r1",
                           "hvd_flightrec.rank0.json")) as f:
        crash = [e for e in json.load(f)["events"]
                 if e["kind"] == "serve_crash"]
    check(bool(crash) and crash[-1]["inflight"],
          "(b) the child left no serve_crash naming its streams")
    kill_t = crash[-1]["t"]
    failed = [e["t"] for e in _events("serve_failover", replica="r1")
              if e["t"] >= kill_t]
    proc_fleet = {
        "spawn_s": spawn_s, "spawn_to_ready_s": ready_s, "child_pid": pid,
        "child_rc": rc, "dispatch": b_stats["fleet"]["dispatch_total"],
        "failover": fo_b,
        "kill_to_detect_ms": (min(failed) - kill_t) * 1e3 if failed
        else None,
        "kill_to_resumed_token_ms": _resume_ms(kill_t, b_outs),
        "launches": b_launches}

    # (c) the autoscaler over two bursts.
    router = None
    try:
        router = FleetRouter(factory=lambda name: _fleet_engine(model),
                             initial=1, poll_interval_s=FLEET_POLL_S)
        router.warmup()
        scaler = FleetAutoscaler(router, **FLEET_SCALE)
        decisions = []

        def poll_until(pred, what: str, limit_s: float = 240.0) -> None:
            end = time.monotonic() + limit_s
            while not pred():
                check(time.monotonic() < end, f"(c) {what}: {decisions}")
                d = scaler.poll_once()
                if d is not None:
                    decisions.append((d, time.monotonic()))
                time.sleep(FLEET_POLL_S)

        LAUNCHES.reset()
        first = [router.submit(prompts[i], sampling=samplings[i])
                 for i in range(FLEET_REQUESTS // 2)]
        t_burst = time.monotonic()
        poll_until(lambda: router.counts()["ready"] == 2, "no grow")
        grow_ready_s = time.monotonic() - decisions[0][1]
        second = [router.submit(prompts[i], sampling=samplings[i])
                  for i in range(FLEET_REQUESTS // 2, FLEET_REQUESTS)]
        results = [h.result(600) for h in first + second]
        c_dispatch = router.stats()["fleet"]["dispatch_total"]
        poll_until(lambda: router.counts() == {
            "ready": 1, "warming": 0, "draining": 0, "dead": 0}
            and len(decisions) >= 2, "no shrink")
        for _ in range(3):          # settled: no further decision
            d = scaler.poll_once()
            if d is not None:
                decisions.append((d, time.monotonic()))
        torch.cuda.synchronize()
        c_launches = LAUNCHES.snapshot()
        c_stats = router.stats()
    finally:
        if router is not None:
            router.shutdown()
    _add_launches(launches, c_launches)
    want_streams(list(enumerate(r["tokens"] for r in results)),
                 "(c) the autoscaled fleet")
    check([d for d, _ in decisions] == ["grow", "shrink"]
          and c_stats["fleet"]["scale_events"] == {"grow": 1, "shrink": 1},
          f"(c) decisions {[d for d, _ in decisions]}, "
          f"{c_stats['fleet']['scale_events']}")
    autoscale = {"decisions": [d for d, _ in decisions],
                 "burst_to_grow_s": decisions[0][1] - t_burst,
                 "grow_to_ready_s": grow_ready_s,
                 "dispatch": c_dispatch, "launches": c_launches}
    for part, got in (("(b)", b_launches), ("(c)", c_launches)):
        check(got.get("flash_attention", 0) > 0
              and got.get("paged_decode_attention", 0) > 0,
              f"{part} K3-fwd or K8 not launched: {got}")
    emit("fleet", nvidia_smi=smi, requests=FLEET_REQUESTS,
         new_tokens=FLEET_NEW_TOKENS, single=single,
         thread_fleet=thread_fleet, proc_fleet=proc_fleet,
         autoscale=autoscale, launches=launches)
    return launches


# -- serving under a tp mesh ------------------------------------------------

def _tp_load(vocab: int, seed: int) -> tuple:
    """serve_tp (c)'s requests: TP_REQUESTS prompts cycling
    FLEET_PROMPT_LENS, greedy and seeded in turns (each request's
    sampling as a dict, None for greedy)."""
    rng = np.random.RandomState(seed + 19)
    prompts = [rng.randint(0, vocab, FLEET_PROMPT_LENS[i % len(
        FLEET_PROMPT_LENS)]) for i in range(TP_REQUESTS)]
    samplings = [None if i % 2 == 0 else dict(TP_SAMPLED, seed=i)
                 for i in range(TP_REQUESTS)]
    return prompts, samplings


def _tp_samplings(samplings) -> list:
    """:func:`_tp_load`'s samplings as :func:`_kv_serve` takes them."""
    from horovod_tpu_torch.serve import SamplingParams
    return [None if s is None else SamplingParams(**s) for s in samplings]


def _tp_margins(w, cfg, prompts, streams, mesh) -> list:
    """Per greedy stream, the top-2 logit margin at each generated
    position: one prefill of the prompt and the stream (teacher forced)."""
    from horovod_tpu_torch.parallel.transformer import (init_kv_cache,
                                                        prefill)
    out = []
    for p, toks in zip(prompts, streams):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int64)])
        cache = init_kv_cache(cfg, 1, MAX_LEN, device="cuda", mesh=mesh)
        with torch.no_grad():
            _, lg = prefill(w, torch.tensor(seq, device="cuda"), cache, 0,
                            cfg)
        top = lg[len(p) - 1:].topk(2, dim=-1).values
        out.append((top[:, 0] - top[:, 1]).cpu().numpy().tolist())
        del cache, lg
    return out


def _serve_tp_one_rank(model, seed: int, run_dir: str) -> tuple:
    """(a): the bench LM on a one-rank tp mesh (the same weights as the
    engine phase's model) at the engine phase's load in both layouts,
    every stream bitwise the plain engines'; then (c)'s load on it, the
    reference streams and greedy margins of the tp = 2 world, and the
    prefill and decode logits its |Δ| is measured against."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.parallel.transformer import (
        Transformer, decode_step, gen_weights, init_kv_cache, prefill)
    from horovod_tpu_torch.serve import HttpServer
    cfg = model.cfg
    L = cfg.n_layers
    launches_total: dict = {}
    lines = {}
    hvd.init()
    try:
        mesh = make_mesh({"tp": 1})
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tp1 = Transformer(cfg, generator=gen, device="cuda", mesh=mesh)
        check(all(torch.equal(a, b) for a, b in zip(
            tp1.parameters(), model.parameters())),
              "serve_tp: the one-rank tp model's weights differ from the "
              "engine phase's")
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(0, cfg.vocab, n) for n in PROMPT_LENS]
        http_prompt = rng.randint(0, cfg.vocab, HTTP_PROMPT_LEN)
        refs = {"paged": PAGED_STREAMS, "contiguous": CONTIGUOUS_STREAMS}
        for layout in ("paged", "contiguous"):
            ref = refs[layout].get("tokens")
            plain_p50 = refs[layout].get("decode_step_ms_p50")
            if ref is None:
                # The plain engine's streams when the engine and engine_kv
                # phases did not run before this one.
                plain = _kv_engine(model, kv_layout=layout,
                                   default_max_new_tokens=NEW_TOKENS)
                try:
                    plain.warmup()
                    ref = [r["tokens"] for r in _kv_serve(plain, prompts)[0]]
                    plain_p50 = plain.stats()["latency_ms"]["execute_p50"]
                finally:
                    plain.shutdown()
                del plain
            eng = _kv_engine(tp1, kv_layout=layout,
                             default_max_new_tokens=NEW_TOKENS)
            srv = None
            try:
                eng.warmup()
                # One request over HTTP on the leader first, then the
                # engine phase's prompts with the counters zeroed.
                srv = HttpServer(generate=eng).start()
                http_out: dict = {}
                _http_generate(srv.port, http_prompt, http_out)
                res, launches, steps, wall_s = _kv_serve(eng, prompts)
                stats = eng.stats()
            finally:
                if srv is not None:
                    srv.stop()
                eng.shutdown()
            del eng
            check(http_out.get("status") == 200
                  and http_out["lines"][-1].get("n_tokens") == NEW_TOKENS,
                  f"serve_tp (a) {layout}: HTTP /generate failed: "
                  f"{http_out}")
            _add_launches(launches_total, launches)
            got = [r["tokens"] for r in res]
            check(got == ref,
                  f"serve_tp (a) {layout}: the one-rank tp engine's streams "
                  f"differ from the plain engine's")
            k3 = launches.get("flash_attention", 0)
            k8 = launches.get("paged_decode_attention", 0)
            check(k3 == L * len(prompts),
                  f"serve_tp (a) {layout}: flash_attention launched {k3}")
            check(k8 == (L * steps if layout == "paged" else 0)
                  and steps > 0,
                  f"serve_tp (a) {layout}: paged_decode_attention launched "
                  f"{k8} in {steps} steps")
            lines[layout] = dict(
                streams_bitwise_plain=True, requests=len(prompts),
                http_requests=1,
                launches=launches, decode_steps=steps, wall_s=wall_s,
                decode_step_ms_p50=stats["latency_ms"]["execute_p50"],
                plain_decode_step_ms_p50=plain_p50,
                ttft_p50_ms=stats["generation"]["ttft_p50"])
            torch.cuda.empty_cache()
        emit("serve_tp", part="a_one_rank", mesh={"tp": 1}, **lines)

        # (c)'s reference on the one-rank engine: its load in both
        # layouts, the greedy streams' margins, and one prefill and one
        # decode step's logits.
        load_prompts, samplings = _tp_load(cfg.vocab, seed)
        ref = {}
        w = gen_weights(tp1)
        for layout in ("contiguous", "paged"):
            eng = _kv_engine(tp1, kv_layout=layout,
                             default_max_new_tokens=TP_NEW_TOKENS)
            try:
                eng.warmup()
                res, _, _, _ = _kv_serve(eng, load_prompts,
                                         sampling=_tp_samplings(samplings))
            finally:
                eng.shutdown()
            del eng
            streams = [r["tokens"] for r in res]
            greedy = [i for i, s in enumerate(samplings) if s is None]
            ref[layout] = dict(tokens=streams, margins=dict(zip(
                greedy, _tp_margins(w, cfg, [load_prompts[i] for i in greedy],
                                    [streams[i] for i in greedy], mesh))))
        probe = load_prompts[2]
        cache = init_kv_cache(cfg, 1, MAX_LEN, device="cuda", mesh=mesh)
        with torch.no_grad():
            _, pre = prefill(w, torch.tensor(probe, device="cuda"), cache, 0,
                             cfg)
            nxt = int(pre[-1].argmax())
            _, dec = decode_step(
                w, torch.tensor([nxt], device="cuda"), cache,
                torch.tensor([len(probe)], dtype=torch.int32, device="cuda"),
                cfg)
        np.save(os.path.join(run_dir, "probe.npy"), probe)
        np.save(os.path.join(run_dir, "prefill.npy"), pre.cpu().numpy())
        np.save(os.path.join(run_dir, "decode.npy"), dec.cpu().numpy())
        with open(os.path.join(run_dir, "load.json"), "w") as f:
            json.dump(dict(prompts=[p.tolist() for p in load_prompts],
                           samplings=samplings, next_token=nxt), f)
        del tp1, w, cache, pre, dec
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    return launches_total, ref


def _tp_kernel_rows(seed: int, peaks) -> None:
    """(b): K3-fwd at T = TP_FLASH_T and K8 in the balanced and engine-mix
    plans at the per-rank head counts of TP_SIZES, each against its plain
    version on the same inputs and timed beside its bound (K3-fwd also
    beside SDPA on the same q, k, v)."""
    from horovod_tpu_torch.ops.attention import (flash_attention_prefill,
                                                 flash_attention_reference)
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    d, T, L = 128, TP_FLASH_T, LM["n_layers"]
    plans = dict(PAGED_TIMED)
    rng = np.random.RandomState(seed + 3)
    plans["balanced"] = tuple(int(p) for p in rng.randint(896, 1152,
                                                          MAX_SLOTS))
    for tp in (1,) + TP_SIZES:
        H = LM["n_heads"] // tp
        qkv = torch.randn((1, T, H, 3, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        got = flash_attention_prefill(q, k, v, causal=True)
        want = flash_attention_reference(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        check(err <= TOL_FLASH, f"serve_tp (b): flash_attention at {H} "
                                f"heads off its plain version by {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # Queued behind a sleep, as K8: at 4 and 8 heads the launch is
        # shorter than its host call.
        ms = time_ms(lambda: flash_attention_prefill(q, k, v, causal=True),
                     queued=True)
        host = host_ms(lambda: flash_attention_prefill(q, k, v, causal=True))
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, causal=True), reps=5, inner=2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), queued=True)
        bnd, by = bound_ms(4.0 * d * H * T * (T + 1) / 2,
                           4.0 * T * H * d * 2, peaks)
        emit("serve_tp", part="b_kernels", kernel="flash_attention", tp=tp,
             heads=H, T=T, ms=ms, plain_ms=plain, library_ms=lib,
             bound_ms=bnd, bound_by=by, share_of_bound=bnd / ms,
             max_abs_err=err, host_ms_per_call=host, timed="queued",
             library="torch.nn.functional.scaled_dot_product_attention")
        del qkv, q, k, v, got, want, qt, kt, vt
        if tp == 1:
            continue
        for name in ("balanced", "engine_mix"):
            positions = plans[name]
            qp, kp, vp, tables, pos = paged_inputs(positions, gen, layers=L,
                                                   heads=H)
            got = paged_decode_attention(qp, kp[0], vp[0], tables, pos)
            want = paged_attention_reference(qp, kp[0], vp[0], tables, pos)
            err = float((got.float() - want.float()).abs().max())
            check(err <= TOL_PAGED,
                  f"serve_tp (b): paged_decode_attention at {H} heads "
                  f"({name}) off its plain version by {err}")
            views = [(kp[i], vp[i]) for i in range(L)]
            turn = itertools.cycle(views).__next__

            def run():
                kk, vv = turn()
                return paged_decode_attention(qp, kk, vv, tables, pos)
            ms = time_ms(run, queued=True)
            plain = time_ms(lambda: paged_attention_reference(
                qp, kp[0], vp[0], tables, pos), reps=5, inner=2)
            keys = sum(min(p, MAX_LEN - 1) + 1 for p in positions if p >= 0)
            nbytes = (keys * H * d * 2 * 2 + 2 * qp.numel() * 2
                      + tables.numel() * 4)
            bnd, by = bound_ms(4.0 * d * H * keys, nbytes, peaks)
            emit("serve_tp", part="b_kernels",
                 kernel="paged_decode_attention", tp=tp, heads=H, shape=name,
                 S=len(positions), keys=keys, ms=ms, plain_ms=plain,
                 library_ms=None, bound_ms=bnd, bound_by=by,
                 share_of_bound=bnd / ms, max_abs_err=err)
            del qp, kp, vp, views, got, want
            torch.cuda.empty_cache()


def _first_diff(a, b) -> Optional[int]:
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def _check_tp_deltas(rec: dict, prefix: str, what: str) -> None:
    """The tp = 2 world's prefill and decode logits within TP_DELTA_CAPS
    of the one-rank engine's (``prefix`` picks the sound forward's
    readings or the control's)."""
    for name, cap in TP_DELTA_CAPS.items():
        d = rec[f"{prefix}{name}_max_abs_delta"]
        check(math.isfinite(d) and d <= cap,
              f"serve_tp (c): {what}'s {name} logits are {d} off the "
              f"one-rank engine's, above the cap {cap}")


def _serve_tp_world(seed: int, ref: dict, run_dir: str) -> None:
    """(c): a tp = 2 world of two processes sharing the card, each calling
    ``dist.init_process_group("gloo")`` before ``hvd.init(device="cuda")``
    (this script's ``--serve-tp-rank`` mode). Checks the streams against
    the one-rank engine's where the greedy margin exceeds the measured
    |Δ|, the followers' launches against the leader's, and that the
    SIGKILLed follower fails the leader's streams within the plane's
    timeout; holds the logits' |Δ| to TP_DELTA_CAPS, and checks that the
    caps fail a control with the row-parallel sums dropped; reaps both
    processes, on failure too."""
    import socket
    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, HVD_FLIGHTREC_DIR=run_dir,
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_FAULT_SPEC"):
        env.pop(k, None)
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for r in range(2):
            log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--serve-tp-rank", str(r), "--serve-tp-dir", run_dir,
                 "--serve-tp-port", str(port), "--seed", str(seed)],
                cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = t0 + TP_WORLD_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    world_s = time.monotonic() - t0

    def tail(r):
        with open(os.path.join(run_dir, f"rank{r}.log")) as f:
            return f.read()[-3000:]
    check(procs[0].returncode == 0,
          f"serve_tp (c): the leader exited {procs[0].returncode}:\n"
          f"{tail(0)}")
    check(procs[1].returncode == -signal.SIGKILL,
          f"serve_tp (c): the follower exited {procs[1].returncode} "
          f"(expected its own SIGKILL):\n{tail(1)}")
    recs = []
    for r in range(2):
        with open(os.path.join(run_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    lead, fol = recs
    _check_tp_deltas(lead, "", "the tp = 2 forward")
    try:
        _check_tp_deltas(lead, "control_", "the control")
        caught = False
    except AssertionError:
        caught = True
    check(caught, f"serve_tp (c): the |Δ| caps {TP_DELTA_CAPS} pass the "
                  f"control with every row-parallel sum dropped")
    delta = max(lead["prefill_max_abs_delta"], lead["decode_max_abs_delta"])
    L = LM["n_layers"]
    out = {}
    for layout in ("contiguous", "paged"):
        got, want = lead[layout], ref[layout]
        agree, identical = [], 0
        for i, (a, b) in enumerate(zip(got["tokens"], want["tokens"])):
            j = _first_diff(a, b)
            agree.append(sum(x == y for x, y in zip(a, b)))
            identical += j is None
            margins = want["margins"].get(i)
            if margins is not None and j is not None:
                check(margins[j] <= 2 * delta,
                      f"serve_tp (c) {layout}: greedy stream {i} differs "
                      f"from the one-rank engine's at token {j}, where "
                      f"the margin {margins[j]} exceeds 2 x |Δ| {delta}")
        check(all(len(t) == TP_NEW_TOKENS for t in got["tokens"]),
              f"serve_tp (c) {layout}: a stream did not finish")
        lk3 = got["launches"].get("flash_attention", 0)
        lk8 = got["launches"].get("paged_decode_attention", 0)
        check(lk3 == L * TP_REQUESTS,
              f"serve_tp (c) {layout}: the leader's flash_attention "
              f"launched {lk3}, expected {L} x {TP_REQUESTS}")
        check(lk8 == (L * got["steps"] if layout == "paged" else 0),
              f"serve_tp (c) {layout}: the leader's paged_decode_attention "
              f"launched {lk8} in {got['steps']} steps")
        fk = fol[layout]["launches"]
        for name in ("flash_attention", "paged_decode_attention"):
            want_n = (got["launches"].get(name, 0)
                      + got["warmup_launches"].get(name, 0))
            check(fk.get(name, 0) == want_n,
                  f"serve_tp (c) {layout}: the follower launched {name} "
                  f"{fk.get(name, 0)} times, the leader {want_n}")
        plane = got["plane"]
        out[layout] = dict(
            streams_identical=identical, requests=TP_REQUESTS,
            tokens_agree=agree, greedy_margins_min=min(
                min(m) for m in want["margins"].values()),
            leader_launches=got["launches"], follower_launches=fk,
            decode_steps=got["steps"], wall_s=got["wall_s"],
            decode_step_ms_p50=got["decode_step_ms_p50"],
            ttft_p50_ms=got["ttft_p50_ms"],
            plane_calls=plane["calls"],
            plane_host_ms_per_call=plane["send_ms"] / max(plane["calls"], 1),
            plane_payload_bytes_per_call=(plane["payload_bytes"]
                                          / max(plane["calls"], 1)))
    kill = lead["kill"]
    # A started stream fails with the group's error; one the death caught
    # before its first token is refused (the leader closed for good).
    check(any(kill["started"]) and all(
        e in (("WorkerFailureError", "StalledError", "TransportError")
              if started else ("ServerClosedError",))
        for e, started in zip(kill["errors"], kill["started"])),
          f"serve_tp (c): the killed follower's round ended {kill}")
    kill_ms = (kill["first_error_at"] - fol["killed_at"]) * 1e3
    check(0 <= kill_ms < TP_PLANE_S * 1e3,
          f"serve_tp (c): kill -> the leader's error took {kill_ms} ms")
    emit("serve_tp", part="c_tp2_world", tp=2, heads=LM["n_heads"] // 2,
         note="both ranks share one card and a gloo link: step times are "
              "not tp speed", world_s=world_s,
         step_allreduce_ms=lead["allreduce_ms"],
         step_allreduces=2 * L,
         prefill_max_abs_delta=lead["prefill_max_abs_delta"],
         decode_max_abs_delta=lead["decode_max_abs_delta"],
         delta_caps=TP_DELTA_CAPS,
         control_prefill_max_abs_delta=lead[
             "control_prefill_max_abs_delta"],
         control_decode_max_abs_delta=lead["control_decode_max_abs_delta"],
         kill_to_leader_error_ms=kill_ms, kill_errors=kill["errors"],
         **out)


def phase_serve_tp(model, seed: int, peaks) -> dict:
    """Serving under a tp mesh: (a) one rank, (b) the kernels at the
    per-rank head counts, (c) a tp = 2 world on the card. Returns (a)'s
    K3-fwd and K8 launches."""
    import shutil
    import tempfile
    run_dir = tempfile.mkdtemp(prefix="hvd-serve-tp-")
    try:
        launches, ref = _serve_tp_one_rank(model, seed, run_dir)
        _tp_kernel_rows(seed, peaks)
        _serve_tp_world(seed, ref, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return launches


def serve_tp_worker(rank: int, run_dir: str, port: int, seed: int) -> int:
    """One rank of serve_tp (c)'s world (``--serve-tp-rank``): a gloo
    group built here, then ``hvd.init(device="cuda")`` (which adopts it;
    both ranks drive ``cuda:0``), the bench LM on ``create_hybrid_mesh(
    tp=2)`` from the seed (8 heads a rank), (c)'s |Δ| forwards, its load
    in both layouts, and a third round whose follower SIGKILLs itself.
    Writes ``rank<r>.json`` in ``run_dir``."""
    import datetime

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=TP_PLANE_S))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    from horovod_tpu_torch.parallel.transformer import (
        Transformer, TransformerConfig, decode_step, gen_weights,
        init_kv_cache, prefill)
    hvd.init(device="cuda")
    mesh = create_hybrid_mesh(tp=2)
    cfg = TransformerConfig(**LM, dtype=torch.bfloat16,
                            unembed_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = Transformer(cfg, generator=gen, device="cuda", mesh=mesh)
    torch.cuda.empty_cache()
    with open(os.path.join(run_dir, "load.json")) as f:
        load = json.load(f)
    rec = {"rank": rank, "heads": cfg.n_heads // 2}
    path = os.path.join(run_dir, f"rank{rank}.json")

    def dump():
        with open(path, "w") as f:
            json.dump(rec, f)
    probe = np.load(os.path.join(run_dir, "probe.npy"))
    w = gen_weights(model)

    def probe_deltas(prefix: str) -> None:
        # One prefill of the probe and one decode step after it, each
        # logits' max |Δ| against the one-rank engine's.
        cache = init_kv_cache(cfg, 1, MAX_LEN, device="cuda", mesh=mesh)
        with torch.no_grad():
            _, pre = prefill(w, torch.tensor(probe, device="cuda"), cache,
                             0, cfg)
            _, dec = decode_step(
                w, torch.tensor([load["next_token"]], device="cuda"), cache,
                torch.tensor([len(probe)], dtype=torch.int32,
                             device="cuda"), cfg)
        for name, got in (("prefill", pre), ("decode", dec)):
            want = np.load(os.path.join(run_dir, f"{name}.npy"))
            rec[f"{prefix}{name}_max_abs_delta"] = float(
                np.abs(got.cpu().numpy() - want).max())
    probe_deltas("")
    if rank == 0:
        # The control: the same forwards with every row-parallel sum
        # dropped (each rank keeps its own partial product), a wrong tp
        # path that TP_DELTA_CAPS must catch. It issues no collective, so
        # the leader runs it alone.
        from horovod_tpu_torch.parallel import transformer as ttr
        real = ttr.tp_reduce
        ttr.tp_reduce = lambda mesh: (lambda y: y)
        try:
            probe_deltas("control_")
        finally:
            ttr.tp_reduce = real
    torch.cuda.empty_cache()
    # What one of a decode step's 2 x n_layers row-parallel sums costs
    # on this world (gloo through host staging).
    row = torch.zeros((MAX_SLOTS, cfg.d_model), dtype=cfg.dtype,
                      device="cuda")
    for _ in range(3):
        dist.all_reduce(row)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(row)
    torch.cuda.synchronize()
    rec["allreduce_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    prompts = [np.asarray(p) for p in load["prompts"]]
    samplings = load["samplings"]
    for layout in ("contiguous", "paged"):
        LAUNCHES.reset()
        eng = _kv_engine(model, kv_layout=layout,
                         default_max_new_tokens=TP_NEW_TOKENS)
        if not eng.is_leader:
            eng.wait(TP_WORLD_S)
            rec[layout] = dict(launches=LAUNCHES.snapshot(),
                               plane=eng.stats()["tp"])
            continue
        eng.warmup()
        torch.cuda.synchronize()
        warm = LAUNCHES.snapshot()
        try:
            res, launches, steps, wall_s = _kv_serve(
                eng, prompts, sampling=_tp_samplings(samplings))
            stats = eng.stats()
        finally:
            eng.shutdown()
        rec[layout] = dict(
            tokens=[r["tokens"] for r in res], launches=launches,
            warmup_launches=warm, steps=steps, wall_s=wall_s,
            decode_step_ms_p50=stats["latency_ms"]["execute_p50"],
            ttft_p50_ms=stats["generation"]["ttft_p50"], plane=stats["tp"])
        del eng
        torch.cuda.empty_cache()
    # The kill round: the follower dies TP_KILL_CALLS descriptors in.
    eng = _kv_engine(model, kv_layout="paged",
                     default_max_new_tokens=TP_NEW_TOKENS)
    if not eng.is_leader:
        while eng._plane.calls < TP_KILL_CALLS and eng._thread.is_alive():
            time.sleep(0.0005)
        rec["killed_at"] = time.time()
        dump()
        os.kill(os.getpid(), signal.SIGKILL)
    eng.warmup()
    hs = [eng.submit(p, sampling=None) for p in prompts]
    errors, first = [], None
    for h in hs:
        try:
            h.result(TP_WORLD_S)
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — what the round checks
            first = first or time.time()
            errors.append(type(e).__name__)
    rec["kill"] = dict(errors=errors, first_error_at=first,
                       started=[bool(h._tokens) for h in hs])
    eng.shutdown(drain=False, timeout=TP_PLANE_S)
    dump()
    sys.stdout.flush()
    # The world lost a rank: skip the process groups' teardown.
    os._exit(0)


# -- a fleet of tp groups ---------------------------------------------------

def _fresh_beats(client, after: float, limit_s: float = 10.0) -> list:
    """Each rank's heartbeat record written after ``after`` (time.time()):
    its kernel launches and peak bytes as they stand once idle."""
    end = time.monotonic() + limit_s
    while True:
        beats = client.rank_heartbeats()
        if all(b.get("ts", 0) > after for b in beats):
            return beats
        check(time.monotonic() < end,
              f"fleet_tp: {client.name}'s ranks stopped beating: {beats}")
        time.sleep(0.05)


def _launch_delta(before: list, after: list) -> list:
    names = ("flash_attention", "paged_decode_attention")
    return [{n: a["launches"].get(n, 0) - b["launches"].get(n, 0)
             for n in names} for b, a in zip(before, after)]


def _ftp_round(router, prompts, samplings) -> list:
    """Every request from its own thread, all at once (a group's submit
    returns at the stream's first token), each token's arrival time
    beside it."""
    def one(i, out):
        try:
            h = router.submit(prompts[i], sampling=samplings[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            out["error"] = repr(e)
            return
        _timed_handle(h, out)
    return _run_threads(one, [(i,) for i in range(len(prompts))])


def phase_fleet_tp(seed: int, smi: str):
    """A fleet of tp groups on the card: ``FleetRouter`` over two tp = 2
    groups of the bench LM (``spawn_replica_factory`` with ``"tp": 2``
    and the device sets FTP_DEVICES: four processes, two gloo worlds
    sharing the card, 8 heads a rank), paged with K8. (a) The fleet
    phase's requests: every stream served, K3-fwd and K8 launched on
    every rank (the children's counters, read from their heartbeats just
    before and just after the round), each follower's launches equal to
    its leader's, K3-fwd n_layers a prefill of its group. (b) The same
    round with a follower of r0 SIGKILLed after r0's FTP_KILL_STREAM-th
    stream's first token: every stream bitwise its stream in (a), strands
    each resumed and none exhausted, r0's leader gone within the world's
    timeout plus FTP_EXIT_MARGIN_S. No rank outlives the shutdown. Prints
    spawn → ready, kill → detection and → each resumed stream's first
    token, the decode step p50 of each group and each rank's peak bytes.
    Returns (a)'s launches on every rank, summed."""
    import shutil
    import tempfile

    from horovod_tpu_torch.testing import faults
    run_dir = tempfile.mkdtemp(prefix="hvd-fleet-tp-")
    here = os.path.dirname(os.path.abspath(__file__))
    saved = {k: os.environ.get(k)
             for k in ("HVD_FAULT_SPEC", "HVD_FLIGHTREC_DIR", "PYTHONPATH")}
    os.environ.pop("HVD_FAULT_SPEC", None)
    os.environ["HVD_FLIGHTREC_DIR"] = os.path.join(run_dir, "flightrec")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in (saved["PYTHONPATH"] or "").split(os.pathsep)
                  if p])
    faults.reset()
    try:
        return _fleet_tp_run(seed, smi, run_dir)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
        shutil.rmtree(run_dir, ignore_errors=True)


def _fleet_tp_run(seed: int, smi: str, run_dir: str):
    from horovod_tpu_torch.serve import FleetRouter
    from horovod_tpu_torch.serve.proc_replica import spawn_replica_factory
    L = LM["n_layers"]
    prompts, samplings, _ = _fleet_load(LM["vocab"], seed)
    spec = {"model": dict(LM, dtype="bfloat16", unembed_dtype="float32"),
            "seed": seed, "tp": 2, "world_timeout_s": FTP_WORLD_S,
            "generation": dict(
                max_slots=MAX_SLOTS, max_len=MAX_LEN, kv_layout="paged",
                paged_kernel=True, block_size=BLOCK,
                default_max_new_tokens=FLEET_NEW_TOKENS, max_queue=64)}
    # Four ranks and this process share the host's cores: a leader's
    # /healthz gets FTP_PROBE_S before a miss counts toward its eviction.
    factory = spawn_replica_factory(
        spec, run_dir=run_dir, ready_timeout_s=FTP_READY_TIMEOUT_S,
        device_groups=[list(FTP_DEVICES)] * 2,
        client_kwargs={"probe_timeout_s": FTP_PROBE_S})
    router = FleetRouter(factory=factory,
                         liveness_factory=factory.liveness_factory,
                         poll_interval_s=FLEET_POLL_S)
    clients, out, launches = [], {}, {}
    try:
        t0 = time.monotonic()
        handles = [router.add_replica(warm=False) for _ in range(2)]
        clients = [h.engine for h in handles]
        spawn_s = time.monotonic() - t0
        ready_s = [None, None]

        def warm(i, box):
            clients[i].warmup()     # raises if a rank dies or times out
            ready_s[i] = time.monotonic() - t0
        warmed = _run_threads(lambda i, box: _guard(warm, i, box),
                              [(0,), (1,)])
        for w in warmed:
            check("error" not in w, f"fleet_tp: a group failed its warmup: "
                                    f"{w.get('error')}")
        check(router.counts()["ready"] == 2, f"fleet_tp: {router.counts()}")
        for c in clients:
            check(c.tp == 2 and c.stats()["tp"]["backend"] == "gloo",
                  f"fleet_tp: {c.name} is not a tp = 2 gloo world")

        # (a) the undisturbed round.
        mark = time.time()
        base = [_fresh_beats(c, mark) for c in clients]
        t_a = time.monotonic()
        a_outs = _ftp_round(router, prompts, samplings)
        a_wall = time.monotonic() - t_a
        mark = time.time()
        a_beats = [_fresh_beats(c, mark) for c in clients]
        a_stats = router.stats()["fleet"]
        for o in a_outs:
            check("error" not in o, f"fleet_tp (a): a stream failed: "
                                    f"{o.get('error')}")
        tokens = [o["info"]["tokens"] for o in a_outs]
        check(all(len(t) == FLEET_NEW_TOKENS for t in tokens),
              "fleet_tp (a): a stream did not finish")
        a_launch = {}
        for c, b0, b1 in zip(clients, base, a_beats):
            per_rank = _launch_delta(b0, b1)
            a_launch[c.name] = per_rank
            n = a_stats["dispatch_total"].get(c.name, 0)
            lead, fol = per_rank
            check(n > 0, f"fleet_tp (a): {c.name} took no request of the "
                         f"burst: {a_stats['dispatch_total']}")
            check(lead["flash_attention"] == L * n
                  and lead["paged_decode_attention"] > 0
                  and lead["paged_decode_attention"] % L == 0,
                  f"fleet_tp (a): {c.name}'s leader launched {lead} for "
                  f"{n} requests")
            check(fol == lead, f"fleet_tp (a): {c.name}'s follower "
                               f"launched {fol}, its leader {lead}")
            for r in per_rank:
                _add_launches(launches, r)
        step_p50 = {c.name: c.stats().get("latency_ms", {}).get(
            "execute_p50") for c in clients}
        peaks = {c.name: [b.get("peak_bytes") for b in beats]
                 for c, beats in zip(clients, a_beats)}

        # (b) the same round, a follower of r0 SIGKILLed after r0's
        # FTP_KILL_STREAM-th stream's first token.
        c0 = clients[0]
        follower, leader = c0.pids[1], c0._proc
        seen, kill_t, exit_t = [0], [], []
        submit = c0.submit

        def watch_leader():
            leader.wait()
            exit_t.append(time.time())

        def submit_then_kill(*a, **kw):
            h = submit(*a, **kw)
            seen[0] += 1
            if seen[0] == FTP_KILL_STREAM:
                os.kill(follower, signal.SIGKILL)
                kill_t.append(time.time())
                threading.Thread(target=watch_leader, daemon=True).start()
            return h
        c0.submit = submit_then_kill
        before = router.stats()["fleet"]
        t_b = time.monotonic()
        b_outs = _ftp_round(router, prompts, samplings)
        b_wall = time.monotonic() - t_b
        check(bool(kill_t), f"fleet_tp (b): r0 took fewer than "
                            f"{FTP_KILL_STREAM} streams")
        for i, o in enumerate(b_outs):
            check("error" not in o, f"fleet_tp (b): stream {i} failed: "
                                    f"{o.get('error')}")
            o["failovers"] = o["info"]["failovers"]
        bad = [i for i, o in enumerate(b_outs)
               if o["info"]["tokens"] != tokens[i]]
        check(not bad, f"fleet_tp (b): streams {bad} differ from their "
                       f"undisturbed streams")
        end = time.monotonic() + FTP_WORLD_S + FTP_EXIT_MARGIN_S
        while not exit_t and time.monotonic() < end:
            time.sleep(0.01)
        check(bool(exit_t) and exit_t[0] - kill_t[0]
              <= FTP_WORLD_S + FTP_EXIT_MARGIN_S,
              f"fleet_tp (b): r0's leader outlived its follower by more "
              f"than {FTP_WORLD_S + FTP_EXIT_MARGIN_S} s")
        b_stats = router.stats()["fleet"]
        stranded = (b_stats["streams_stranded_total"]
                    - before["streams_stranded_total"])
        fo = {k: v - before["failover_total"].get(k, 0)
              for k, v in b_stats["failover_total"].items()}
        check(stranded >= 1 and fo.get("resumed") == stranded
              and fo.get("exhausted", 0) == 0,
              f"fleet_tp (b): stranded {stranded}, outcomes {fo}")
        failed = [e["t"] for e in _events("serve_failover", replica="r0")
                  if e["t"] >= kill_t[0]]
        out = dict(
            nvidia_smi=smi, groups=2, tp=2, devices=list(FTP_DEVICES),
            backend="gloo", heads_per_rank=LM["n_heads"] // 2,
            note="four ranks share one card over gloo: step times are not "
                 "tp speed", requests=FLEET_REQUESTS,
            new_tokens=FLEET_NEW_TOKENS, spawn_s=spawn_s,
            spawn_to_ready_s=ready_s, a_wall_s=a_wall,
            a_dispatch=a_stats["dispatch_total"], launches=a_launch,
            decode_step_ms_p50=step_p50, peak_bytes=peaks,
            ttft_p50_ms=float(np.median(
                [o["info"]["ttft_ms"] for o in a_outs])),
            b_wall_s=b_wall, b_streams_bitwise_a=True,
            b_dispatch={k: v - before["dispatch_total"].get(k, 0)
                        for k, v in b_stats["dispatch_total"].items()},
            stranded=stranded, failover=fo,
            kill_to_detect_ms=(min(failed) - kill_t[0]) * 1e3 if failed
            else None,
            kill_to_resumed_token_ms=_resume_ms(kill_t[0], b_outs),
            kill_to_leader_exit_ms=(exit_t[0] - kill_t[0]) * 1e3)
    finally:
        router.shutdown(timeout=60)
        for c in clients:
            c.shutdown(drain=False, timeout=10)
    pids = [p for c in clients for p in c.pids]
    check(all(c.exited() for c in clients),
          f"fleet_tp: ranks outlived the shutdown: {pids}")
    emit("fleet_tp", **out, pids=pids)
    return launches


def _guard(fn, i, box) -> None:
    try:
        fn(i, box)
    except Exception as e:  # noqa: BLE001 — reported by the caller
        box["error"] = repr(e)


def _e2e_logits(model, device: str, seed: int):
    """The last prompt row's logits and E2E_STEPS decode steps' of an
    E2E_T-token prompt (from ``seed``) through the paged prefill and the
    paged decode step with ``kernel=True`` on ``device``: the kernels on
    the card, their plain versions on the CPU. f32 ``[1 + steps,
    vocab]`` on the CPU."""
    from horovod_tpu_torch.parallel.kv_blocks import (blocks_for,
                                                      init_paged_kv_cache,
                                                      paged_decode_step,
                                                      paged_prefill)
    from horovod_tpu_torch.parallel.transformer import gen_weights
    cfg = model.cfg
    T, steps = E2E_T, E2E_STEPS
    rng = np.random.RandomState(seed + 1)
    prompt = rng.randint(0, cfg.vocab, T).astype(np.int32)
    feed = rng.randint(0, cfg.vocab, steps).astype(np.int32)
    nb = blocks_for(T + steps, BLOCK)
    row = np.arange(1, nb + 1, dtype=np.int32)
    with torch.no_grad():
        w = gen_weights(model)
        cache = init_paged_kv_cache(cfg, nb + 1, BLOCK, 1, device=device)
        t = lambda a: torch.tensor(a, device=device)  # noqa: E731
        _, lg = paged_prefill(w, t(prompt), cache, 0, t(row), cfg)
        out = [lg[T - 1].float().cpu()]
        for i in range(steps):
            _, lg = paged_decode_step(
                w, t(feed[i:i + 1]), cache, t(np.array([T + i], np.int32)),
                t(row[None]), cfg, kernel=True)
            out.append(lg[0].float().cpu())
    return torch.stack(out)


def phase_e2e(model, seed: int):
    """A 256-token prompt + 4 decode steps through the same port
    functions on the card (kernels) and on the CPU (plain versions)."""
    T, steps = E2E_T, E2E_STEPS
    t0 = time.monotonic()
    card = _e2e_logits(model, "cuda", seed)
    card_s = time.monotonic() - t0
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.monotonic()
    cpu = _e2e_logits(cpu_model, "cpu", seed)
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


def lm_config(n_layers: int = LM["n_layers"]):
    """The bench LM, at full width; ``n_layers`` cuts its depth."""
    from horovod_tpu_torch.parallel.transformer import TransformerConfig
    return TransformerConfig(**dict(LM, n_layers=n_layers),
                             dtype=torch.bfloat16,
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
    """The full-width LM (E2E_LM_LAYERS deep) at batch 1, T=256 (tilable:
    the kernels run on the card), one step on the card and on the CPU
    (plain versions) from the same weights and batch."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.transformer import Transformer
    cfg = lm_config(E2E_LM_LAYERS)
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
    cosine = F.cosine_similarity(     # f64: 268 M terms
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
         grad_rel_l2={n: grad_err[n] for n in (
             "embed", "lnf", "layers.0.wqkv",
             f"layers.{cfg.n_layers - 1}.w2")},
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


def _pp_one_step(params, device, tokens, labels, cfg):
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
            cfg, create_hybrid_mesh(dp=1, pp=1), device=device)
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
    """One full-width pipelined step (E2E_LM_LAYERS deep) at batch 2 (2
    microbatches of 1), T=256 (tilable: the kernels run on the card),
    through the same entry points on the card and on the CPU (plain
    versions) from the same weights and batch."""
    from horovod_tpu_torch.parallel.pp_transformer import (init_pp_params,
                                                           named_leaves)
    cfg = lm_config(E2E_LM_LAYERS)
    params = init_pp_params(torch.Generator(device="cuda").manual_seed(
        seed + 2), cfg, 1, 0, device="cuda")
    before = {n: p.detach().float().cpu() for n, p in named_leaves(params)}
    tokens, labels = lm_batch(PP_E2E_BATCH, PP_E2E_SEQ, seed + 6)
    loss_card, g_card, p_card, launches, card_s = _pp_one_step(
        params, "cuda", tokens, labels, cfg)
    n = cfg.n_layers * PP_MICRO
    check(all(launches.get(k) == n for k in BHTD_KERNELS),
          f"e2e pp step did not run the [B,T,H,D] kernels: {launches}")
    loss_cpu, g_cpu, p_cpu, _, cpu_s = _pp_one_step(params, "cpu", tokens,
                                                    labels, cfg)
    del params

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    grad_err = {n: rel_l2(g_card[n], g_cpu[n]) for n in before}
    cosine = F.cosine_similarity(     # f64: 268 M terms
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


def _bench_in_process(args) -> tuple:
    """The bench entry's ``main(args)`` in this process (no world may be
    up: it builds and tears down its own): ``(lines, seconds)``."""
    from horovod_tpu_torch import bench, runtime
    check(not runtime.is_initialized(), "bench: a world is still up")
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    rc, lines, text = _run_entry(bench.main, args)
    secs = time.monotonic() - t0
    check(rc == 0, f"bench {args} exited {rc}: {text[-2000:]}")
    return lines, secs


def phase_bench(smi: str):
    """The bench entry's ``main`` in this process for each of BENCH_RUNS:
    every line named as expected, finite positive values, 0 < mfu <= 1,
    the knob fields, the peak bytes and the card; then the --scaling
    launcher world in a process of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    for args, names in BENCH_RUNS:
        lines, secs = _bench_in_process(args)
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
        if "images" in names[0]:
            check(lines[0]["conv_backend"] == "xla"
                  and 0 < lines[0]["phases"]["backward_share"] <= 1,
                  f"bench stock ResNet line {lines[0]}")
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
          and lines[1]["gpu"] == smi
          and lines[1]["conv_backend"] == "fused"
          and 0 < lines[1]["mfu"] <= 1
          and 0 < lines[1]["phases"]["backward_share"] <= 1,
          f"bench --scaling lines {lines}")


def _run_entry(main, argv) -> tuple:
    """An entry's ``main(argv)`` in this process, its standard output
    captured (and echoed to stderr for the log): ``(exit code, JSON lines,
    text)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    text = buf.getvalue()
    sys.stderr.write(text)
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    return rc, rows, text


def phase_serve_bench(smi: str) -> dict:
    """The serving bench entry on the card: two open-loop generate points
    of the bench LM, then a predict point (see the module docstring)."""
    from horovod_tpu_torch import serve_bench
    from horovod_tpu_torch.ops import LAUNCHES
    torch.cuda.empty_cache()
    LAUNCHES.reset()
    rc, rows, text = _run_entry(serve_bench.main, SB_GEN)
    launches = LAUNCHES.snapshot()
    check(rc == 0, f"serve_bench generate exited {rc}: {text[-2000:]}")
    check(len(rows) == 2, f"serve_bench printed {len(rows)} rows")
    low = rows[0]
    check(low["qps_target"] == 4.0
          and low["overload_drops"] + low["failed"] == 0,
          f"serve_bench dropped in-deadline requests at 4 qps: {low}")
    for r in rows:
        check(r["tokens_per_sec"] > 0 and r["completed"] > 0,
              f"serve_bench point {r['qps_target']}: no tokens")
        check(r["kv_layout"] == "paged"
              and (r["peak_bytes_per_chip"] or 0) > 0,
              f"serve_bench row {r}")
    layers = LM["n_layers"]
    k3 = launches.get("flash_attention", 0)
    k8 = launches.get("paged_decode_attention", 0)
    warm = int(re.search(r"decode \+ (\d+) prefill buckets",
                         text).group(1))
    done = sum(r["completed"] for r in rows)
    check(k3 > 0 and k3 % layers == 0 and k3 // layers >= done + warm,
          f"serve_bench: flash_attention launched {k3} times for {done} "
          f"requests + {warm} warmup prefills")
    check(k8 > 0 and k8 % layers == 0,
          f"serve_bench: paged_decode_attention launched {k8} times")
    emit("serve_bench", args=list(SB_GEN), exit=rc, launches=launches,
         prefills=k3 // layers, requests_completed=done,
         warmup_prefills=warm, decode_steps=k8 // layers, points=[{
             k: r[k] for k in ("qps_target", "sent", "completed",
                               "ttft_p50_ms", "ttft_p99_ms",
                               "ttft_hit_p50_ms", "ttft_cold_p50_ms",
                               "tokens_per_sec", "tps_user_p50",
                               "slot_fill", "peak_concurrent_streams",
                               "peak_bytes_per_chip", "overload_drops",
                               "deadline_drops", "failed")}
             for r in rows], gpu=smi)
    LAUNCHES.reset()
    rc, rows, text = _run_entry(serve_bench.main, SB_PREDICT)
    got = LAUNCHES.snapshot()
    check(rc == 0 and len(rows) == 1
          and rows[0]["completed"] == rows[0]["sent"] > 0,
          f"serve_bench predict: exit {rc}, rows {rows}")
    check(not got, f"serve_bench predict launched kernels: {got}")
    emit("serve_bench_predict", args=list(SB_PREDICT), exit=rc,
         row=rows[0], gpu=smi)
    return launches


def phase_profile_step(smi: str) -> dict:
    """The step profiler entry on the card: the LM's and the fused
    ResNet-50's tables (see the module docstring)."""
    from horovod_tpu_torch import profile_step
    from horovod_tpu_torch.ops import LAUNCHES
    total = {}
    for name, argv, kernels, perf_ms in PS_RUNS:
        torch.cuda.empty_cache()
        LAUNCHES.reset()
        rc, rows, text = _run_entry(profile_step.main, argv)
        launches = LAUNCHES.snapshot()
        check(rc == 0 and len(rows) == 1,
              f"profile_step {name}: exit {rc}: {text[-2000:]}")
        agg = rows[0]
        cats = agg["categories"]
        busy = agg["busy_ms_per_step"]
        check(agg["steps"] == 3, f"profile_step {name}: {agg['steps']} "
                                 f"steps in the trace")
        check(abs(sum(c["ms_per_step"] for c in cats.values()) - busy)
              <= 1e-6 * busy, f"profile_step {name}: categories do not "
                              f"sum to the busy total")
        check(0 < busy <= agg["step_wall_ms_mean"],
              f"profile_step {name}: busy {busy} ms a step against a "
              f"step wall of {agg['step_wall_ms_mean']} ms")
        for k in kernels:
            check(cats.get(k, {}).get("ms_per_step", 0) > 0,
                  f"profile_step {name}: no {k} time in {sorted(cats)}")
        first = next(iter(cats.items()))
        emit("profile_step", run=name, args=list(argv),
             busy_ms_per_step=busy,
             envelope_ms_per_step=agg["envelope_ms_per_step"],
             step_wall_ms_mean=agg["step_wall_ms_mean"],
             first_category={first[0]: first[1]},
             kernels={k: cats.get(k) for k in kernels},
             categories=cats, top_ops=agg["top_ops"][:8],
             perf_md_device_ms_per_step=perf_ms, launches=launches,
             gpu=smi)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


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


def elastic_worker(seed: int, launched: bool = True) -> int:
    """One rank of the elastic phase's launched world (``--elastic-worker``,
    started by ``python -m horovod_tpu_torch.launcher``), or with
    ``launched=False`` the same run in this process: the fused
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
    if launched:
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


def _elastic_in_process(root: str, seed: int) -> dict:
    """The elastic worker's clean run in this process (the reference the
    launched, killed and relaunched run must equal), its cuDNN settings
    and the variables it reads restored after it."""
    out_dir = os.path.join(root, "clean")
    os.makedirs(out_dir)
    env = {"HVD_SMOKE_OUT": out_dir,
           "HVD_ELASTIC_DIR": os.path.join(out_dir, "commits")}
    saved = {k: os.environ.get(k) for k in env}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    os.environ.update(env)
    t0 = time.time()
    try:
        check(elastic_worker(seed, launched=False) == 0,
              "elastic clean run failed")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(os.path.join(out_dir, "epoch0.json")) as f:
        rec = json.load(f)
    return dict(seconds=time.time() - t0, epochs={0: rec}, out_dir=out_dir)


def phase_elastic(seed: int):
    """The launcher and elastic recovery on the card at full width: a
    clean run in this process, a launched killed-and-relaunched run that
    must resume from EL_RESUME and end bitwise as the clean one, the time to
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
        clean = _elastic_in_process(root, seed)
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
                       in_process=True),
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
        max_slots=CK_SLOTS, max_len=MAX_LEN, kv_layout="paged",
        paged_kernel=True, block_size=BLOCK,
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
    cfg = lm_config(CK_LAYERS)
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
        serve_cfg = TransformerConfig(**dict(LM, n_layers=CK_LAYERS),
                                      dtype=torch.bfloat16,
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
        # engine_int8 (f): the int8 restore of the same checkpoint serves
        # the tokens of quantize_model applied to its f32 restore.
        t0 = time.monotonic()
        v8 = restore_for_inference(ckdir, dtype="int8")
        rfi8_ms = (time.monotonic() - t0) * 1e3
        builds = (("restored_int8", lambda: convert.params_from_jax(
                      v8["params"], serve_cfg)),
                  ("quantize_model", lambda: convert.quantize_model(
                      convert.params_from_jax(variables["params"],
                                              serve_cfg))))
        int8 = {}
        for name, build in builds:
            model = build()
            check(model.quantized, f"lm_ckpt {name}: not an int8 model")
            toks, launches, dsteps = _greedy_tokens(model, prompts)
            want_launches(launches, {
                "flash_attention": cfg.n_layers * len(prompts),
                "paged_decode_attention": cfg.n_layers * dsteps},
                f"lm_ckpt engine {name}")
            int8[name] = dict(tokens=toks, launches=launches,
                              decode_steps=dsteps)
            del model
            torch.cuda.empty_cache()
        del v8
        check(int8["restored_int8"]["tokens"]
              == int8["quantize_model"]["tokens"],
              "greedy tokens of the int8 restore differ from quantize_model "
              "of the f32 restore")
        out.update(checkpoint_bytes=nbytes, save_ms=save_ms,
                   save_mb_per_s=nbytes / 1e6 / (save_ms / 1e3),
                   verify_ms=verify_ms, restore_ms=restore_ms,
                   restore_for_inference_ms=rfi_ms,
                   restore_for_inference_files=len(opened),
                   restore_for_inference_int8_ms=rfi8_ms,
                   engine=runs, engine_int8=int8)
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
    """``save_sharded`` of a ZeRO state (2-D canonical form), restore
    (which verifies the manifest first; lm_ckpt_serve times
    ``verify_checkpoint`` at this size) into a fresh state from another
    seed (its parameters and shards bitwise the live ones), one more step
    from each (bitwise); ``infer(ckdir)`` checks the serving restore.
    Bytes and times."""
    import shutil
    import tempfile
    from horovod_tpu_torch.parallel.checkpoint import (restore_sharded,
                                                       save_sharded)

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
                restore_ms=restore_ms, resumed_bitwise=resumed, **extra)


def _leaf_list(params) -> list:
    """The parameters of a module or of the pipelined stages' dict."""
    from horovod_tpu_torch.parallel.pp_transformer import named_leaves
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return [t for _, t in named_leaves(params)]


def phase_lm_mesh_zero(seed: int, smi: str):
    """ZeRO-1 and overlap on the four-axis and the pipelined steps at
    full width and MZ_LAYERS deep on one-rank meshes naming every axis,
    bitwise their plain steps; the hybrid ZeRO checkpoints and the
    sharded serving restore."""
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
    cfg = lm_config(MZ_LAYERS)
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
         n_layers=MZ_LAYERS,
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


# The coord phase: two ranks sharing the card, the bench LM at full width
# cut to COORD_LAYERS layers and COORD_BATCH sequences of T=2048 a rank
# (two AdamW states on one card; its gloo gradient exchange moves every
# f32 gradient through the host each step).
COORD_LAYERS, COORD_BATCH, COORD_STEPS = 2, 1, 3
COORD_HEARTBEAT_S, COORD_KILL_SLACK_S = 10.0, 5.0
COORD_MISMATCH_S = 5.0
COORD_WORLD_S = 240.0          # the children's run, kill drill included
COORD_TIMING = ((4096, 10), (1 << 20, 5), (64 << 20, 3))    # bytes, reps
COORD_RING_ELEMS = 1 << 21     # 8 MiB of f32: above the 4 MiB threshold


def coord_inputs(rank: int, seed: int) -> dict:
    """(a)'s inputs of ``rank``: key -> (kind, host array, kwargs); bf16
    arrays are their raw bits (uint16)."""
    rng = np.random.RandomState(seed * 100 + rank)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def bf16(*shape):
        u = f32(*shape).view(np.uint32).astype(np.uint64)
        return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)

    def i32(*shape):
        return rng.randint(-1000, 1000, size=shape).astype(np.int32)

    big = COORD_RING_ELEMS
    return {
        "ar_f32_star": ("allreduce", f32(4099), dict(plane="star")),
        "ar_f32_ring": ("allreduce", f32(big), {}),
        "ar_bf16_star": ("allreduce", bf16(4099), dict(plane="star")),
        "ar_bf16_ring": ("allreduce", bf16(2 * big), {}),
        "ar_i32_star": ("allreduce", i32(4099), dict(plane="star")),
        "ar_i32_ring": ("allreduce", i32(big), {}),
        "ag_ragged": ("allgather", f32(3 * rank + 5, 64), {}),
        "bc_root1": ("broadcast", f32(1000), dict(root_rank=1)),
        "a2a": ("alltoall", f32(2 * 1024), {}),
        "rs": ("reducescatter", f32(2 * 1024), {}),
    }


def coord_reference(seed: int) -> dict:
    """(a)'s expected results on each rank, from both ranks' inputs on the
    host: f32 and int32 sums in numpy, bf16 sums widened to f32 and
    rounded to nearest even (the coordinator's rule), the rest moved."""
    ins = [coord_inputs(r, seed) for r in range(2)]
    out = [{}, {}]
    for key, (kind, _, kw) in ins[0].items():
        a, b = ins[0][key][1], ins[1][key][1]
        if kind == "allreduce" and a.dtype == np.uint16:
            f = ((a.astype(np.uint32) << 16).view(np.float32)
                 + (b.astype(np.uint32) << 16).view(np.float32))
            u = f.view(np.uint32).astype(np.uint64)
            want = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
            out[0][key] = out[1][key] = want
        elif kind == "allreduce":
            out[0][key] = out[1][key] = a + b
        elif kind == "allgather":
            out[0][key] = out[1][key] = np.concatenate([a, b])
        elif kind == "broadcast":
            out[0][key] = out[1][key] = ins[kw["root_rank"]][key][1]
        elif kind == "alltoall":
            h = a.shape[0] // 2
            out[0][key] = np.concatenate([a[:h], b[:h]])
            out[1][key] = np.concatenate([a[h:], b[h:]])
        else:
            s = a + b
            h = s.shape[0] // 2
            out[0][key], out[1][key] = s[:h], s[h:]
    return out


def _coord_eager(hvd, rank: int, seed: int, planes: bool) -> tuple:
    """(a) on this world: key -> host result (bf16 as bits), the result
    devices, and the calls that raised (the plain world's backend may not
    take every dtype or kind on CUDA tensors)."""
    results, devices, raised = {}, {}, {}
    for key, (kind, x, kw) in coord_inputs(rank, seed).items():
        kw = dict(kw) if planes else {
            k: v for k, v in kw.items() if k != "plane"}
        t = torch.from_numpy(x.copy())
        if x.dtype == np.uint16:
            t = t.view(torch.int16).view(torch.bfloat16)
        t = t.to("cuda")
        fn = getattr(hvd, kind)
        if kind in ("allreduce", "reducescatter"):
            kw["op"] = hvd.Op.SUM
        try:
            got = fn(t, name=f"coord.{key}", **kw)
        except Exception as e:  # noqa: BLE001 — reported, and checked
            raised[key] = f"{type(e).__name__}: {e}"[:300]
            continue
        devices[key] = got.device.type
        got = got.cpu()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        results[key] = got.numpy().view(x.dtype) if x.dtype == np.uint16 \
            else got.numpy()
    obj = hvd.broadcast_object({"rank": rank, "seed": seed, "s": "x" * (
        rank + 3)}, root_rank=0, name="coord.obj")
    results["object"] = np.frombuffer(json.dumps(
        obj, sort_keys=True).encode(), np.uint8)
    return results, devices, raised


def _coord_lm(hvd, seed: int, rank: int):
    """(b): the dp step of the full-width LM (COORD_LAYERS deep) for
    COORD_STEPS steps from the seed's weights, this rank's own batch; the
    step's loss is the world mean (``training._world_mean``, an eager
    allreduce) and each step number is resolved by ``broadcast_object``.
    Returns the state, the step, this rank's batch, the losses, the step
    seconds and the steps' launches."""
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.parallel.transformer import \
        make_parallel_train_step
    init_state, step = make_parallel_train_step(
        lm_config(COORD_LAYERS),
        functools.partial(torch.optim.AdamW, **ADAMW), device="cuda")
    state = init_state(seed)
    hvd.broadcast_parameters(state.model)
    tokens, labels = lm_batch(COORD_BATCH, LM_SEQ, seed + 1 + rank,
                              device="cuda")
    torch.cuda.synchronize()
    LAUNCHES.reset()
    losses, times = [], []
    for i in range(COORD_STEPS):
        t0 = time.monotonic()
        state, loss = step(state, tokens, labels)
        losses.append(loss.item())
        at = hvd.broadcast_object(int(state.step), root_rank=0,
                                  name=f"coord.step.{i}")
        check(at == state.step == i + 1,
              f"coord (b): step {state.step} resolved as {at}")
        times.append(time.monotonic() - t0)
    return state, step, (tokens, labels), losses, times, LAUNCHES.snapshot()


def _coord_timings(hvd) -> list:
    """(e): eager allreduce (SUM, f32 on the card) on each plane and size:
    the median over the reps of host-clock calls (staging included)."""
    rows = []
    for nbytes, reps in COORD_TIMING:
        x = torch.ones(nbytes // 4, device="cuda")
        for plane in ("star", "ring"):
            hvd.allreduce(x, average=False, plane=plane)
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hvd.allreduce(x, average=False, plane=plane)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            ms = float(np.median(ts)) * 1e3
            rows.append(dict(bytes=nbytes, plane=plane, reps=reps,
                             ms_p50=ms, gb_s=nbytes / ms / 1e6,
                             ms=[t * 1e3 for t in ts]))
    return rows


def coord_worker(rank: int, run_dir: str, ports: str, seed: int) -> int:
    """One rank of the coord phase (``--coord-rank``): a gloo group built
    here (both ranks on ``cuda:0``), adopted first by a plain world, then
    by a coordinated one. Writes ``rank<r>.json`` and ``rank<r>.npz`` in
    ``run_dir``; rank 1 ends SIGKILLed by its own timer, mid-step."""
    import datetime
    import faulthandler

    import torch.distributed as dist
    faulthandler.enable()       # a crash leaves its stack in the log
    torch.backends.cuda.matmul.allow_tf32 = False
    pg_port, coord_port = (int(p) for p in ports.split(","))

    def mark(what: str) -> None:
        print(f"coord rank {rank}: {what}", flush=True)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{pg_port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=COORD_WORLD_S))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import (FailedPreconditionError,
                                              WorkerFailureError)
    rec = {"rank": rank}
    arrays = {}

    def dump():
        np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)

    # The plain world: the process group alone.
    mark("plain world")
    hvd.init(device="cuda", coordinator=False)
    check(hvd.world().coord is None, "coord: the plain world has a plane")
    res, rec["plain_devices"], rec["plain_raised"] = _coord_eager(
        hvd, rank, seed, planes=False)
    arrays.update({f"plain.{k}": v for k, v in res.items()})
    mark(f"plain (a) done, raised {sorted(rec['plain_raised'])}")
    state, _, _, rec["plain_losses"], _, _ = _coord_lm(hvd, seed, rank)
    mark(f"plain (b) losses {rec['plain_losses']}")
    del state
    torch.cuda.empty_cache()
    hvd.shutdown()
    # The coordinated world on the same group.
    os.environ["HVD_COORD_ADDR"] = f"127.0.0.1:{coord_port}"
    t0 = time.monotonic()
    hvd.init(device="cuda", coordinator=True)
    rec["coord_init_s"] = time.monotonic() - t0
    coord = hvd.world().coord
    check(coord is not None, "coord: init(coordinator=True) has no plane")
    mark("coordinated world")
    ring0 = coord.ring_ops()
    res, rec["devices"], rec["raised"] = _coord_eager(hvd, rank, seed,
                                                      planes=True)
    rec["ring_ops"] = coord.ring_ops() - ring0
    arrays.update({f"coord.{k}": v for k, v in res.items()})
    torch.cuda.reset_peak_memory_stats()
    state, step, batch, rec["losses"], times, rec["launches"] = _coord_lm(
        hvd, seed, rank)
    mark(f"coordinated (b) losses {rec['losses']}")
    rec["step_ms"] = [t * 1e3 for t in times]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    # (c) the mismatch drill.
    t0 = time.monotonic()
    try:
        hvd.allreduce(torch.zeros(rank + 1, device="cuda"),
                      name="coord.drill.shape")
        rec["mismatch"] = "no error"
    except FailedPreconditionError as e:
        rec["mismatch"] = str(e)
    rec["mismatch_s"] = time.monotonic() - t0
    rec["timing"] = _coord_timings(hvd)
    mark("(c), (e) done")
    # (d) the kill drill: rank 1 SIGKILLs itself halfway into a step.
    kill_file = os.path.join(run_dir, "killed_at")
    delay = float(np.median(times)) / 2
    if rank == 1:
        dump()

        def kill():
            with open(kill_file, "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
        threading.Timer(delay, kill).start()
        step(state, *batch)
        time.sleep(COORD_WORLD_S)         # the timer fires first
        return 3
    try:
        step(state, *batch)
        rec["kill"] = "no error"
    except WorkerFailureError as e:
        rec["kill"] = str(e)
    seen = time.time()
    with open(kill_file) as f:
        rec["kill_detect_s"] = seen - float(f.read())
    rec["kill_delay_s"] = delay
    dump()
    # The group's peer is dead: leave without a teardown that could wait
    # on it.
    os._exit(0)


def phase_coord(seed: int, smi: str) -> dict:
    """The coord phase (see the module docstring, 16a). Returns the
    coordinated LM steps' launches, both ranks'."""
    import shutil
    import socket
    import tempfile
    from horovod_tpu_torch.coord import _build as cbuild
    t0 = time.monotonic()
    lib = cbuild.build()
    build_s = time.monotonic() - t0
    here = os.path.dirname(os.path.abspath(__file__))
    run_dir = tempfile.mkdtemp(prefix="hvd-coord-")
    ports = []
    for _ in range(2):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    env = dict(os.environ, HVD_FLIGHTREC_DIR=run_dir,
               HVD_HEARTBEAT_TIMEOUT=str(COORD_HEARTBEAT_S),
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_FAULT_SPEC",
              "HVD_COORD_ADDR", "HOROVOD_RING_THRESHOLD", "HOROVOD_TIMELINE"):
        env.pop(k, None)
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for r in range(2):
            log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--coord-rank",
                 str(r), "--coord-dir", run_dir, "--coord-ports",
                 ",".join(map(str, ports)), "--seed", str(seed)],
                cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = t0 + COORD_WORLD_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    world_s = time.monotonic() - t0
    try:
        def tail(r):
            with open(os.path.join(run_dir, f"rank{r}.log")) as f:
                return f.read()[-4000:]
        check(procs[0].returncode == 0,
              f"coord: rank 0 exited {procs[0].returncode}:\n{tail(0)}\n"
              f"rank 1:\n{tail(1)}")
        check(procs[1].returncode == -signal.SIGKILL,
              f"coord: rank 1 exited {procs[1].returncode} (expected its "
              f"own SIGKILL):\n{tail(1)}")
        recs, arrs = [], []
        for r in range(2):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
            with np.load(os.path.join(run_dir, f"rank{r}.npz")) as z:
                arrs.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    # (a)
    want = coord_reference(seed)
    plain_missing = sorted(set(recs[0]["plain_raised"])
                           | set(recs[1]["plain_raised"]))
    for r in range(2):
        rec, arr = recs[r], arrs[r]
        check(not rec["raised"], f"coord (a) rank {r}: {rec['raised']}")
        for key, w in want[r].items():
            got = arr[f"coord.{key}"]
            check(got.dtype == w.dtype and got.shape == w.shape
                  and got.tobytes() == w.tobytes(),
                  f"coord (a) rank {r}: {key} is not the host reference")
            check(rec["devices"][key] == "cuda",
                  f"coord (a) rank {r}: {key} came back on "
                  f"{rec['devices'][key]}")
            if key not in plain_missing:
                check(arr[f"plain.{key}"].tobytes() == got.tobytes(),
                      f"coord (a) rank {r}: {key} differs from the plain "
                      f"world's")
        check(arr["coord.object"].tobytes() == arrs[0][
            "plain.object"].tobytes(), "coord (a): broadcast_object")
        check(json.loads(arr["coord.object"].tobytes())["rank"] == 0,
              "coord (a): broadcast_object is not rank 0's")
        check(rec["ring_ops"] == 3, f"coord (a) rank {r}: {rec['ring_ops']} "
                                    f"ring ops, expected 3")
    emit("coord_eager", ops=sorted(want[0]), ring_ops=recs[0]["ring_ops"],
         plain_unsupported={k: recs[0]["plain_raised"].get(
             k, recs[1]["plain_raised"].get(k)) for k in plain_missing},
         coord_init_s=[rec["coord_init_s"] for rec in recs],
         build_s=build_s, library=os.path.basename(lib))
    # (b)
    for r in range(2):
        rec = recs[r]
        check(rec["losses"] == rec["plain_losses"],
              f"coord (b) rank {r}: losses {rec['losses']} are not the "
              f"plain world's {rec['plain_losses']}")
        check(all(np.isfinite(rec["losses"])), "coord (b): loss not finite")
        for name in ATTN_KERNELS:
            n = rec["launches"].get(name, 0)
            check(n == COORD_LAYERS * COORD_STEPS,
                  f"coord (b) rank {r}: {name} launched {n} times; "
                  f"expected {COORD_LAYERS} x {COORD_STEPS}")
    check(recs[0]["losses"] == recs[1]["losses"],
          "coord (b): the ranks' world-mean losses differ")
    emit("coord_lm", layers=COORD_LAYERS, batch_per_rank=COORD_BATCH,
         seq=LM_SEQ, steps=COORD_STEPS, losses=recs[0]["losses"],
         plain_losses=recs[0]["plain_losses"],
         step_ms=[rec["step_ms"] for rec in recs],
         peak_bytes=[rec["peak_bytes"] for rec in recs],
         launches=[rec["launches"] for rec in recs])
    # (c), (d)
    for r in range(2):
        check(recs[r]["mismatch"].startswith(
            "Mismatched ALLREDUCE tensor shapes"),
            f"coord (c) rank {r}: {recs[r]['mismatch']}")
        check(recs[r]["mismatch_s"] < COORD_MISMATCH_S,
              f"coord (c) rank {r}: {recs[r]['mismatch_s']:.2f} s")
    kill = recs[0]["kill"]
    check(kill.startswith("worker failure: rank 1 "),
          f"coord (d): rank 0 saw {kill!r}")
    check(recs[0]["kill_detect_s"] < COORD_HEARTBEAT_S + COORD_KILL_SLACK_S,
          f"coord (d): {recs[0]['kill_detect_s']:.2f} s to the error")
    emit("coord_drills", mismatch_s=[rec["mismatch_s"] for rec in recs],
         mismatch=recs[0]["mismatch"][:200],
         kill_delay_s=recs[0]["kill_delay_s"],
         kill_detect_s=recs[0]["kill_detect_s"], kill=kill[:300],
         heartbeat_timeout_s=COORD_HEARTBEAT_S,
         bound_s=COORD_HEARTBEAT_S + COORD_KILL_SLACK_S)
    # (e)
    emit("coord_timing", rows=[{k: v for k, v in row.items() if k != "ms"}
                               for row in recs[0]["timing"]],
         staged="CUDA tensors staged to host bytes and back", card=smi,
         world_s=world_s)
    out = {}
    for rec in recs:
        for name in ATTN_KERNELS:
            out[name] = out.get(name, 0) + rec["launches"].get(name, 0)
    return out


# The models phase (see the module docstring, 32).

def _bench_line_checks(name: str, line: dict, smi: str) -> None:
    check(line["metric"] == f"{name}_synthetic_images_per_sec_per_gpu",
          f"models: {name} printed {line['metric']}")
    check(np.isfinite(line["value"]) and line["value"] > 0
          and line["vs_baseline"] > 0, f"models: {name} value {line}")
    check(0 < line["mfu"] <= 1 and line["tflops_per_gpu"] > 0,
          f"models: {name} mfu {line}")
    check(isinstance(line["peak_bytes_per_gpu"], int)
          and line["peak_bytes_per_gpu"] > 0, f"models: {name} peak {line}")
    check(line["gpu"] == smi, f"models: {name} card {line['gpu']} vs {smi}")
    check(line["world"] == 1 and line["mesh"] == "dp1",
          f"models: {name} world {line}")


def _bench_passes(cfg: dict) -> int:
    """Forward-backward passes of one bench line (``bench.measure``):
    warmup and the timed regions, then ``_measure_phases``' two medians
    of one untimed and ``max(3, iters)`` timed passes each."""
    k = cfg["steps_per_call"]
    return ((cfg["warmup"] + cfg["iters"] * cfg["rounds"]) * k
            + 2 * (1 + max(3, cfg["iters"])))


def _models_bench(smi: str) -> dict:
    """models (a); returns the resnet101 run's launches."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.ops import LAUNCHES
    kept = {}
    for name, args in MD_BENCH:
        LAUNCHES.reset()
        lines, secs = _bench_in_process(args)
        launches = LAUNCHES.snapshot()
        check(len(lines) == 1, f"models: {name} printed {len(lines)} lines")
        line = lines[0]
        _bench_line_checks(name, line, smi)
        cfg = dict(bench._GPU_CONFIGS[name], rounds=1)
        if name == "resnet101":
            check(line["conv_backend"] == "fused",
                  f"models: resnet101 line {line}")
            want = RN_SITES * _bench_passes(cfg)
            want_launches(launches, {"fused_conv_bn_fwd": want,
                                     "fused_conv_bn_bwd": want},
                          "models: bench resnet101 fused")
            kept = launches
        else:
            check(not launches, f"models: {name} launched {launches}")
        emit("models_bench", model=name, args=list(args), seconds=secs,
             passes=_bench_passes(cfg), launches=launches, line=line)
        torch.cuda.empty_cache()
    return kept


def _step_grads(model, x, y):
    """One training forward + backward (no optimizer): loss (mean cross
    entropy in the logits' dtype), logits and each parameter's gradient
    on the host."""
    model.zero_grad(set_to_none=True)
    logits = model(x, train=True)
    loss = F.cross_entropy(logits, y.long())
    loss.backward()
    return (loss.item(), logits.detach().float().cpu(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def _rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref|; 0 where both are all zero."""
    d = (got.double() - ref.double()).abs().max().item()
    m = ref.double().abs().max().item()
    return d / m if m > 0 else d


def _models_rn101(seed: int) -> dict:
    """models (b): ResNet-101 fused, one SGD step, card vs CPU."""
    from horovod_tpu_torch.models import resnet101
    from horovod_tpu_torch.ops import LAUNCHES
    card = resnet101(RN_CLASSES, conv_backend="fused", device="cuda",
                     generator=torch.Generator().manual_seed(seed + 5))
    cpu = copy.deepcopy(card).to("cpu")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    rng = np.random.RandomState(seed + 6)
    xs = rng.standard_normal((MD_RN101_BATCH, MD_RN101_IMAGE,
                              MD_RN101_IMAGE, 3)).astype(np.float32)
    ys = rng.randint(0, RN_CLASSES, size=(MD_RN101_BATCH,))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    LAUNCHES.reset()
    loss_card, logits_card = _one_step(card, x.cuda(), y.cuda())
    launches = LAUNCHES.snapshot()
    want_launches(launches, {"fused_conv_bn_fwd": RN_SITES,
                             "fused_conv_bn_bwd": RN_SITES},
                  "models (b): the ResNet-101 step")
    loss_cpu, logits_cpu = _one_step(cpu, x, y)
    check(bool(torch.isfinite(logits_card).all()), "models (b): logits")
    cp, pp = dict(card.named_parameters()), dict(cpu.named_parameters())
    cb, pb = dict(card.named_buffers()), dict(cpu.named_buffers())
    rel = lambda a, b: _rel_err(a.detach().cpu(), b.detach())  # noqa: E731
    diffs = {"loss": abs(loss_card - loss_cpu),
             "logits": (logits_card - logits_cpu).abs().max().item(),
             "param_updates": {n: rel(cp[n].cpu() - before[n],
                                      pp[n] - before[n])
                               for n in MD_RN101_PARAMS},
             "batch_stats": {n: rel(cb[n], pb[n]) for n in MD_RN101_STATS}}
    upd_card = torch.cat([(cp[n].detach().cpu() - before[n]).flatten()
                          for n in before])
    upd_cpu = torch.cat([(pp[n].detach() - before[n]).flatten()
                         for n in before])
    cosine = F.cosine_similarity(upd_card, upd_cpu, dim=0).item()
    rec = dict(batch=MD_RN101_BATCH, image=MD_RN101_IMAGE,
               loss_card=loss_card, loss_cpu=loss_cpu, diffs=diffs,
               update_cosine=cosine, launches=launches,
               tolerance=TOL_E2E_TRAIN)
    check(diffs["loss"] <= TOL_E2E_TRAIN["loss"],
          f"models (b): loss differs by {diffs['loss']}")
    check(diffs["logits"] <= TOL_E2E_TRAIN["logits"],
          f"models (b): logits differ by {diffs['logits']}")
    check(cosine >= TOL_E2E_TRAIN["update_cosine"],
          f"models (b): update cosine {cosine}")
    for key in ("param_updates", "batch_stats"):
        for n, v in diffs[key].items():
            check(v <= TOL_E2E_TRAIN[key], f"models (b): {n} differs by {v}")
    return rec


def _family_model(name: str, seed: int, hw: int, dtype: torch.dtype):
    """models (c)'s model on the CPU, dropout off, computing in ``dtype``
    (f64: every parameter cast and the head too, so no f32 rounding of
    the logits, card's and CPU's in other orders, enters the gradients)."""
    from horovod_tpu_torch import models
    gen = torch.Generator().manual_seed(seed)
    if name == "vgg16":
        m = models.vgg16(RN_CLASSES, dtype=dtype, dropout_rate=0.0,
                         image_size=hw, device="cpu", generator=gen)
    elif name == "inception3":
        m = models.inception_v3(RN_CLASSES, dtype=dtype, dropout_rate=0.0,
                                device="cpu", generator=gen)
    elif name == "cifar_resnet_v2_56":
        m = models.cifar_resnet_v2(56, dtype=dtype, device="cpu",
                                   generator=gen)
    else:
        m = models.resnet50(RN_CLASSES, dtype=dtype, stem_space_to_depth=True,
                            device="cpu", generator=gen)
    m.head.dtype = dtype
    return m.to(dtype)


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _family_run(name: str, seed: int, hw: int, x, y,
                dtype: torch.dtype) -> dict:
    """One train forward + backward of a family model on the card and on
    the CPU from the same weights, in ``dtype``: relative errors."""
    from horovod_tpu_torch.ops import LAUNCHES
    cpu = _family_model(name, seed, hw, dtype)
    card = copy.deepcopy(cpu).to("cuda")
    x = x.to(dtype)
    LAUNCHES.reset()
    with _no_tf32():
        loss_card, logits_card, g_card = _step_grads(card, x.cuda(),
                                                     y.cuda())
    launches = LAUNCHES.snapshot()
    t0 = time.monotonic()
    loss_cpu, logits_cpu, g_cpu = _step_grads(cpu, x, y)
    cpu_s = time.monotonic() - t0
    check(not launches, f"models (c): {name} launched {launches}")
    check(bool(torch.isfinite(logits_card).all()),
          f"models (c): {name} logits not finite")
    grads = {n: _rel_max(g_card[n], g_cpu[n]) for n in g_cpu}
    cb, pb = dict(card.named_buffers()), dict(cpu.named_buffers())
    stats = [_rel_max(cb[n].cpu(), pb[n]) for n in pb]
    flat = lambda g: torch.cat([t.double().flatten()  # noqa: E731
                                for t in g.values()])
    worst = max(grads, key=grads.get)
    return dict(params=sum(p.numel() for p in cpu.parameters()),
                loss_card=loss_card, loss_cpu=loss_cpu,
                loss=abs(loss_card - loss_cpu) / abs(loss_cpu),
                logits=_rel_max(logits_card, logits_cpu),
                grads_worst={worst: grads[worst]},
                batch_stats_worst=max(stats) if stats else 0.0,
                grad_cosine=F.cosine_similarity(flat(g_card), flat(g_cpu),
                                                dim=0).item(),
                cpu_s=cpu_s)


def _models_family(seed: int) -> list:
    """models (c): each family, card vs CPU: the forward (loss, logits,
    running statistics) and the gradients' cosine in f32, every gradient
    leaf in f64."""
    out = []
    for i, (name, hw, batch) in enumerate(MD_FAMILY):
        rng = np.random.RandomState(seed + 30 + i)
        x = torch.from_numpy(rng.standard_normal(
            (batch, hw, hw, 3)).astype(np.float32))
        classes = 10 if name.startswith("cifar") else RN_CLASSES
        y = torch.from_numpy(rng.randint(0, classes, size=(batch,)))
        f32 = _family_run(name, seed + 20 + i, hw, x, y, torch.float32)
        f64 = _family_run(name, seed + 20 + i, hw, x, y, torch.float64)
        rec = dict(model=name, image=hw, batch=batch, f32=f32, f64=f64)
        emit("models_family", **rec, tolerance=TOL_FAMILY)
        for key in ("loss", "logits", "batch_stats_worst"):
            tol = TOL_FAMILY["batch_stats" if key.startswith("batch")
                             else key]
            check(f32[key] <= tol,
                  f"models (c): {name} f32 {key} differs by {f32[key]}")
        check(f32["grad_cosine"] >= TOL_E2E_TRAIN["update_cosine"],
              f"models (c): {name} f32 gradient cosine "
              f"{f32['grad_cosine']}")
        (leaf, err), = f64["grads_worst"].items()
        check(err <= TOL_FAMILY["grads"],
              f"models (c): {name} f64 gradient of {leaf} differs by {err}")
        check(f64["grad_cosine"] >= TOL_FAMILY["grad_cosine"],
              f"models (c): {name} f64 gradient cosine "
              f"{f64['grad_cosine']}")
        out.append(rec)
        torch.cuda.empty_cache()
    return out


def phase_models(seed: int, smi: str) -> dict:
    """The models phase (see the module docstring, 32). Returns the bench
    resnet101 run's launches (the kernels line's totals)."""
    launches = _models_bench(smi)
    emit("models_rn101", **_models_rn101(seed))
    _models_family(seed)
    torch.cuda.empty_cache()
    return launches


# The sync_bn phase (see the module docstring, 33).

def sync_bn_batch(name: str, seed: int):
    """The global batch of SB_BATCH: the second half shifted and scaled,
    so the ranks' halves have other statistics."""
    hw = 32 if name == "f32" else 64
    rng = np.random.RandomState(seed + 40)
    x = rng.standard_normal((SB_BATCH, hw, hw, 3)).astype(np.float32)
    x[SB_BATCH // 2:] = 1.5 * x[SB_BATCH // 2:] + 0.5
    return x, rng.randint(0, 10, size=(SB_BATCH,))


def sync_bn_model(name: str, seed: int, axis_name):
    """cifar_resnet_v1(20) in f32, or ResNet-50 fused (bf16), on the card
    from the seed."""
    from horovod_tpu_torch.models import cifar_resnet_v1, resnet50
    gen = torch.Generator().manual_seed(seed + 41)
    if name == "f32":
        return cifar_resnet_v1(20, dtype=torch.float32, axis_name=axis_name,
                               device="cuda", generator=gen)
    return resnet50(10, conv_backend="fused", axis_name=axis_name,
                    device="cuda", generator=gen)


def _sb_record(model, x_all) -> dict:
    """A run's params, running statistics and whole-batch eval logits."""
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x_all).cuda(), train=False)
    rec = {f"p.{n}": p.detach().float().cpu().numpy().copy()
           for n, p in model.named_parameters()}
    rec.update({f"b.{n}": b.detach().float().cpu().numpy().copy()
                for n, b in model.named_buffers()})
    rec["logits"] = logits.float().cpu().numpy()
    return rec


def sync_bn_worker(rank: int, run_dir: str, port: int, seed: int) -> int:
    """One rank of the sync_bn phase (``--sync-bn-rank``): a gloo group
    built here (both ranks on ``cuda:0``), adopted by ``hvd.init``; each
    model trained SB_STEPS steps on this rank's half with
    ``axis_name=hvd.AXIS``, then with local BatchNorm. Writes
    ``rank<r>.json`` and ``rank<r>.npz`` in ``run_dir``."""
    import datetime
    import faulthandler

    import torch.distributed as dist
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=SB_WORLD_S))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import LAUNCHES
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)
    hvd.init(device="cuda")
    check(hvd.size() == 2 and hvd.rank() == rank, "sync_bn: the world")
    rec, arrays = {}, {}
    n = SB_BATCH // 2
    for name in ("f32", "bf16"):
        x, y = sync_bn_batch(name, seed)
        xs = torch.from_numpy(x[rank * n:(rank + 1) * n]).cuda()
        ys = torch.from_numpy(y[rank * n:(rank + 1) * n]).cuda()
        for tag, axis in (("sync", hvd.AXIS), ("local", None)):
            model = sync_bn_model(name, seed, axis)
            state = create_train_state(model, functools.partial(
                torch.optim.SGD, lr=0.1, momentum=0.9),
                device=hvd.runtime.device())
            step = make_train_step()
            LAUNCHES.reset()
            losses = []
            for _ in range(SB_STEPS):
                state, metrics = step(state, (xs, ys))
                losses.append(metrics["loss"].item())
            rec[f"{name}.{tag}"] = {"losses": losses,
                                    "launches": LAUNCHES.snapshot()}
            arrays.update({f"{name}.{tag}.{k}": v for k, v in
                           _sb_record(model, x).items()})
            del state, model
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def sync_bn_reference(seed: int) -> dict:
    """One card process training on the whole batch (local BatchNorm,
    plain SGD): what both ranks' cross-replica run must reproduce."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.training import cross_entropy_loss
    out = {}
    with _no_tf32():
        for name in ("f32", "bf16"):
            x, y = sync_bn_batch(name, seed)
            model = sync_bn_model(name, seed, None)
            init = {n: p.detach().float().cpu().numpy().copy()
                    for n, p in model.named_parameters()}
            opt = torch.optim.SGD([p for _, p in
                                   convert.jax_leaf_order(model)],
                                  lr=0.1, momentum=0.9)
            xa, ya = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
            losses = []
            for _ in range(SB_STEPS):
                opt.zero_grad(set_to_none=True)
                loss = cross_entropy_loss(model(xa, train=True), ya)
                loss.backward()
                opt.step()
                losses.append(loss.item())
            out[name] = dict(_sb_record(model, x), losses=losses, init=init)
    return out


def _sb_errors(got: dict, ref: dict, prefix: str) -> dict:
    """Relative errors of one run (``prefix``'s arrays in ``got``)
    against the reference."""
    params = [k[2:] for k in ref if k.startswith("p.")]
    stats = [k[2:] for k in ref if k.startswith("b.")]
    g = lambda k: got[f"{prefix}.{k}"]  # noqa: E731
    upd_got = np.concatenate([(g(f"p.{k}") - ref["init"][k]).ravel()
                              for k in params]).astype(np.float64)
    upd_ref = np.concatenate([(ref[f"p.{k}"] - ref["init"][k]).ravel()
                              for k in params]).astype(np.float64)
    cos = float(upd_got @ upd_ref / (np.linalg.norm(upd_got)
                                     * np.linalg.norm(upd_ref)))

    def rel(a, b):
        m = np.abs(b).max()
        d = np.abs(a - b).max()
        return float(d / m) if m > 0 else float(d)
    return {"params": max(rel(g(f"p.{k}"), ref[f"p.{k}"]) for k in params),
            "batch_stats": max(rel(g(f"b.{k}"), ref[f"b.{k}"])
                               for k in stats),
            "logits": rel(g("logits"), ref["logits"]),
            "update_cosine": cos}


def phase_sync_bn(seed: int, smi: str) -> dict:
    """The sync_bn phase (see the module docstring, 33). Returns the
    fused model's launches, both ranks' cross-replica runs."""
    import shutil
    import socket
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    run_dir = tempfile.mkdtemp(prefix="hvd-sync-bn-")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_COORD_ADDR",
              "HVD_FAULT_SPEC", "HOROVOD_TIMELINE"):
        env.pop(k, None)
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for r in range(2):
            log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--sync-bn-rank", str(r), "--sync-bn-dir", run_dir,
                 "--sync-bn-port", str(port), "--seed", str(seed)],
                cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT))
        # The whole-batch reference runs while the ranks start.
        ref = sync_bn_reference(seed)
        deadline = t0 + SB_WORLD_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    world_s = time.monotonic() - t0
    try:
        def tail(r):
            with open(os.path.join(run_dir, f"rank{r}.log")) as f:
                return f.read()[-4000:]
        for r in range(2):
            check(procs[r].returncode == 0,
                  f"sync_bn: rank {r} exited {procs[r].returncode}:\n"
                  f"{tail(r)}")
        recs, arrs = [], []
        for r in range(2):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
            with np.load(os.path.join(run_dir, f"rank{r}.npz")) as z:
                arrs.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    launches = {}
    for name in ("f32", "bf16"):
        tol, want = TOL_SYNC[name], ref[name]
        # Both ranks' cross-replica runs are one replicated state.
        differ = [k for k in arrs[0] if k.startswith(f"{name}.sync.")
                  and not np.array_equal(arrs[0][k], arrs[1][k])]
        check(not differ, f"sync_bn {name}: the ranks' runs differ in "
                          f"{differ[:4]}")
        errs = {tag: _sb_errors(arrs[0], want, f"{name}.{tag}")
                for tag in ("sync", "local")}
        loss_err = {tag: max(abs(a - b) / abs(b) for a, b in zip(
            recs[0][f"{name}.{tag}"]["losses"], want["losses"]))
            for tag in ("sync", "local")}
        for tag in ("sync", "local"):
            errs[tag]["loss"] = loss_err[tag]
        got_l = [recs[r][f"{name}.sync"]["launches"] for r in range(2)]
        emit("sync_bn", model=("cifar_resnet_v1(20) f32" if name == "f32"
                               else "resnet50 fused bf16"),
             global_batch=SB_BATCH, steps=SB_STEPS, world_s=world_s,
             losses_ref=want["losses"],
             losses=recs[0][f"{name}.sync"]["losses"],
             losses_local=recs[0][f"{name}.local"]["losses"],
             errors=errs["sync"], control_errors=errs["local"],
             tolerance=tol, launches=got_l, gpu=smi)
        e = errs["sync"]
        for key in ("loss", "batch_stats", "logits"):
            check(e[key] <= tol[key], f"sync_bn {name}: {key} differs from "
                                      f"the whole batch by {e[key]}")
        if name == "f32":
            check(e["params"] <= tol["params"],
                  f"sync_bn f32: params differ by {e['params']}")
        check(e["update_cosine"] >= tol["update_cosine"],
              f"sync_bn {name}: update cosine {e['update_cosine']}")
        c = errs["local"]
        check(c["batch_stats"] > tol["batch_stats"]
              and c["logits"] > tol["logits"],
              f"sync_bn {name}: the local-BN control matches the whole "
              f"batch ({c})")
        if name == "bf16":
            for r, got in enumerate(got_l):
                want_launches(got, {"fused_conv_bn_fwd": RN_SITES * SB_STEPS,
                                    "fused_conv_bn_bwd": RN_SITES * SB_STEPS},
                              f"sync_bn: rank {r}'s fused steps")
            for k, v in got_l[0].items():
                launches[k] = launches.get(k, 0) + v + got_l[1].get(k, 0)
    return launches


# The conv_examples phase (see the module docstring, 34).

def phase_conv_examples(smi: str) -> None:
    """The imagenet example under the launcher, then resumed."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    ck = tempfile.mkdtemp(prefix="hvd-ex-")
    env = dict(os.environ, HVD_DATA_DIR="", PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_COORD_ADDR",
              "HVD_FAULT_SPEC", "HOROVOD_TIMELINE"):
        env.pop(k, None)
    runs = []
    try:
        for epochs in (2, 3):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np",
                 "1", sys.executable, "-m",
                 "horovod_tpu_torch.examples.imagenet_resnet50", *EX_ARGS,
                 "--epochs", str(epochs), "--ckpt-dir", ck],
                cwd=here, env=env, capture_output=True, text=True,
                timeout=EX_TIMEOUT)
            secs = time.monotonic() - t0
            check(proc.returncode == 0,
                  f"conv_examples --epochs {epochs} exited "
                  f"{proc.returncode}: {proc.stdout[-2000:]}"
                  f"{proc.stderr[-3000:]}")
            out = proc.stdout
            acc = re.search(r"final eval accuracy \(allreduced\): (\S+)",
                            out)
            check(acc is not None and 0.0 <= float(acc.group(1)) <= 1.0,
                  f"conv_examples: no final eval in {out[-2000:]}")
            epoch_lines = [ln for ln in out.splitlines()
                           if ln.startswith("epoch ")]
            runs.append(dict(epochs=epochs, seconds=secs,
                             checkpoints=sorted(os.listdir(ck)),
                             epoch_lines=epoch_lines,
                             final_eval=float(acc.group(1))))
        # 256 synthetic images at a global batch of 32: 8 steps an epoch.
        check(runs[0]["checkpoints"] == ["ckpt_16", "ckpt_8"]
              and "resumed" not in " ".join(runs[0]["epoch_lines"]),
              f"conv_examples: first run {runs[0]}")
        check(runs[1]["checkpoints"] == ["ckpt_16", "ckpt_24", "ckpt_8"],
              f"conv_examples: resumed run {runs[1]}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check("resumed from step 16 (epoch 2)" in proc.stdout
          and [ln.split()[1] for ln in runs[1]["epoch_lines"]] == ["3/3"],
          f"conv_examples: the relaunch did not resume: {proc.stdout[-2000:]}")
    emit("conv_examples", args=list(EX_ARGS), runs=runs, gpu=smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--elastic-worker", action="store_true",
                    help="run as one rank of the elastic phase's launched "
                         "world (started by the launcher, not by hand)")
    ap.add_argument("--serve-tp-rank", type=int, default=None,
                    help="run as this rank of the serve_tp phase's tp=2 "
                         "world (started by the phase, not by hand)")
    ap.add_argument("--serve-tp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-tp-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coord-rank", type=int, default=None,
                    help="run as this rank of the coord phase's world of "
                         "2 (started by the phase, not by hand)")
    ap.add_argument("--coord-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coord-ports", default="", help=argparse.SUPPRESS)
    ap.add_argument("--sync-bn-rank", type=int, default=None,
                    help="run as this rank of the sync_bn phase's world of "
                         "2 (started by the phase, not by hand)")
    ap.add_argument("--sync-bn-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sync-bn-port", type=int, default=0,
                    help=argparse.SUPPRESS)
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
    if args.serve_tp_rank is not None:
        return serve_tp_worker(args.serve_tp_rank, args.serve_tp_dir,
                               args.serve_tp_port, args.seed)
    if args.coord_rank is not None:
        return coord_worker(args.coord_rank, args.coord_dir,
                            args.coord_ports, args.seed)
    if args.sync_bn_rank is not None:
        return sync_bn_worker(args.sync_bn_rank, args.sync_bn_dir,
                              args.sync_bn_port, args.seed)
    errs, launches, times = {}, {}, {}

    def add(got: dict) -> None:
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    try:
        smi = run_phase("device", phase_device)
        peaks = peaks_for(smi)
        run_phase("build", phase_build)
        errs.update(run_phase("parity", phase_parity, args.seed))
        model = build_model(args.seed)
        add(run_phase("engine", phase_engine, model, args.seed))
        run_phase("e2e", phase_e2e, model, args.seed)
        add(run_phase("engine_kv", phase_engine_kv, model, args.seed))
        add(run_phase("engine_lora", phase_engine_lora, model, args.seed))
        run_phase("routing", phase_routing, model, args.seed)
        int8_eng, got = run_phase("engine_int8", phase_engine_int8, model,
                                  args.seed)
        add(got)
        torch.cuda.empty_cache()
        run_phase("serve_single", phase_serve_single, int8_eng, args.seed)
        del int8_eng
        add(run_phase("fleet", phase_fleet, model, args.seed, smi))
        add(run_phase("serve_tp", phase_serve_tp, model, args.seed, peaks))
        add(run_phase("fleet_tp", phase_fleet_tp, args.seed, smi))
        del model
        torch.cuda.empty_cache()
        times.update(run_phase("timing", phase_timing, args.seed, peaks))
        errs.update(run_phase("parity_conv", phase_parity_conv, args.seed))
        launches.update(run_phase("train", phase_train, args.seed))
        run_phase("e2e_train", phase_e2e_train, args.seed)
        times.update(run_phase("timing_conv", phase_timing_conv, args.seed,
                               peaks))
        run_phase("parity_attn", phase_parity_attn, args.seed)
        launches.update(run_phase("lm_train", phase_lm_train, args.seed,
                                  peaks))
        run_phase("e2e_lm_train", phase_e2e_lm_train, args.seed)
        add(run_phase("coord", phase_coord, args.seed, smi))
        attn_times, attn_errs = run_phase("timing_attn", phase_timing_attn,
                                          args.seed, peaks)
        times.update(attn_times)
        errs.update(attn_errs)
        errs.update(run_phase("parity_attn_bhtd", phase_parity_attn_bhtd,
                              args.seed))
        launches.update(run_phase("pp_lm_train", phase_pp_lm_train,
                                  args.seed, peaks))
        run_phase("e2e_pp_lm_train", phase_e2e_pp_lm_train, args.seed)
        times.update(run_phase("timing_attn_bhtd", phase_timing_attn_bhtd,
                               args.seed, peaks))
        add(run_phase("serve_bench", phase_serve_bench, smi))
        add(run_phase("profile_step", phase_profile_step, smi))
        run_phase("train_knobs", phase_train_knobs, args.seed)
        run_phase("guard", phase_guard, args.seed)
        run_phase("zero_overlap", phase_zero_overlap, args.seed)
        run_phase("trainer", phase_trainer, args.seed)
        run_phase("elastic", phase_elastic, args.seed)
        run_phase("lm_ckpt_serve", phase_lm_ckpt_serve, args.seed)
        run_phase("lm_mesh", phase_lm_mesh, args.seed, peaks, smi)
        run_phase("lm_mesh_zero", phase_lm_mesh_zero, args.seed, smi)
        run_phase("bench", phase_bench, smi)
        add(run_phase("models", phase_models, args.seed, smi))
        run_phase("sync_bn", phase_sync_bn, args.seed, smi)
        run_phase("conv_examples", phase_conv_examples, smi)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    emit("phase_seconds", seconds=PHASE_SECONDS,
         total_s=time.time() - _T_START)
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
