"""Benchmark: synthetic training throughput of the port on one GPU
(ResNet-50, ResNet-101, VGG-16, Inception V3 + transformer LM).

Port of the JAX package's ``bench.py`` (which stays that package's
contract): the same models, batches, optimizers, knobs and JSON lines,
with the metrics per GPU. Run it as::

    python -m horovod_tpu_torch.bench                  # both lines, card
    python -m horovod_tpu_torch.bench --model resnet50 --conv-backend fused
    python -m horovod_tpu_torch.bench --model resnet101 --conv-backend fused
    python -m horovod_tpu_torch.bench --model vgg16   # or inception3
    python -m horovod_tpu_torch.bench --model transformer_lm --accum-steps 2
    python -m horovod_tpu_torch.bench --zero --overlap  # ZeRO-1 + overlap
    python -m horovod_tpu_torch.bench --device cpu     # smoke sizes, CPU
    python -m horovod_tpu_torch.launcher -np 4 --cpu python -m \
        horovod_tpu_torch.bench --device cpu --model transformer_lm \
        --mesh dp=2,tp=2                               # a mesh world

The default run prints TWO JSON lines: ``resnet50_synthetic_images_per_
sec_per_gpu`` first, then ``transformer_lm_tokens_per_sec_per_gpu``. Each
carries ``value``, ``vs_baseline``, ``tflops_per_gpu``, ``mfu`` (against
the card's published dense bf16 peak, ``utils/flops.py``),
``peak_bytes_per_gpu`` (``torch.cuda.max_memory_allocated`` over that
line's run), the knob fields as ``bench.py`` names them (``accum_steps``,
``zero``, ``overlap``, ``wire_dtype``, ``tp``, ``pp``, ``mesh``; the LM
line also ``ep``; ``overlap_order``: the order the overlapped exchange
grouped or emitted its buckets in, ``"probed"`` from the first step's
backward, ``"flatten"``, or ``"plan"`` on the pipelined step, whose
gradients come out of its schedule whole; null without ``--overlap``),
the world size
and the card's ``name, power.limit`` as ``nvidia-smi`` prints them. The
ResNet line also carries ``phases``: the backward's, the exposed
exchange's and the update's shares of a step; the exchange is the
step's own (reduce-scatter and all-gather under ``--zero``, buckets
emitted during the backward under ``--overlap``).

Timing: each of ``rounds`` regions runs ``iters × steps_per_call`` plain
steps (``bench.py``'s count; torch has no scan to amortise dispatch)
and ends in a host read of the loss; the rate is the median over the
regions (``--rounds`` sets their count). Warmup runs
``warmup × steps_per_call`` steps first.

``HVD_BENCH_SMOKE=1`` or ``--device cpu`` takes the smoke configs
(cifar20 at 64², batch 16; the small LM) on a world of 1 — gloo on the
CPU, where the line is labelled per CPU and every device-only field is
null. ``HVD_FUSED_PARTS`` and ``HVD_LM_LOSS_CHUNK`` act as in
``bench.py``. Without a GPU and without ``--device cpu`` the bench exits
non-zero: it never falls back.

``--tp`` and ``--mesh dp=…,tp=…[,pp=…]`` run the LM's four-axis step
(tp > 1) or its pipelined step with tp inside the stages (pp > 1) over
a mesh of the launched world, whose size must be ``dp·tp·pp`` (``bench.
py``'s rule and wording: ``--tp`` × ``--pp`` must divide the visible
device count, here the world). The tp ranks of a dp group train on the
same rows, so the global batch scales with dp only. ``--zero`` and
``--overlap`` compose with both: ZeRO over dp with the other axes as
non-scatter axes (the hybrid plan), overlap on either plane.

``--model`` takes the JAX bench's four conv rows (``bench.py``'s
``_TPU_CONFIGS``, per GPU): resnet50 (224², batch 128), resnet101 (224²,
batch 96), vgg16 (224², batch 96, SGD lr 0.01: VGG has no BatchNorm)
and inception3 (299², batch 96), each with local BatchNorm;
``--conv-backend`` applies to resnet50 and resnet101 only, with the JAX
bench's guards against a mislabelled line.

``--scaling`` runs the conv model's line in worlds of 1, 2, 4, ... up to
the GPUs this host shows (gloo worlds of 1 and 2 under ``--device cpu``),
each started through the port's launcher (``python -m
horovod_tpu_torch.launcher -np N``, one process per GPU) running this
bench, and prints ``bench.py``'s scaling line per world
(``<model>_scaling_efficiency_<N>gpus``: the world's images/s over N
times the world of 1's, with ``images_per_sec_total`` and the knobs;
``cpus`` on the CPU), then the largest world's per-device line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import runtime, training
from horovod_tpu_torch.models import (cifar_resnet_v1, inception_v3,
                                      resnet50, resnet101, vgg16)
from horovod_tpu_torch.ops.fusion import wire_dtype_name
from horovod_tpu_torch.utils.flops import (FWD_GMACS, TRAIN_GFLOP_PER_IMAGE,
                                           lm_train_gflop_per_token,
                                           peaks_for)

# The reference's only published absolute throughput: ResNet-101 at
# 1656.82 images/sec on 16 Pascal GPUs. Other models' baselines are
# FLOPs-scaled from it, so vs_baseline compares hardware.
BASELINE_IMG_PER_SEC_PER_DEVICE = 1656.82 / 16

# bench.py's _TPU_CONFIGS, per GPU.
_GPU_CONFIGS = {
    "resnet50": dict(model="resnet50", image=224, batch_per_gpu=128,
                     warmup=5, iters=4, classes=1000, steps_per_call=8,
                     rounds=3),
    "resnet101": dict(model="resnet101", image=224, batch_per_gpu=96,
                      warmup=5, iters=4, classes=1000, steps_per_call=8,
                      rounds=3),
    # VGG has no BN: classic SGD needs the small-lr recipe or it blows up.
    "vgg16": dict(model="vgg16", image=224, batch_per_gpu=96,
                  warmup=5, iters=4, classes=1000, steps_per_call=8,
                  rounds=3, lr=0.01),
    "inception3": dict(model="inception3", image=299, batch_per_gpu=96,
                       warmup=5, iters=4, classes=1000, steps_per_call=8,
                       rounds=3),
}
_SMOKE_CONFIG = dict(model="cifar20", image=64, batch_per_gpu=16,
                     warmup=2, iters=5, classes=10, steps_per_call=1)
# The models --conv-backend applies to (bottleneck 1x1 convs).
_FUSABLE_MODELS = ("resnet50", "resnet101")

_LM_GPU = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
               d_ff=8192, seq=2048, batch_per_gpu=8,
               warmup=2, iters=6, steps_per_call=2, rounds=3)
_LM_SMOKE = dict(vocab=256, d_model=64, n_heads=2, n_layers=2,
                 d_ff=256, seq=128, batch_per_gpu=4,
                 warmup=1, iters=2, steps_per_call=1)

ADAMW = dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)


def _baseline_for(model: str) -> float:
    return BASELINE_IMG_PER_SEC_PER_DEVICE * (
        FWD_GMACS["resnet101"] / FWD_GMACS[model])


def _smoke(device: str) -> bool:
    return device == "cpu" or bool(int(os.environ.get("HVD_BENCH_SMOKE",
                                                      "0")))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_rate(run_once, units_per_round: float, rounds: int) -> float:
    """Median-of-rounds throughput: ``rounds`` timed regions, each ending
    in a host read of its last loss (the device has then drained the
    region's work)."""
    rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        final_loss = float(run_once())
        dt = time.perf_counter() - t0
        if not np.isfinite(final_loss):
            raise RuntimeError(f"bench loss is not finite: {final_loss}")
        rates.append(units_per_round / dt)
    return sorted(rates)[len(rates) // 2]


def _gpu_line() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _device_fields(device: torch.device, per: float, gflop: float) -> dict:
    """The fields only a card can give: TFLOP/s and MFU of ``per`` units
    a second at ``gflop`` each, the run's peak memory, the card. Null on
    the CPU."""
    if device.type != "cuda":
        return {"tflops_per_gpu": None, "mfu": None,
                "peak_bytes_per_gpu": None, "gpu": None}
    tflops = per * gflop / 1e3
    peak = peaks_for(torch.cuda.get_device_name(device))[0]
    return {"tflops_per_gpu": round(tflops, 1),
            "mfu": round(tflops * 1e12 / peak, 3),
            "peak_bytes_per_gpu": int(torch.cuda.max_memory_allocated(
                device)),
            "gpu": _gpu_line()}


def _per(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _mesh_desc(n: int, tp: int = 1, pp: int = 1) -> str:
    dp = n // (max(1, tp) * max(1, pp))
    return (f"dp{dp}" + (f",tp{tp}" if tp > 1 else "")
            + (f",pp{pp}" if pp > 1 else ""))


def _bench_config(model: str, device: str) -> dict:
    if _smoke(device):
        return dict(_SMOKE_CONFIG)
    return dict(_GPU_CONFIGS[model])


def _build_model(cfg: dict, device: torch.device, seed: int):
    """Local (per-replica) BatchNorm, as the reference's benchmark. The
    ``HVD_FUSED_PARTS`` sweep enters at construction; ``seed`` draws the
    weights and seeds the dropout masks."""
    gen = torch.Generator().manual_seed(seed)
    name = cfg["model"]
    if name in _FUSABLE_MODELS:
        parts = tuple(os.environ.get(
            "HVD_FUSED_PARTS", "reduce,expand,shortcut").split(","))
        build = resnet50 if name == "resnet50" else resnet101
        return build(cfg["classes"], dtype=torch.bfloat16,
                     conv_backend=cfg.get("conv_backend", "xla"),
                     fused_parts=parts, device=device, generator=gen)
    if name == "vgg16":
        return vgg16(cfg["classes"], dtype=torch.bfloat16,
                     image_size=cfg["image"], dropout_seed=seed,
                     device=device, generator=gen)
    if name == "inception3":
        return inception_v3(cfg["classes"], dtype=torch.bfloat16,
                            dropout_seed=seed, device=device, generator=gen)
    return cifar_resnet_v1(20, dtype=torch.float32, device=device,
                           generator=gen)


def _synthetic_batch(cfg: dict, device: torch.device, seed: int):
    """Standard-normal images and uniform labels from a seeded numpy
    generator: one fixed batch, made once and placed on the device."""
    rng = np.random.RandomState(seed)
    b, s = cfg["batch_per_gpu"], cfg["image"]
    x = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    y = rng.randint(0, cfg["classes"], size=(b,))
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def _time_median(fn, device: torch.device, reps: int) -> float:
    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _measure_phases(state, data, accum: int, rate: float, iters: int,
                    device: torch.device) -> dict:
    """Per-phase wall attribution (``bench.py``'s ``_measure_phases``):
    forward + backward alone, then the same plus the step's gradient
    exchange — the same buckets, wire and plane: the fused all-reduce,
    or the reduce-scatter and the all-gather of the reduced shards under
    ZeRO, with the buckets emitted during the backward under overlap —
    and the full step from the measured rate. The exchange's EXPOSED
    time is ``t(exchange) - t(backward)``; the update's is what the full
    step adds."""
    vag = training._build_value_and_grad(training.cross_entropy_loss,
                                         False)
    model, opt = state.model, state.optimizer

    def grads(arm: bool = False):
        opt.zero_grad(set_to_none=True)
        if accum == 1:
            if arm:
                opt.arm()
            vag(model, data)
        else:
            training._accumulate_grads(
                vag, model, data, accum, None,
                (lambda: opt.arm(1.0 / accum)) if arm else None)

    def grads_exchange():
        grads(arm=opt.overlap)
        opt.synchronize()

    reps = max(3, iters)
    t_bwd = _time_median(grads, device, reps)
    t_exch = _time_median(grads_exchange, device, reps)
    opt.zero_grad(set_to_none=True)
    t_step = data[0].shape[0] / rate
    t_coll = max(0.0, t_exch - t_bwd)
    t_upd = max(0.0, t_step - t_exch)

    def share(t):
        return round(min(1.0, t / t_step), 3) if t_step > 0 else 0.0
    return {"backward_s": round(t_bwd, 6),
            "collective_exposed_s": round(t_coll, 6),
            "update_s": round(t_upd, 6),
            "backward_share": share(t_bwd),
            "collective_share": share(t_coll),
            "update_share": share(t_upd)}


def build_step(cfg: dict, device: torch.device, seed: int = 0):
    """The conv line's train state, step and synthetic batch: what
    :func:`measure` times and ``profile_step`` profiles. Returns
    ``(state, step, data)``; ``step(state, data)`` is one train step."""
    accum = int(cfg.get("accum_steps", 1))
    if cfg["batch_per_gpu"] % accum:
        raise SystemExit(
            f"--accum-steps {accum} does not divide the per-GPU batch of "
            f"{cfg['batch_per_gpu']}")
    model = _build_model(cfg, device, seed)
    state = training.create_train_state(
        model, functools.partial(torch.optim.SGD, lr=cfg.get("lr", 0.1),
                                 momentum=0.9),
        wire_dtype=cfg.get("wire_dtype"), zero=bool(cfg.get("zero")),
        overlap=bool(cfg.get("overlap")), device=device)
    hvd.broadcast_parameters(model)
    step = training.make_train_step(accum_steps=accum)
    data = _synthetic_batch(cfg, device, seed + hvd.rank())
    return state, step, data


def measure(cfg: dict, device: torch.device, seed: int = 0):
    """Images/sec of the data-parallel train step over this process's
    world (one GPU, or a gloo world of one on the CPU), and its phases.
    Returns ``(total rate, phases, overlap order)``."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, step, data = build_step(cfg, device, seed)
    accum = int(cfg.get("accum_steps", 1))
    k = int(cfg.get("steps_per_call", 1))

    def run(n_steps: int):
        s = state
        for _ in range(n_steps):
            s, m = step(s, data)
        return m["loss"]

    float(run(cfg["warmup"] * k))
    rate = _median_rate(lambda: run(cfg["iters"] * k),
                        cfg["batch_per_gpu"] * hvd.size() * cfg["iters"] * k,
                        int(cfg.get("rounds", 1)))
    phases = _measure_phases(state, data, accum, rate, cfg["iters"], device)
    return rate, phases, state.optimizer.grad_order_source


def _lm_config(device: str) -> dict:
    cfg = dict(_LM_SMOKE if _smoke(device) else _LM_GPU)
    chunk = int(os.environ.get("HVD_LM_LOSS_CHUNK", "0"))
    if chunk:
        cfg["loss_chunk"] = chunk
    return cfg


def build_lm_step(cfg: dict, device: torch.device, seed: int = 0):
    """The LM line's train state, step and token batch over this
    process's world: the data-parallel step (``make_parallel_train_
    step``), the four-axis step (tp > 1) or the pipelined 1F1B step
    (``cfg["pp"] > 1``); what :func:`measure_lm` times and
    ``profile_step`` profiles. Returns ``(state, step, (tokens, labels),
    tokens_per_step)``; ``step(state, tokens, labels)`` is one step."""
    from horovod_tpu_torch.parallel.mesh import (batch_block,
                                                 create_hybrid_mesh)
    from horovod_tpu_torch.parallel.transformer import (
        TransformerConfig, make_parallel_train_step)
    n = hvd.size()
    tp, pp = int(cfg.get("tp", 1)), int(cfg.get("pp", 1))
    if tp > 1 and (tp * pp > n or n % (tp * pp)):
        raise SystemExit(
            f"--tp {tp} × --pp {pp} must divide the visible device count "
            f"{n} (the mesh is dp={n}//(tp·pp) × tp × pp)")
    if pp < 1 or n % pp:
        raise SystemExit(
            f"--pp {pp} must divide the world size {n} (the mesh is "
            f"dp={n}//pp × pp)")
    dp = n // (pp * tp)
    want_dp = cfg.get("mesh_dp")
    if want_dp is not None and int(want_dp) != dp:
        raise SystemExit(
            f"--mesh dp={want_dp},tp={tp},pp={pp} does not match the world "
            f"size {n} (needs dp×tp×pp == world; dp here is {dp})")
    tcfg = TransformerConfig(
        vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], dtype=torch.bfloat16,
        attn_backend="pallas" if device.type == "cuda" else "xla",
        unembed_dtype=torch.bfloat16, remat=bool(cfg.get("remat", False)),
        loss_chunk=int(cfg.get("loss_chunk", 0)))
    opt = functools.partial(torch.optim.AdamW, **ADAMW)
    mesh = None
    if pp > 1:
        from horovod_tpu_torch.parallel.pp_transformer import \
            make_pp_transformer_train_step
        if cfg["n_layers"] % pp:
            raise SystemExit(
                f"--pp {pp} must divide n_layers={cfg['n_layers']} (each "
                f"pipeline stage owns n_layers//pp layers)")
        # The microbatches ARE the accumulation in the pipelined family.
        micro = max(2, int(cfg.get("accum_steps", 1)))
        if cfg["batch_per_gpu"] % micro:
            raise SystemExit(
                f"batch_per_gpu={cfg['batch_per_gpu']} must divide into "
                f"--accum-steps {micro} microbatches for the pipelined path")
        mesh = create_hybrid_mesh(dp=dp, pp=pp, tp=tp)
        init_state, step = make_pp_transformer_train_step(
            tcfg, mesh, opt, micro, wire_dtype=cfg.get("wire_dtype"),
            zero=bool(cfg.get("zero")), overlap=bool(cfg.get("overlap")),
            device=device)
        state = init_state(seed)
    elif tp > 1:
        mesh = create_hybrid_mesh(dp=dp, tp=tp)
        init_state, step = make_parallel_train_step(
            tcfg, opt, mesh=mesh, wire_dtype=cfg.get("wire_dtype"),
            accum_steps=int(cfg.get("accum_steps", 1)),
            zero=bool(cfg.get("zero")), overlap=bool(cfg.get("overlap")),
            device=device)
        state = init_state(seed)
    else:
        init_state, step = make_parallel_train_step(
            tcfg, opt, wire_dtype=cfg.get("wire_dtype"),
            accum_steps=int(cfg.get("accum_steps", 1)),
            zero=bool(cfg.get("zero")), overlap=bool(cfg.get("overlap")),
            device=device)
        state = init_state(seed)
        hvd.broadcast_parameters(state.model)
    B, T = cfg["batch_per_gpu"], cfg["seq"]
    rng = np.random.RandomState(seed)
    if tp > 1:
        # One global batch of B rows per dp index; each rank feeds its
        # dp group's rows (the tp ranks of a group the same ones).
        rows = (B * dp, T)
        tokens, labels = (batch_block(torch.from_numpy(
            rng.randint(0, cfg["vocab"], size=rows)), mesh,
            batch_axes=("dp",), seq_axis=None).contiguous().to(device)
            for _ in range(2))
    else:
        tokens = torch.from_numpy(rng.randint(0, cfg["vocab"],
                                              size=(B, T))).to(device)
        labels = torch.from_numpy(rng.randint(0, cfg["vocab"],
                                              size=(B, T))).to(device)
    return state, step, (tokens, labels), B * dp * T


def measure_lm(cfg: dict, device: torch.device, seed: int = 0):
    """Tokens/sec of the transformer-LM train step over this process's
    world (:func:`build_lm_step`). Returns the total rate and the overlap
    order (None without overlap)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, step, (tokens, labels), per_step = build_lm_step(cfg, device,
                                                            seed)
    k = int(cfg.get("steps_per_call", 1))

    def run(n_steps: int):
        s = state
        for _ in range(n_steps):
            s, loss = step(s, tokens, labels)
        return loss

    float(run(cfg["warmup"] * k))
    rate = _median_rate(lambda: run(cfg["iters"] * k),
                        per_step * cfg["iters"] * k,
                        int(cfg.get("rounds", 1)))
    return rate, getattr(state.optimizer, "grad_order_source", None)


def lm_line(device: torch.device, wire_dtype=None, tp: int = 1,
            pp: int = 1, accum_steps: int = 1, mesh_dp=None,
            seed: int = 0, zero: bool = False,
            overlap: bool = False, rounds: Optional[int] = None) -> dict:
    cfg = _lm_config(device.type)
    cfg.update(wire_dtype=wire_dtype, tp=tp, pp=pp, accum_steps=accum_steps,
               mesh_dp=mesh_dp, zero=zero, overlap=overlap)
    if rounds:
        cfg["rounds"] = rounds
    rate, order = measure_lm(cfg, device, seed)
    n = hvd.size()
    per_gpu = rate / n
    gflop_tok = lm_train_gflop_per_token(cfg)
    baseline = BASELINE_IMG_PER_SEC_PER_DEVICE * (
        TRAIN_GFLOP_PER_IMAGE["resnet101"] / gflop_tok)
    per = _per(device)
    return {"metric": f"transformer_lm_tokens_per_sec_per_{per}",
            "value": round(per_gpu, 1), "unit": f"tokens/sec/{per}",
            "vs_baseline": round(per_gpu / baseline, 3),
            "accum_steps": int(accum_steps), "zero": bool(zero),
            "overlap": bool(overlap), "overlap_order": order,
            "wire_dtype": wire_dtype_name(wire_dtype),
            "tp": int(tp), "pp": int(pp), "ep": 1,
            "mesh": _mesh_desc(n, tp, pp),
            "loss_chunk": int(cfg.get("loss_chunk", 0)), "world": n,
            **_device_fields(device, per_gpu, gflop_tok)}


def resnet_line(cfg: dict, device: torch.device, seed: int = 0) -> dict:
    rate, phases, order = measure(cfg, device, seed)
    per_gpu = rate / hvd.size()
    per = _per(device)
    return {"metric": f"{cfg['model']}_synthetic_images_per_sec_per_{per}",
            "value": round(per_gpu, 2), "unit": f"images/sec/{per}",
            "vs_baseline": round(per_gpu / _baseline_for(cfg["model"]), 3),
            "accum_steps": int(cfg.get("accum_steps", 1)),
            "zero": bool(cfg.get("zero")),
            "overlap": bool(cfg.get("overlap")), "overlap_order": order,
            "wire_dtype": wire_dtype_name(cfg.get("wire_dtype")),
            "tp": 1, "pp": 1, "mesh": _mesh_desc(hvd.size()),
            "conv_backend": cfg.get("conv_backend", "xla"),
            "world": hvd.size(), "phases": phases,
            **_device_fields(device, per_gpu,
                             TRAIN_GFLOP_PER_IMAGE[cfg["model"]])}


def _parse_mesh(spec: str, tp: int, pp: int):
    sizes = {}
    for part in spec.split(","):
        m = re.match(r"^\s*(dp|tp|pp)\s*=?\s*(\d+)\s*$", part)
        if not m:
            raise SystemExit(f"--mesh expects 'dp=N,tp=M,pp=P' (got "
                             f"{part!r})")
        sizes[m.group(1)] = int(m.group(2))
    for name, flag in (("tp", tp), ("pp", pp)):
        if flag != 1 and flag != sizes.get(name, 1):
            raise SystemExit(f"--{name} {flag} conflicts with --mesh "
                             f"{spec!r}")
    return sizes.get("tp", 1), sizes.get("pp", 1), sizes.get("dp")


def _emit(line: dict) -> None:
    """Print a result line, on rank 0 only (every rank measures the same
    world), in one write: the ranks of a launched world share one stdout,
    and two writes could interleave with another rank's."""
    if not runtime.is_initialized() or runtime.rank() == 0:
        sys.stdout.write(json.dumps(line) + "\n")
        sys.stdout.flush()


# The launcher's exit is bounded per world of the --scaling sweep.
SCALING_TIMEOUT = 900


def _child_args(args) -> list:
    """This run's arguments for one world of the --scaling sweep."""
    out = ["--model", args.model or "resnet50", "--device", args.device,
           "--seed", str(args.seed), "--accum-steps", str(args.accum_steps)]
    if args.conv_backend:
        out += ["--conv-backend", args.conv_backend]
    if args.wire_dtype:
        out += ["--wire-dtype", args.wire_dtype]
    if args.rounds:
        out += ["--rounds", str(args.rounds)]
    return out + [f for f, on in (("--zero", args.zero),
                                  ("--overlap", args.overlap)) if on]


def scaling(args) -> int:
    """The --scaling sweep: a launcher world per size, its (rank 0's)
    line, one scaling-efficiency line per size."""
    from horovod_tpu_torch.utils import config as _config
    if _config.launcher_size() > 1:
        raise SystemExit(
            "--scaling starts its own worlds through the launcher; run it "
            "as one process, not under the launcher")
    cpu = args.device == "cpu"
    top = 2 if cpu else _config.visible_gpus()
    sizes = sorted({2 ** p for p in range(8) if 2 ** p <= top} | {top})
    per = "cpu" if cpu else "gpu"
    rate1, line = None, None
    for n in sizes:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np",
               str(n)] + (["--cpu"] if cpu else []) + [
            sys.executable, "-m", "horovod_tpu_torch.bench"] \
            + _child_args(args)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=SCALING_TIMEOUT)
        if proc.returncode != 0:
            raise SystemExit(f"--scaling: the world of {n} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        if len(lines) != 1:
            raise SystemExit(f"--scaling: the world of {n} printed "
                             f"{len(lines)} lines: {proc.stdout[-2000:]}")
        line = lines[0]
        rate = line["value"] * n
        if n == 1:
            rate1 = rate
        eff = rate / (n * rate1)
        _emit({
            "metric": f"{line['metric'].split('_synthetic')[0]}"
                      f"_scaling_efficiency_{n}{per}s",
            "value": round(eff, 4), "unit": "fraction",
            "vs_baseline": round(eff / 0.90, 3),  # ref: 90% at 128 GPUs
            "images_per_sec_total": round(rate, 2),
            **{k: line[k] for k in ("accum_steps", "zero", "overlap",
                                    "wire_dtype", "tp", "pp", "mesh",
                                    "world")}})
    _emit(line)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Synthetic training throughput of the port "
                    "(the conv models + transformer LM), one JSON line "
                    "each.")
    p.add_argument("--scaling", action="store_true",
                   help="the conv model in worlds of 1, 2, 4, ... GPUs "
                        "(gloo worlds of 1 and 2 with --device cpu), each "
                        "through the launcher: one scaling-efficiency "
                        "line per world")
    p.add_argument("--model", default=None,
                   choices=sorted(_GPU_CONFIGS) + ["transformer_lm"],
                   help="benchmark model (default: resnet50 then "
                        "transformer_lm; the smoke configs swap resnet50 "
                        "for cifar20)")
    p.add_argument("--conv-backend", default=None, choices=["xla", "fused"],
                   help="ResNet conv backend (resnet50, resnet101): 'xla' "
                        "is cuDNN, 'fused' sends the bottleneck 1x1 convs "
                        "of stages 0-1 through the fused conv + BN "
                        "kernels")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="in-step gradient accumulation over N microbatches "
                        "of the per-GPU batch, one exchange per step")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1: reduce-scatter, the update on this GPU's "
                        "shard of the optimizer state, all-gather")
    p.add_argument("--overlap", action="store_true",
                   help="backward-overlapped bucket collectives (each "
                        "bucket's collective starts when its last "
                        "gradient lands)")
    p.add_argument("--wire-dtype", default=None,
                   choices=["fp32", "bf16", "fp8"],
                   help="wire format of the gradient exchange (f32 scales "
                        "and results; fp8 is e4m3 with per-bucket dynamic "
                        "scaling)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size (transformer_lm; "
                        "tp × pp must divide the world size)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel axis size (transformer_lm; "
                        "must divide the world size)")
    p.add_argument("--mesh", default=None,
                   help="explicit mesh spec 'dp=N,tp=M,pp=P'")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default; exits without a GPU) or 'cpu' "
                        "for the smoke configs on a gloo world of 1")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the synthetic batches")
    p.add_argument("--rounds", type=int, default=None,
                   help="timed regions of each line, whose median is its "
                        "rate (default: the config's)")
    args = p.parse_args(argv)
    if args.accum_steps < 1:
        raise SystemExit(f"--accum-steps must be >= 1, got "
                         f"{args.accum_steps}")
    if args.rounds is not None and args.rounds < 1:
        raise SystemExit(f"--rounds must be >= 1, got {args.rounds}")
    tp, pp, mesh_dp = args.tp, args.pp, None
    if args.mesh:
        tp, pp, mesh_dp = _parse_mesh(args.mesh, tp, pp)
    if tp < 1 or pp < 1:
        raise SystemExit(f"--tp and --pp must be >= 1, got {tp}, {pp}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "horovod_tpu_torch.bench runs on a CUDA device, but "
            "torch.cuda.is_available() is False; pass --device cpu for "
            "the smoke configs")
    if args.scaling:
        if args.model == "transformer_lm":
            raise SystemExit(
                "--scaling is not supported for transformer_lm (the conv "
                "family's re-init-with-device-subsets machinery does not "
                "apply); run it without --scaling")
        if pp > 1 or tp > 1 or args.mesh:
            raise SystemExit("--scaling sweeps pure dp worlds: drop "
                             "--pp/--tp/--mesh")
        return scaling(args)
    wire = None if args.wire_dtype in (None, "fp32") else args.wire_dtype
    hvd.init(device=args.device)
    device = runtime.device()
    try:
        if args.model == "transformer_lm":
            _emit(lm_line(device, wire, tp, pp, args.accum_steps, mesh_dp,
                          args.seed, args.zero, args.overlap, args.rounds))
            return 0
        if pp > 1 or tp > 1:
            raise SystemExit(
                "--pp/--tp/--mesh beyond pure dp applies to --model "
                "transformer_lm: the conv models are not staged")
        cfg = _bench_config(args.model or "resnet50", args.device)
        cfg.update(accum_steps=args.accum_steps, wire_dtype=wire,
                   zero=args.zero, overlap=args.overlap)
        if args.rounds:
            cfg["rounds"] = args.rounds
        if args.conv_backend:
            if (args.model or "resnet50") not in _FUSABLE_MODELS:
                raise SystemExit(
                    "--conv-backend applies to the resnet models only (the "
                    "fused kernel targets bottleneck 1x1 convs); a silent "
                    "ignore would mislabel a stock run as a fused "
                    "measurement")
            if cfg["model"] not in _FUSABLE_MODELS:
                raise SystemExit(
                    "--conv-backend has no effect in smoke/CPU mode (the "
                    "smoke config swaps the model to cifar20)")
            cfg["conv_backend"] = args.conv_backend
        _emit(resnet_line(cfg, device, args.seed))
        if args.model is None:
            if device.type == "cuda":
                torch.cuda.empty_cache()
            _emit(lm_line(device, wire, accum_steps=1, seed=args.seed,
                          zero=args.zero, overlap=args.overlap,
                          rounds=args.rounds))
        return 0
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main())
