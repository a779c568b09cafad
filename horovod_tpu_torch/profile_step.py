"""Per-op device-time profile of the bench's training step.

Port of the JAX package's ``bin/profile_step.py``: builds the step of
``python -m horovod_tpu_torch.bench`` (the same configs, through
``bench.build_step`` / ``bench.build_lm_step``), runs ``--steps`` steps
under ``torch.profiler`` (CPU and CUDA activity) after two warmup steps,
each step inside a ``record_function`` marker that ends in a host read of
the loss, and aggregates the trace's device events into a per-step table:
device busy ms a step, the busy time by category (ms a step, % busy,
launches a step) and the top ops a step::

    python -m horovod_tpu_torch.profile_step --model resnet50
    python -m horovod_tpu_torch.profile_step --model resnet50 \\
        --conv-backend fused
    python -m horovod_tpu_torch.profile_step --model resnet101 \\
        --conv-backend fused         # or --model vgg16, inception3
    python -m horovod_tpu_torch.profile_step --model transformer_lm
    python -m horovod_tpu_torch.profile_step --timeline hvd_timeline.json

The step divisor is the number of step markers the trace holds, not the
requested count (JAX's ``_dispatch_count`` rationale: a trace can miss
steps). Categories are named for the card: the hand-written kernel
families by symbol (``conv_bn_fwd`` K1, ``conv_bn_bwd`` K2 and
``conv_bn_aux``, their column-sum and weight-rounding kernels;
``flash_fwd_wgmma`` K3; ``flash_bwd_dq``, ``flash_bwd_dkv`` K4/K5/K6/K7;
``paged_decode`` K8), then GEMM (cuBLAS, cuDNN), elementwise,
reduction, copy (copies, casts, fills), NCCL and other. A CUDA trace
carries neither flops nor bytes per kernel, so the TFLOP/s and GB/s
columns of the JAX tables print ``-``.

It runs on the card unless ``--device cpu`` is given (the bench's smoke
configs, whose "device" track is the CPU ops' self time, each op put in a
category by its ``aten::`` name); without a GPU and without ``--device
cpu`` it exits non-zero. A card's trace that holds no kernel event exits
non-zero too: its numbers are never taken from the host's ops. The
aggregation
(:func:`aggregate`, :func:`report`) and :func:`timeline_host_report`
(host-plane phases from a ``HOROVOD_TIMELINE`` trace, any host) are
plain Python over Chrome-trace events. The last line of a profile is one
JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
from typing import Dict, List, Optional

#: The ``record_function`` name of one profiled step.
STEP_MARK = "hvd_profile_step"
#: Trace categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WARMUP_STEPS = 2

# Kernels on the card, first match wins: the hand-written kernels by
# symbol, then the rest.
CATEGORIES = (
    ("conv_bn_fwd", r"conv_bn_fwd"),
    ("conv_bn_bwd", r"conv_bn_bwd"),
    ("conv_bn_aux", r"conv_bn_(col_sum|w_round)"),
    ("flash_fwd_wgmma", r"flash_fwd_wgmma"),
    ("flash_bwd_dq", r"flash_bwd_dq"),
    ("flash_bwd_dkv", r"flash_bwd_dkv"),
    ("paged_decode", r"paged_decode"),
    ("NCCL", r"nccl"),
    ("GEMM", r"gemm|nvjet|xmma|cutlass|cublas|cudnn|conv|wgrad|dgrad|fprop"),
    ("copy", r"copy|memcpy|memset|catarray|fill"),
    ("elementwise", r"elementwise"),
    ("reduction", r"reduce|softmax|norm|welford"),
)
_CATEGORY_RES = tuple((name, re.compile(pat, re.I))
                      for name, pat in CATEGORIES)
# The CPU's ops (``--device cpu``) by their ``aten::`` name; views,
# autograd nodes and the rest are "other".
CPU_OPS = {f"aten::{op}": cat for cat, ops in (
    ("GEMM", "mm addmm bmm baddbmm matmul linear einsum"),
    ("copy", "copy_ _to_copy cat stack index index_select index_put_ "
             "_index_put_impl_ gather scatter scatter_add_ embedding clone "
             "contiguous fill_ zero_ zeros ones empty empty_like "
             "empty_strided new_zeros new_empty masked_fill_"),
    ("elementwise", "add add_ sub sub_ mul mul_ div div_ neg exp exp_ log "
                    "log_ rsqrt sqrt pow gelu gelu_backward relu silu "
                    "sigmoid tanh where threshold_backward clamp clamp_min "
                    "lerp_ addcmul_ addcdiv_ maximum minimum abs erf cos "
                    "sin eq"),
    ("reduction", "sum mean max min amax argmax logsumexp var std cumsum "
                  "topk sort softmax _softmax _softmax_backward_data "
                  "log_softmax _log_softmax native_layer_norm "
                  "native_layer_norm_backward norm linalg_vector_norm"),
) for op in ops.split()}


def category(name: str, device: str = "cuda") -> str:
    """The category of a kernel on the card by its symbol, or of an op
    of a ``--device cpu`` trace by its name."""
    if device == "cpu":
        return CPU_OPS.get(name, "other")
    for cat, rx in _CATEGORY_RES:
        if rx.search(name):
            return cat
    return "other"


def step_count(events: List[dict]) -> int:
    """Profiled steps the trace holds: its ``STEP_MARK`` annotations."""
    return sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == STEP_MARK)


def _cpu_self_times(events: List[dict]) -> List[tuple]:
    """The CPU ops of a trace with their self time (their span less their
    child ops' spans on the same thread): the work a CPU trace's "device"
    did, each microsecond counted once, where an ``aten::linear`` encloses
    its ``aten::addmm`` as JAX's ``while`` encloses its body."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []          # [end, index into out]
        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                parent = out[stack[-1][1]]
                out[stack[-1][1]] = parent[:3] + (parent[3] - dur,)
            out.append((e.get("name", ""), ts, ts + dur, dur))
            stack.append((ts + dur, len(out) - 1))
    return out


def op_events(events: List[dict], device: str) -> List[tuple]:
    """The work of ``device`` in the trace as ``(name, start, end, busy)``
    in µs: on the card its kernels, copies and sets, on the CPU its ops
    with their self time. Raises ``SystemExit`` when a ``cuda`` trace
    holds no device event (no CUDA activity was recorded: CUPTI missing,
    or the profiler stopped early), rather than count the host's ops."""
    if device == "cpu":
        return _cpu_self_times(events)
    dev = [(e.get("name", ""), float(e["ts"]),
            float(e["ts"]) + float(e.get("dur", 0)), float(e.get("dur", 0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        raise SystemExit(
            f"profile_step: the {device} trace holds no kernel, memcpy or "
            f"memset event: the profiler recorded no CUDA activity (CUPTI "
            f"unavailable, or the profiler stopped before the steps ran)")
    return dev


def aggregate(events: List[dict], device: str, top: int = 24) -> Dict:
    """Per-step time of ``device`` (``"cuda"`` or ``"cpu"``) by category
    and by op over a Chrome trace (``traceEvents``; times in µs). Raises
    ``SystemExit`` when the trace holds no step marker or no time of
    ``device``."""
    k = step_count(events)
    if k == 0:
        raise SystemExit(
            f"profile_step: the trace holds no {STEP_MARK!r} step marker; "
            f"the profiler likely stopped before the steps ran")
    cats = collections.defaultdict(lambda: [0.0, 0])     # us, launches
    ops = collections.defaultdict(lambda: [0.0, 0, ""])  # us, n, category
    t_min, t_max, busy = float("inf"), 0.0, 0.0
    for name, ts, end, dur in op_events(events, device):
        t_min, t_max = min(t_min, ts), max(t_max, end)
        busy += dur
        cat = category(name, device)
        cats[cat][0] += dur
        cats[cat][1] += 1
        o = ops[name]
        o[0] += dur
        o[1] += 1
        o[2] = cat
    if busy == 0:
        raise SystemExit(
            f"profile_step: no {device} time in the trace")
    walls = sorted(float(e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == STEP_MARK)
    return {
        "steps": k,
        "busy_ms_per_step": busy / 1e3 / k,
        "envelope_ms_per_step": (t_max - t_min) / 1e3 / k,
        "step_wall_ms_p50": walls[len(walls) // 2] / 1e3,
        "step_wall_ms_mean": sum(walls) / len(walls) / 1e3,
        "categories": {
            c: {"ms_per_step": us / 1e3 / k, "pct_busy": 100 * us / busy,
                "launches_per_step": n / k}
            for c, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0])},
        "top_ops": [
            {"name": name, "category": cat, "ms_per_step": us / 1e3 / k,
             "launches_per_step": n / k}
            for name, (us, n, cat) in sorted(
                ops.items(), key=lambda kv: -kv[1][0])[:top]],
    }


CATEGORY_HEADER = (f"{'category':<28}{'ms/step':>9}{'%busy':>7}"
                   f"{'TFLOP/s':>9}{'GB/s':>8}")
TOP_HEADER = (f"top ops (per step): {'ms':>8} {'TF/s':>7} {'GB/s':>6}  n  "
              f"category / name")


def report(agg: Dict) -> None:
    """Print JAX's two tables from :func:`aggregate`'s numbers."""
    k = agg["steps"]
    busy, env = agg["busy_ms_per_step"], agg["envelope_ms_per_step"]
    print(f"(trace captured {k} steps)")
    print(f"device busy: {busy:.2f} ms/step (envelope {env:.2f}); "
          f"idle = {env - busy:.2f} ms; step wall p50 "
          f"{agg['step_wall_ms_p50']:.2f} ms")
    print(CATEGORY_HEADER)
    for cat, c in agg["categories"].items():
        print(f"{cat:<28}{c['ms_per_step']:>9.2f}{c['pct_busy']:>7.1f}"
              f"{'-':>9}{'-':>8}")
    print()
    print(TOP_HEADER)
    for o in agg["top_ops"]:
        print(f"{'':>8}{o['ms_per_step']:>10.3f} {'-':>7} {'-':>6} "
              f"{o['launches_per_step']:>3g}  {o['category']} / "
              f"{o['name'][:70]}")


def timeline_host_report(path):
    """Host-plane attribution from a ``HOROVOD_TIMELINE`` Chrome trace.

    The device-side tables say where the card's time goes; this says what
    the HOST was doing meanwhile: ``H2D`` rows come from the prefetch
    thread (input staging), ``CKPT_SNAPSHOT``/``CKPT_WRITE`` from the
    checkpoint path. A run whose summed H2D time approaches its wall clock
    is input-bound; large CKPT_WRITE with small CKPT_SNAPSHOT means
    async checkpointing is doing its job (the write overlaps training).
    """
    with open(path) as fh:
        text = fh.read()
    try:
        events = json.loads(text)
    except json.JSONDecodeError:
        # The trace is a terminated JSON array only after Timeline.close();
        # a still-running or killed run leaves "[{...},\n{...},\n".
        events = json.loads(text.rstrip().rstrip(",") + "]")
    open_ev = {}
    totals = collections.defaultdict(lambda: [0.0, 0])  # name -> [us, n]
    t_min, t_max = float("inf"), 0.0
    for e in events:
        if not isinstance(e, dict) or "ph" not in e:
            continue
        ts = e.get("ts")
        if ts is not None:
            t_min, t_max = min(t_min, ts), max(t_max, ts)
        if e["ph"] == "B":
            open_ev.setdefault(e["pid"], []).append((e["name"], ts))
        elif e["ph"] == "E":
            stack = open_ev.get(e["pid"])
            if stack:
                name, ts0 = stack.pop()
                totals[name][0] += ts - ts0
                totals[name][1] += 1
    host = {k: v for k, v in totals.items()
            if k in ("H2D", "CKPT_SNAPSHOT", "CKPT_WRITE")}
    if not host:
        raise SystemExit(
            f"profile_step: no host-plane phases (H2D/CKPT_*) in {path} — "
            "run training with HOROVOD_TIMELINE set, prefetch enabled "
            "(Trainer(prefetch>=1)) and/or an AsyncCheckpointer attached")
    span_ms = (t_max - t_min) / 1e3
    print(f"host-plane phases ({path}; trace span {span_ms:.1f} ms):")
    print(f"{'phase':<16}{'total ms':>10}{'n':>6}{'mean ms':>10}"
          f"{'% span':>8}")
    for name, (us, n) in sorted(host.items(), key=lambda kv: -kv[1][0]):
        ms = us / 1e3
        print(f"{name:<16}{ms:>10.2f}{n:>6}{ms / n:>10.2f}"
              f"{100 * ms / span_ms if span_ms else 0:>8.1f}")


def capture(run_step, steps: int, device) -> List[dict]:
    """``run_step()`` ``steps`` times under ``torch.profiler``, each in a
    ``STEP_MARK`` region; returns the Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="hvdprof", suffix=".json")
    os.close(fd)
    try:
        with profile(activities=acts) as prof:
            for _ in range(steps):
                with record_function(STEP_MARK):
                    run_step()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def profile_model(model: str, conv_backend: str, steps: Optional[int],
                  device) -> List[dict]:
    """The bench's step of ``model`` (its config for ``device``): two
    warmup steps, then ``steps`` profiled ones (default: the config's
    steps a call), each ending in a host read of the loss."""
    from . import bench
    if model == "transformer_lm":
        cfg = bench._lm_config(device.type)
        state, step, (tokens, labels), _ = bench.build_lm_step(cfg, device)

        def one():
            nonlocal state
            state, loss = step(state, tokens, labels)
            return float(loss)
    else:
        cfg = bench._bench_config(model, device.type)
        if conv_backend != "xla":
            # bench.py's mislabel guard: a run that profiles stock convs
            # must not be recorded as a fused measurement.
            if model not in bench._FUSABLE_MODELS \
                    or cfg["model"] not in bench._FUSABLE_MODELS:
                raise SystemExit(
                    "--conv-backend fused applies to resnet50/resnet101 on "
                    "the card only (the CPU's smoke config swaps the model "
                    "to cifar20)")
            cfg["conv_backend"] = conv_backend
        state, step, data = bench.build_step(cfg, device)

        def one():
            nonlocal state
            state, m = step(state, data)
            return float(m["loss"])
    for _ in range(WARMUP_STEPS):
        one()
    return capture(one, steps or int(cfg.get("steps_per_call", 1)), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.profile_step",
        description="Per-op device-time profile of the bench's train step.")
    p.add_argument("--model", default="resnet50",
                   choices=("resnet50", "resnet101", "vgg16", "inception3",
                            "transformer_lm"),
                   help="any bench model (the CPU's smoke config swaps "
                        "the conv models for cifar20)")
    p.add_argument("--conv-backend", default="xla", choices=("xla", "fused"),
                   help="ResNet conv backend: 'xla' is cuDNN, 'fused' the "
                        "fused 1x1 conv + BN kernels (K1, K2)")
    p.add_argument("--steps", type=int, default=None,
                   help="profiled steps (default: the bench config's "
                        "steps a call)")
    p.add_argument("--timeline", default=None, metavar="FILE",
                   help="summarize host-plane phases (H2D, CKPT_*) from a "
                        "HOROVOD_TIMELINE trace instead of profiling; any "
                        "host")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda' (default; exits without a GPU) or 'cpu' "
                        "for the bench's smoke configs")
    args = p.parse_args(argv)
    if args.timeline:
        timeline_host_report(args.timeline)
        return 0
    import torch

    from . import runtime
    if args.steps is not None and args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "horovod_tpu_torch.profile_step runs on a CUDA device, but "
            "torch.cuda.is_available() is False; pass --device cpu for "
            "the smoke configs")
    owned = not runtime.is_initialized()
    runtime.init(device=args.device)
    try:
        events = profile_model(args.model, args.conv_backend, args.steps,
                               runtime.device())
    finally:
        if owned:
            runtime.shutdown()
    agg = aggregate(events, args.device)
    report(agg)
    print(json.dumps(dict(agg, model=args.model,
                          conv_backend=args.conv_backend,
                          device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
