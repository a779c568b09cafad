#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's main path — the paged generation engine serving the
bench LM at full width (``bench.py``'s ``_LM_TPU``: vocab 32768, d_model
2048, 16 heads of 128, 8 layers, d_ff 8192; random weights from a seed)
— and holds every CUDA kernel on that path against its plain PyTorch
version on the card. Phases, one JSON line each:

1. device   — require CUDA; print the card, its power limit, versions.
2. build    — nvcc-build the kernels from ``horovod_tpu_torch/ops/csrc``.
3. parity   — each kernel vs its plain version at the engine's shapes.
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
               version's time and a library yardstick's.

Then, before the last line, the card's ``name, power.limit`` and one
``{"kernels": [...]}`` object; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with
no result line. Run: ``python3 chip_smoke.py`` from the repository root.
"""

from __future__ import annotations

import argparse
import copy
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

LM = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8, d_ff=8192)
MAX_SLOTS, MAX_LEN, BLOCK = 8, 2048, 16
NEW_TOKENS = 32
PROMPT_LENS = (9, 100, 300, 1000, 1500, 200, 600)   # + one over HTTP
HTTP_PROMPT_LEN = 64
FLASH_T = (128, 1000, 2048)           # timed
FLASH_T_PARITY = (1, 16) + FLASH_T    # + the smallest prefill buckets
TOL_FLASH = 2e-2    # bf16 outputs of magnitude < 4: a few bf16 ulps
TOL_PAGED = 2e-2    # f32 math on both sides, one bf16 rounding of O(1)
# Logits of std ~0.9 after 8 bf16 layers on two devices whose matmuls
# round differently: 0.035 measured on an H100, bound at about 3x that.
TOL_E2E = 0.1
# Published dense peaks (bf16 tensor-core FLOP/s, memory bytes/s).
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12)}
PEAK_DEFAULT = (989e12, 3.35e12)    # H100 SXM
REPLACES = {
    "flash_attention": "horovod_tpu/ops/pallas_attention.py:101",
    "paged_decode_attention": "horovod_tpu/ops/pallas_paged_attention.py:57",
}
SOURCES = {
    "flash_attention": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "paged_decode_attention":
        "horovod_tpu_torch/ops/csrc/paged_attention.cu",
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
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAK_DEFAULT


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median per-call device time of ``fn`` (CUDA events, warmed up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return float(np.median(samples))


def bound_ms(flops: float, nbytes: float, peaks) -> tuple:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


# -- phase inputs ------------------------------------------------------------

def flash_inputs(T: int, gen: torch.Generator):
    """q/k/v as the engine hands them to the kernel: strided views of the
    [1, T, H, 3, d] projection output."""
    qkv = torch.randn((1, T, LM["n_heads"], 3, 128), generator=gen,
                      device="cuda").to(torch.bfloat16)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def paged_inputs(positions, gen: torch.Generator):
    """One layer's pool at the engine's size, random tables."""
    n_blocks = MAX_SLOTS * (MAX_LEN // BLOCK) + 1
    H = LM["n_heads"]
    pool = lambda: torch.randn((n_blocks, BLOCK, H, 128), generator=gen,  # noqa: E731
                               device="cuda").to(torch.bfloat16)
    q = torch.randn((MAX_SLOTS, H, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tables = torch.randint(1, n_blocks, (MAX_SLOTS, MAX_LEN // BLOCK),
                           generator=gen, device="cuda", dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, pool(), pool(), tables, pos


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


def phase_build():
    from horovod_tpu_torch.ops import _build
    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    secs = time.monotonic() - t0
    emit("build", seconds=secs, library=path, compiler_log=path + ".log")


def phase_parity(seed: int):
    from horovod_tpu_torch.ops.attention import (flash_attention,
                                                 flash_attention_reference)
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for T in FLASH_T_PARITY:
        q, k, v = flash_inputs(T, gen)
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal=True)
        err = (out.float() - ref.float()).abs().max().item()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"flash_attention T={T}: bad output")
        errs[f"T{T}"] = err
        check(err <= TOL_FLASH, f"flash_attention T={T}: max abs err "
                                f"{err} > {TOL_FLASH}")
    flash_err = max(errs.values())
    emit("parity", kernel="flash_attention", max_abs_err=errs,
         tolerance=TOL_FLASH, shapes="B=1 H=16 d=128 bf16 causal")
    rng = np.random.RandomState(seed)
    positions = [-1, 0, 15, 16, 2047] + list(rng.randint(0, MAX_LEN, 3))
    q, kp, vp, tables, pos = paged_inputs(positions, gen)
    out = paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, kp, vp, tables, pos)
    paged_err = (out.float() - ref.float()).abs().max().item()
    check(not out[0].any(), "paged_decode_attention: pos=-1 row not zero")
    check(paged_err <= TOL_PAGED, f"paged_decode_attention: max abs err "
                                  f"{paged_err} > {TOL_PAGED}")
    emit("parity", kernel="paged_decode_attention", max_abs_err=paged_err,
         tolerance=TOL_PAGED, positions=[int(p) for p in positions],
         shapes="S=8 H=16 d=128 bs=16 128 blocks/slot bf16")
    return {"flash_attention": flash_err,
            "paged_decode_attention": paged_err}


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
    time of the round (one stream, so device work does not overlap), and
    the top entries by device time. Null when the profiler records no
    device time (tracing is unavailable)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for h in [eng.submit(p) for p in prompts]:
            h.result(600)
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
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall_s,
            "device_busy_share": busy_s / wall_s if rows else None,
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
    from horovod_tpu_torch.ops.attention import (flash_attention,
                                                 flash_attention_reference)
    from horovod_tpu_torch.ops.paged_attention import (
        paged_attention_reference, paged_decode_attention)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    H, d = LM["n_heads"], 128
    rows = {}
    for T in FLASH_T:
        q, k, v = flash_inputs(T, gen)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, causal=True), reps=5, inner=2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4.0 * d * H * T * (T + 1) / 2
        nbytes = 4.0 * T * H * d * 2
        bnd, by = bound_ms(flops, nbytes, peaks)
        rows[T] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
        emit("timing", kernel="flash_attention", T=T, **rows[T],
             library="torch.nn.functional.scaled_dot_product_attention")
    rng = np.random.RandomState(seed + 3)
    positions = rng.randint(896, 1152, MAX_SLOTS)
    q, kp, vp, tables, pos = paged_inputs(positions, gen)
    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, tables, pos))
    plain = time_ms(lambda: paged_attention_reference(q, kp, vp, tables,
                                                      pos), reps=5, inner=2)
    keys = int((positions + 1).sum())
    flops = 4.0 * d * H * keys
    nbytes = keys * H * d * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4
    bnd, by = bound_ms(flops, nbytes, peaks)
    paged = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                 bound_by=by)
    emit("timing", kernel="paged_decode_attention", keys=keys, **paged,
         library=None)
    return {"flash_attention": rows[max(FLASH_T)],
            "paged_decode_attention": paged}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    try:
        smi = phase_device()
        peaks = peaks_for(smi)
        phase_build()
        errs = phase_parity(args.seed)
        model = build_model(args.seed)
        launches = phase_engine(model, args.seed)
        phase_e2e(model, args.seed)
        del model
        torch.cuda.empty_cache()
        times = phase_timing(args.seed, peaks)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches.get(name, 0),
                    max_abs_err=errs[name], **times[name])
               for name in ("flash_attention", "paged_decode_attention")]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
