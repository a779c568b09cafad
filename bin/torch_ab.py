#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one GPU, in turns.

Runs ``chip_smoke.py``'s measuring phases from a base checkout (A, for
example ``git archive`` of the parent commit unpacked into a gitignored
directory) and from this checkout (B) in the order A, B, B, A, each in a
process of its own that builds that checkout's kernels, and appends
every phase's JSON line, tagged with its run, to one file. Times of two
versions are comparable only inside one such call on one card.

    python3 bin/torch_ab.py --base scratch_tree/parent \\
        --out build/ab.jsonl

Phases, in this order: ``train`` (the fused ResNet-50 step alone, first,
before the timing phases' large allocations), ``host`` (only for a
checkout whose ``chip_smoke.py`` has no ``host_ms``, whose ``timing``
phase therefore does not report the host time of a
``flash_attention_prefill`` call: this checkout's ``host_ms`` at the same
T), ``timing``, ``timing_paged`` (this checkout's phase, which times K8
at its four shapes, run on each tree's kernel), ``timing_conv`` (this
checkout's phase, which times K1 and K2 at every ResNet-50 site, run on
each tree's kernels), ``timing_attn``,
``timing_attn_bhtd``, ``lm_train``, ``pp_lm_train``, ``engine`` (two
rounds). Each run may take RUN_TIMEOUT seconds. Needs CUDA; exits
non-zero if any run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

PHASES = ("train", "host", "timing", "timing_paged", "timing_conv",
          "timing_attn", "timing_attn_bhtd", "lm_train", "pp_lm_train",
          "engine", "bench")
RUN_TIMEOUT = 900    # seconds for one run's build and phases
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def own_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module of its own: its
    phases import the kernels from ``sys.path``, that is from the tree
    under test."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_phases(tree: str, tag: str, out_path: str) -> None:
    """Worker: ``tree``'s chip_smoke phases, lines tagged ``tag``."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    out = open(out_path, "a")

    def emit(phase, **kw):
        line = json.dumps({"run": tag, "phase": phase, **kw})
        out.write(line + "\n")
        out.flush()
        print(line, flush=True)
    cs.emit = emit
    own = own_chip_smoke()
    own.emit = emit
    peaks = cs.peaks_for(cs.phase_device())
    cs.phase_build()
    seed = 0
    for name in PHASES:
        if name == "host":
            if hasattr(cs, "host_ms"):
                continue
            from horovod_tpu_torch.ops.attention import \
                flash_attention_prefill
            host_ms = own.host_ms
            gen = torch.Generator(device="cuda").manual_seed(seed + 7)
            for T in cs.FLASH_T:
                q, k, v = cs.flash_inputs(T, gen)
                emit("host", T=T, host_ms_per_call=host_ms(
                    lambda: flash_attention_prefill(q, k, v, causal=True)))
        elif name == "timing":
            cs.phase_timing(seed, peaks)
        elif name == "timing_paged":
            own.phase_timing_paged(seed, peaks)
        elif name == "timing_conv":
            own.phase_timing_conv(seed, peaks)
        elif name == "train":
            import horovod_tpu_torch as hvd
            hvd.init()
            data = cs.synthetic_batch(cs.RN_BATCH, seed)
            report, state = cs.train_run("fused", seed, data)
            emit("train", **report)
            del state, data
            hvd.shutdown()
        elif name == "timing_attn":
            cs.phase_timing_attn(seed, peaks)
        elif name == "timing_attn_bhtd":
            cs.phase_timing_attn_bhtd(seed, peaks)
        elif name == "lm_train":
            cs.phase_lm_train(seed, peaks)
        elif name == "pp_lm_train":
            cs.phase_pp_lm_train(seed, peaks)
        elif name == "engine":
            model = cs.build_model(seed)
            cs.phase_engine(model, seed)
            cs.phase_engine(model, seed)
            del model
        elif name == "bench":
            torch.cuda.empty_cache()
            if not os.path.exists(os.path.join(
                    tree, "horovod_tpu_torch", "bench.py")):
                emit("bench", absent=True)
                continue
            proc = subprocess.run(
                [sys.executable, "-m", "horovod_tpu_torch.bench"],
                cwd=tree, capture_output=True, text=True,
                timeout=RUN_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(f"bench failed: {proc.stderr[-2000:]}")
            for ln in proc.stdout.splitlines():
                if ln.startswith("{"):
                    emit("bench", **json.loads(ln))
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="checkout A (B is the checkout holding this file)")
    ap.add_argument("--out", default="build/ab.jsonl")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    if args.worker:
        run_phases(os.path.abspath(args.worker[0]), args.worker[1], out)
        return 0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    base = os.path.abspath(args.base)
    rc = 0
    for tree, tag in ((base, "A1"), (HERE, "B1"), (HERE, "B2"),
                      (base, "A2")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--base", base,
             "--out", out, "--worker", tree, tag], timeout=RUN_TIMEOUT)
        if proc.returncode != 0:
            print(f"torch_ab: run {tag} ({tree}) failed with "
                  f"{proc.returncode}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
