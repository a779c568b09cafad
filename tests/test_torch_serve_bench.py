"""The port's serving bench (``python -m horovod_tpu_torch.serve_bench``)
against the JAX package's ``bin/serve_bench.py``: the same arrival
schedule and prompts draw for draw, the same JSON row keys, the same exit
status, and its digests on JAX's own weights equal to JAX's engine's
(``test_torch_serve_bench_drills.py`` holds the ``ci.sh`` digest drills).
CPU only, on the JAX tool's tiny bench model."""

import concurrent.futures
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch import serve_bench as tsb
from horovod_tpu_torch.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench", os.path.join(REPO, "bin", "serve_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsb = _load_jax_tool()


def _args(*argv):
    """Parsed and checked arguments (the port's parser carries every flag
    of the JAX tool under its name, so both tools read the namespace)."""
    p = tsb.parser()
    args = p.parse_args(["--device", "cpu", "--mode", "generate"]
                        + list(argv))
    tsb.check_args(p, args)
    return args


# -- recording stubs ----------------------------------------------------------

_GEN_STATS = {
    "generation": {"prefix_hits_total": 0, "prefix_misses_total": 0,
                   "prefix_hit_blocks_total": 0},
    "batch_fill_ratio": 0.5, "kv_layout": "paged", "max_slots": 2,
    "max_len": 64, "peak_active_slots": 1, "rejected_slots_full": 0,
    "rejected_blocks_exhausted": 0, "adapters_resident": 1,
    "block_size": 16, "blocks": {"free": 1},
    "fleet": {"n_ready": 1, "n_draining": 0, "replicas": ["r0"],
              "scale_events": {}, "dispatch_total": {},
              "failover_total": {}, "streams_stranded_total": 0,
              "adapter_dispatch": {}, "prefix_dispatch": {}},
    "queue_depth": 0,
}


class _Handle:
    def __init__(self, prompt):
        self._prompt = prompt

    def result(self, timeout=None):
        return {"tokens": [len(self._prompt), 1], "ttft_ms": 1.0,
                "n_tokens": 2, "tokens_per_sec": 10.0}


class _Recorder:
    """An engine that records what is submitted: (tenant, prompt,
    sampling seed, shared-prefix flag)."""

    def __init__(self):
        self.calls = []

    def stats(self):
        return _GEN_STATS

    def submit(self, prompt, **kw):
        s = kw.get("sampling")
        self.calls.append((kw.get("adapter", "base"),
                           tuple(int(t) for t in prompt),
                           None if s is None
                           else (float(s.temperature), int(s.top_k),
                                 int(s.seed)),
                           len(prompt) > 16))
        return _Handle(prompt)

    def counts(self):
        return {"ready": 1, "warming": 0, "draining": 0}


SCHEDULES = {
    "base": (),
    "adapters": ("--adapters", "2", "--adapter-mix", "1,2,3"),
    "adapter_only": ("--adapters", "2", "--adapter-only", "a1"),
    "prefix": ("--prefix-tokens", "24", "--prefix-count", "3",
               "--prefix-mix", "0.4"),
    "sampled": ("--temperature", "0.7", "--top-k", "5", "--adapters",
                "1", "--prefix-tokens", "20", "--prefix-mix", "0.5"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_is_jax_draw_for_draw(name):
    args = _args(*SCHEDULES[name])
    jrec, trec = _Recorder(), _Recorder()
    jrow, _ = jsb.run_gen_point(jrec, 2000.0, 0.03, np.random.RandomState(0),
                                args)
    trow, _ = tsb.run_gen_point(trec, 2000.0, 0.03, np.random.RandomState(0),
                                args)
    assert len(jrec.calls) == jrow["sent"] > 0
    assert trec.calls == jrec.calls
    assert trow["tenant_sent"] == jrow["tenant_sent"]
    # The factored schedule itself: the submitted arrivals, in order.
    sched = [a for a in tsb.gen_arrivals(args, np.random.RandomState(0), 60)
             if a.submit]
    assert [(a.tenant, tuple(a.prompt), a.shared) for a in sched] == \
        [(c[0], c[1], c[3]) for c in jrec.calls]
    seeds = [a.seed for a in sched]
    assert seeds == [None if c[2] is None else c[2][2] for c in jrec.calls]
    if name == "prefix":
        assert any(a.shared for a in sched) and not all(
            a.shared for a in sched)
    if name == "adapter_only":
        assert {c[0] for c in jrec.calls} == {"a1"}


def test_generate_and_fleet_rows_have_jax_keys():
    args = _args("--adapters", "1", "--kv-layout", "paged")
    jrow, jst = jsb.run_gen_point(_Recorder(), 500.0, 0.02,
                                  np.random.RandomState(0), args)
    trow, tst = tsb.run_gen_point(_Recorder(), 500.0, 0.02,
                                  np.random.RandomState(0), args)
    assert set(trow) == set(jrow)
    assert set(trow["tenant_ttft_ms"]) == set(jrow["tenant_ttft_ms"])
    assert trow["stream_digests"] == jrow["stream_digests"]
    jfleet = jsb._fleet_settle(_Recorder(), args, 0, jst)
    tfleet = tsb.fleet_settle(_Recorder(), args, 0, tst)
    assert set(tfleet) == set(jfleet)
    assert tfleet["stream_digests"] == jfleet["stream_digests"]


class _PredictStub:
    def __init__(self):
        self.rows = 0

    def stats(self):
        return {"batch_rows_total": self.rows,
                "batch_live_rows_total": self.rows}

    def submit(self, x):
        self.rows += 1
        fut = concurrent.futures.Future()
        fut.set_result(np.zeros(10, np.float32))
        return fut


def test_predict_row_has_jax_keys():
    jrow = jsb.run_point(_PredictStub(), 1000.0, 0.02,
                         np.random.RandomState(0), (8,))
    trow = tsb.run_point(_PredictStub(), 1000.0, 0.02,
                         np.random.RandomState(0), (8,))
    assert set(trow) == set(jrow)
    assert trow["sent"] == jrow["sent"] == trow["completed"]


def test_digest_needs_python_ints():
    """JAX's digest hashes ``repr`` of int tuples; the port's coerces
    numpy and tensor elements to the same bits."""
    streams = [(5, 3), (1, 2, 7)]
    want = jsb._stream_digest(streams)
    assert tsb.stream_digest(streams) == want
    assert tsb.stream_digest([tuple(np.int64(t) for t in s)
                              for s in streams]) == want
    assert tsb.stream_digest([torch.tensor(s) for s in streams]) == want


# -- exit status -------------------------------------------------------------

def test_exit_zero_and_rows_on_a_clean_run(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert tsb.main(["--device", "cpu", "--mode", "generate", "--qps",
                     "40,80", "--duration", "0.2", "--deadline-ms", "0",
                     "--gen-tokens", "4", "--json", str(out)]) == 0
    rows = [ln for ln in out.read_text().splitlines()]
    assert len(rows) == 2
    assert "SERVE BENCH OK" in capsys.readouterr().out
    assert tsb.main(["--device", "cpu", "--qps", "200", "--duration",
                     "0.2"]) == 0


@pytest.mark.parametrize("mode", ["predict", "generate"])
def test_exit_nonzero_on_an_in_deadline_drop(mode, capsys):
    """A queue of one at a rate far past the engine's rejects requests
    that were still inside their deadline: the gate fails the run."""
    argv = ["--device", "cpu", "--mode", mode, "--qps", "20000",
            "--duration", "0.01", "--max-queue", "1", "--deadline-ms", "0"]
    if mode == "generate":
        argv += ["--slots", "1", "--gen-tokens", "8"]
    else:
        argv += ["--max-batch", "1"]
    assert tsb.main(argv) == 1
    assert "in-deadline requests dropped" in capsys.readouterr().out


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tsb.main(["--mode", "generate"])


def test_jax_argument_checks_hold():
    for argv in (["--adapter-mix", "1,1"], ["--prefix-mix", "0.5"],
                 ["--chaos", "replica_kill=r1@stream=3"],
                 ["--model", "bench_lm", "--model-dim", "128"]):
        with pytest.raises(SystemExit):
            _args(*argv)


# -- digests on JAX's own weights ---------------------------------------------

@pytest.fixture(scope="module")
def jax_tree():
    """JAX's bench weights (``init_params(PRNGKey(0))``) as f32: the
    tests' x64 mode would draw them in f64, the tool draws f32."""
    cfg = jtr.TransformerConfig(**jsb._GEN_MODEL, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jtr.init_params(jax.random.PRNGKey(0),
                                                  cfg))


@pytest.mark.parametrize("variant", [("contiguous",), ("paged",),
                                     ("contiguous", "--spec-k", "2")],
                         ids=["contiguous", "paged", "spec2"])
def test_digests_equal_jax_engine_on_the_same_weights(monkeypatch, jax_tree,
                                                      variant):
    layout, *extra = variant
    args = _args("--kv-layout", layout, "--deadline-ms", "0", "--max-len",
                 "64", *extra)
    f32 = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    monkeypatch.setattr(jtr, "init_params", lambda key, cfg: f32)
    jeng = jsb._build_gen_engine(args)
    teng = tsb.build_gen_engine(args, model=params_from_jax(
        jax_tree, tsb.gen_model_config(args), device="cpu"))
    try:
        for temperature, top_k in ((0.0, 0), (0.8, 20)):
            args.temperature, args.top_k = temperature, top_k
            jrow, _ = jsb.run_gen_point(jeng, 40.0, 0.3,
                                        np.random.RandomState(0), args)
            trow, _ = tsb.run_gen_point(teng, 40.0, 0.3,
                                        np.random.RandomState(0), args)
            assert trow["completed"] == jrow["completed"] == jrow["sent"]
            assert trow["stream_digest"] == jrow["stream_digest"], \
                (temperature, layout, extra)
            assert trow["stream_digests"] == jrow["stream_digests"]
            assert set(trow) == set(jrow)
    finally:
        jeng.shutdown()
        teng.shutdown()
