"""One rank of a spawned gloo world for the tp serving tests
(tests/test_torch_serve_tp.py, tests/test_torch_serve_tp_parity.py).

Started as a ``spawn`` process with the launcher's environment contract;
it imports only torch and the port. It reads a list of cases from
``<workdir>/cases.pkl``, runs each on a ``tp = world`` mesh — the
generation forwards on this rank's heads (``fwd``), the generation
engine's streams in every layout and feature (``engine``), the
single-shot engine (``single``), a follower killed mid-round (``kill``)
and the refusals (``refuse``) — and writes what it saw to
``<workdir>/rank<r>.pkl`` for the test process to compare against the
JAX functions and engines. The world's collective timeout (``world_s``)
is the step plane's bound on every wait.
"""

import datetime
import os
import pickle
import signal
import time

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfg(c):
    from horovod_tpu_torch.parallel import transformer as ttr
    return ttr.TransformerConfig(**c["dims"], dtype=torch.float32,
                                 unembed_dtype=torch.float32,
                                 attn_backend="xla")


def _model(c, mesh, tree=None):
    from horovod_tpu_torch import convert
    return convert.params_from_jax(c["tree"] if tree is None else tree,
                                   _cfg(c), device="cpu", mesh=mesh)


def _fwd_case(c, mesh):
    """Every generation forward of the contiguous and the paged cache on
    this rank's heads, in the order the test replays on the JAX side."""
    from horovod_tpu_torch.parallel import kv_blocks as tkv
    from horovod_tpu_torch.parallel import transformer as ttr
    cfg = _cfg(c)
    w = ttr.gen_weights(_model(c, mesh))
    L, S = c["length"], len(c["prompts"])
    out = {"coords": dict(mesh.coords)}
    with torch.no_grad():
        cache = ttr.init_kv_cache(cfg, S, c["max_len"], device="cpu",
                                  mesh=mesh)
        out["prefill"] = []
        for s, toks in enumerate(c["prompts"]):
            cache, lg = ttr.prefill(w, _t(toks), cache, s, cfg, length=L)
            out["prefill"].append(_np(lg))
        base = {n: x.clone() for n, x in cache.items()}
        out["decode"] = []
        pos = np.full((S,), L, np.int32)
        for last in c["decode_tokens"]:
            cache, lg = ttr.decode_step(w, _t(last), cache, _t(pos), cfg)
            out["decode"].append(_np(lg))
            pos = pos + 1
        out["cache"] = {n: _np(x) for n, x in cache.items()}
        _, lg = ttr.verify_step(w, _t(c["drafts"]), base,
                                _t(np.full((S,), L, np.int32)), cfg)
        out["verify"] = _np(lg)
        out["verify_cache"] = {n: _np(x) for n, x in base.items()}

        # The paged pool: slot s owns blocks tables[s].
        tables = np.asarray(c["tables"], np.int32)
        for kernel in (False, True):
            pool = tkv.init_paged_kv_cache(cfg, c["n_blocks"], c["bs"], S,
                                           device="cpu", mesh=mesh)
            pre = []
            for s, toks in enumerate(c["prompts"]):
                pool, lg = tkv.paged_prefill(w, _t(toks), pool, s,
                                             _t(tables[s]), cfg, length=L)
                pre.append(_np(lg))
            vbase = {n: x.clone() for n, x in pool.items()}
            dec = []
            pos = np.full((S,), L, np.int32)
            for last in c["decode_tokens"]:
                pool, lg = tkv.paged_decode_step(
                    w, _t(last), pool, _t(pos), _t(tables), cfg,
                    kernel=kernel)
                dec.append(_np(lg))
                pos = pos + 1
            _, vl = tkv.paged_verify_step(
                w, _t(c["drafts"]), vbase, _t(np.full((S,), L, np.int32)),
                _t(tables), cfg, kernel=kernel)
            out[f"paged{int(kernel)}"] = {
                "prefill": pre, "decode": dec, "verify": _np(vl),
                "pool": {n: _np(x) for n, x in pool.items()}}

        # The chunked prefill: a cold prompt, then a hit on its blocks.
        pool = tkv.init_paged_kv_cache(cfg, c["n_blocks"], c["bs"], S,
                                       device="cpu", mesh=mesh)
        ch = []
        for args in c["chunked"]:
            pool, lg = tkv.paged_chunked_prefill(
                w, _t(args["tokens"]), pool, args["slot"],
                _t(args["write_rows"]), _t(args["read_row"]), args["start"],
                cfg, length=args["length"], chunk_blocks=args["cb"])
            ch.append(_np(lg))
        out["chunked"] = ch
        out["chunked_pool"] = {n: _np(x) for n, x in pool.items()}
    return out


def _engine_streams(eng, c, variant):
    """Submit the variant's requests (all at once, or one by one for the
    host tier's pressure) and return each stream's tokens."""
    from horovod_tpu_torch.serve import SamplingParams
    out = []
    requests = variant.get("requests", c["requests"])

    def submit(r):
        sp = SamplingParams(**r["sampling"]) if r.get("sampling") else None
        return eng.submit(r["tokens"], max_new_tokens=r["max_new"],
                          sampling=sp, adapter=r.get("adapter"))
    if variant.get("sequential"):
        for r in requests:
            out.append(submit(r).result(c["timeout"])["tokens"])
    else:
        hs = [submit(r) for r in requests]
        out = [h.result(c["timeout"])["tokens"] for h in hs]
    return out


def _registry(c, mesh):
    from horovod_tpu_torch.parallel.lora import LoraConfig
    from horovod_tpu_torch.serve import AdapterRegistry
    reg = AdapterRegistry(_cfg(c), LoraConfig(**c["lora"]),
                          capacity=len(c["adapters"]), device="cpu",
                          mesh=mesh)
    return reg


def _engine_case(c, mesh):
    """The generation engine on this tp rank, variant by variant: the
    leader's streams and stats; a follower waits for each leader's
    shutdown."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.ops.quant import quantize_tree
    from horovod_tpu_torch.serve import (GenerationConfig, GenerationEngine,
                                         SpecConfig)
    float_model = _model(c, mesh)
    int8_model = None
    out = {}
    for name, variant in c["variants"].items():
        if variant.get("int8"):
            if int8_model is None:
                int8_model = convert.params_from_jax(
                    quantize_tree(c["tree"]), _cfg(c), device="cpu",
                    mesh=mesh)
            model = int8_model
        else:
            model = float_model
        spec = (SpecConfig(k=variant["spec_k"]) if variant.get("spec_k")
                else None)
        reg = None
        if variant.get("lora"):
            reg = _registry(c, mesh)
        eng = GenerationEngine(model, GenerationConfig(**variant["config"]),
                               device="cpu", spec=spec, adapters=reg)
        if not eng.is_leader:
            eng.wait(c["timeout"])
            out[name] = {"follower": True}
            continue
        if reg is not None:
            for a, tree in c["adapters"].items():
                eng.load_adapter(a, tree)
        eng.warmup()
        streams = _engine_streams(eng, c, variant)
        stats = eng.stats()
        eng.shutdown()
        out[name] = {"streams": streams, "stats": stats}
    return out


def _single_case(c, mesh):
    """The single-shot engine over the tp model's full forward: every
    served row, and (after shutdown, on every rank) the same forward of
    each executed batch."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.serve import Engine, ServeConfig
    model = _model(c, mesh)

    def apply_fn(m, x):
        return ttr.forward(m, x)[0]

    eng = Engine(apply_fn, model, item_shape=(c["T"],), item_dtype=np.int64,
                 config=ServeConfig(max_batch=4, batch_timeout_ms=20,
                                    record_executed_batch=True),
                 device="cpu")
    rows, batches = None, None
    if eng.is_leader:
        eng.warmup()
        futs = [eng.submit(x) for x in c["items"]]
        rows = [f.result(c["timeout"]) for f in futs]
        batches = [(f.request.executed_batch, f.request.row) for f in futs]
        eng.shutdown()
    else:
        eng.wait(c["timeout"])
    box = [batches]
    dist.broadcast_object_list(box, src=0)
    again = []
    with torch.inference_mode():
        for batch, row in box[0]:
            again.append(_np(apply_fn(model, torch.from_numpy(batch)))[row])
    return {"rows": rows, "again": again, "leader": eng.is_leader}


def _kill_case(c, mesh):
    """A follower SIGKILLed mid-round: the leader's started streams fail
    with the runtime's error within the plane's timeout, the others and
    every later request are refused (the leader closed)."""
    from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine
    model = _model(c, mesh)
    eng = GenerationEngine(model, GenerationConfig(**c["config"]),
                           device="cpu")
    if not eng.is_leader:
        # Die after the leader's warmup and a few steps of the round.
        while eng._plane.calls < c["kill_after_calls"]:
            time.sleep(0.001)
        os.kill(os.getpid(), signal.SIGKILL)
    eng.warmup()
    t0 = time.monotonic()
    hs = [eng.submit(p, max_new_tokens=c["max_new"]) for p in c["prompts"]]
    errors = []
    for h in hs:
        try:
            h.result(c["timeout"] * 2)
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — the point of the case
            errors.append(type(e).__name__)
    waited = time.monotonic() - t0
    # Whether each stream had started (its first token out) at the death.
    started = [bool(h._tokens) for h in hs]
    # A request after the death fails too, at once.
    try:
        eng.generate(c["prompts"][0], timeout=c["timeout"], max_new_tokens=2)
        late = None
    except Exception as e:  # noqa: BLE001
        late = type(e).__name__
    eng.shutdown(drain=False, timeout=c["timeout"])
    return {"errors": errors, "started": started, "waited": waited,
            "late": late, "plane_error": eng.stats()["tp"]["error"]}


def _refuse_case(c, mesh):
    """What a tp world refuses, and the follower's surface."""
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import make_mesh
    from horovod_tpu_torch.serve import (Engine, GenerationConfig,
                                         GenerationEngine, HttpServer)
    out = {}
    cfg = _cfg(c)

    def err(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return None
    # dp, pp, ep and sp meshes of this world: the engines and the
    # caches refuse them.
    n = mesh.shape["tp"]
    for axes in ({"dp": n}, {"pp": n}, {"ep": n}, {"sp": n}):
        other = make_mesh(axes)
        m = ttr.Transformer(cfg, device="cpu", mesh=other)
        out[f"gen_{list(axes)[0]}"] = err(lambda: GenerationEngine(
            m, GenerationConfig(max_slots=1, max_len=8), device="cpu"))
        out[f"single_{list(axes)[0]}"] = err(lambda: Engine(
            lambda v, x: x, m, item_shape=(2,), device="cpu"))
        out[f"cache_{list(axes)[0]}"] = err(lambda: ttr.init_kv_cache(
            cfg, 1, 8, device="cpu", mesh=other))
    moe_mesh = make_mesh({"ep": mesh.shape["tp"]})
    moe = ttr.Transformer(ttr.TransformerConfig(
        **dict(c["dims"], n_experts=mesh.shape["tp"]), dtype=torch.float32),
        device="cpu", mesh=moe_mesh)
    out["gen_moe"] = err(lambda: GenerationEngine(
        moe, GenerationConfig(max_slots=1, max_len=8), device="cpu"))
    model = _model(c, mesh)
    eng = GenerationEngine(model, GenerationConfig(max_slots=1, max_len=8),
                           device="cpu")
    single = Engine(lambda m, x: ttr.forward(m, x)[0], model,
                    item_shape=(4,), item_dtype=np.int64, device="cpu")
    out["is_leader"] = eng.is_leader
    if eng.is_leader:
        time.sleep(c["idle_s"])         # the followers hear heartbeats
        out["beats"] = eng.stats()["tp"]["beats"]
        t0 = time.monotonic()
        eng.shutdown()
        single.shutdown()
        out["shutdown_s"] = time.monotonic() - t0
    else:
        out["submit"] = err(lambda: eng.submit([1, 2]))
        out["warmup"] = err(eng.warmup)
        out["single_submit"] = err(lambda: single.submit(np.zeros(4)))
        out["http"] = err(lambda: HttpServer(generate=eng))
        out["http_single"] = err(lambda: HttpServer(single))
        t0 = time.monotonic()
        eng.wait(c["timeout"])
        single.wait(c["timeout"])
        out["released_s"] = time.monotonic() - t0
        out["stats"] = eng.stats()["tp"]
    return out


CASES = {"fwd": _fwd_case, "engine": _engine_case, "single": _single_case,
         "kill": _kill_case, "refuse": _refuse_case}


def _arrive(workdir: str, rank: int, world: int, limit: float = 120.0):
    """Wait until every rank has imported the port, so that the
    rendezvous, bounded by the world's (short) timeout, sees no start-up
    skew."""
    open(os.path.join(workdir, f"arrived{rank}"), "w").close()
    deadline = time.monotonic() + limit
    while not all(os.path.exists(os.path.join(workdir, f"arrived{r}"))
                  for r in range(world)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: the other ranks did not start "
                               f"within {limit} s")
        time.sleep(0.01)


def run(rank: int, world: int, port: int, workdir: str,
        world_s: float) -> None:
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    _arrive(workdir, rank, world)
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=world_s))
    out = []
    for c in cases:
        mesh = create_hybrid_mesh(tp=world)
        out.append(CASES[c["kind"]](c, mesh))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    hvd.shutdown()


class World:
    """A spawned gloo world running ``cases`` (:func:`start`)."""

    def __init__(self, world, cases, workdir, timeout, allow_dead, world_s):
        import multiprocessing as mp
        import socket
        self.world, self.n_cases = world, len(cases)
        self.workdir, self.allow_dead = str(workdir), tuple(allow_dead)
        with open(os.path.join(self.workdir, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=run,
                                  args=(r, world, port, self.workdir,
                                        world_s))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self._out = None

    def result(self) -> list:
        """Per case, the list of each rank's result (None for a rank in
        ``allow_dead``). Kills the world and raises when it has not
        finished by its deadline."""
        if self._out is not None:
            return self._out
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive:
            raise TimeoutError(
                f"ranks {alive} of a gloo world of {self.world} did not "
                f"finish {self.n_cases} cases in {self.timeout} s")
        bad = [r for r, p in enumerate(self.procs)
               if p.exitcode != 0 and r not in self.allow_dead]
        if bad:
            raise RuntimeError(
                f"ranks {bad} of a gloo world of {self.world} exited with "
                f"{[self.procs[r].exitcode for r in bad]}")
        ranks = []
        for r in range(self.world):
            if r in self.allow_dead:
                ranks.append(None)
                continue
            with open(os.path.join(self.workdir, f"rank{r}.pkl"),
                      "rb") as f:
                ranks.append(pickle.load(f))
        self._out = [[None if ranks[r] is None else ranks[r][i]
                      for r in range(self.world)]
                     for i in range(self.n_cases)]
        return self._out


def start(world: int, cases: list, workdir, timeout: float = 120,
          allow_dead=(), world_s: float = 60.0) -> World:
    """Start ``cases`` in a gloo world of ``world`` ranks whose
    collectives time out after ``world_s`` seconds (ranks in
    ``allow_dead`` may die without a result); read it with
    :meth:`World.result`, which bounds the wait by ``timeout`` seconds
    from the start."""
    return World(world, cases, workdir, timeout, allow_dead, world_s)
