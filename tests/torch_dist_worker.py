"""One rank of a spawned gloo world for tests/test_torch_training.py
(:func:`run`), tests/test_torch_lm_training.py (:func:`run_lm`),
tests/test_torch_pipeline.py (:func:`run_pp`), tests/test_torch_wire.py
(:func:`run_wire`), tests/test_torch_guard.py (:func:`run_guard`),
tests/test_torch_collectives.py (:func:`run_collectives`),
tests/test_torch_zero.py (:func:`run_zero`),
tests/test_torch_overlap.py (:func:`run_overlap`) and the checkpoint,
Trainer and callback tests (:func:`run_ckpt`).

Started by ``torch.multiprocessing.spawn`` with the launcher's environment
contract (``HVD_RANK``/``HVD_SIZE``/``HVD_LOCAL_RANK``); it imports only
torch and the port. It reads its inputs from ``<workdir>/inputs.pkl``,
runs every multi-rank check of the test file in one world — two data-
parallel train steps on this rank's shard of the global batch,
``broadcast_parameters`` over differently initialised models,
``broadcast_optimizer_state`` into an optimizer with no state, and the
eager collectives — and writes what it saw to ``<workdir>/rank<r>.pkl``
for the test process to compare against the JAX functions.
"""

import datetime
import functools
import os
import pickle

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def run(rank: int, world: int, port: int, workdir: str) -> None:
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_step)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=120))
    assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (rank, world, rank)
    out = {}
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)

    # Two train steps on this rank's rows of the global batch.
    cfg = ResNetConfig(**inp["cfg"])
    model = convert.resnet_from_jax(inp["variables"], cfg, device="cpu")
    state = create_train_state(model, sgd, device="cpu")
    step = make_train_step()
    n = inp["x"].shape[0] // world
    x = torch.tensor(inp["x"][rank * n:(rank + 1) * n])
    y = torch.tensor(inp["y"][rank * n:(rank + 1) * n])
    losses = []
    for _ in range(2):
        state, metrics = step(state, (x, y))
        losses.append(float(metrics["loss"]))
    out["losses"] = losses
    out["variables"] = convert.resnet_to_numpy(model)
    out["momentum"] = {name: _np(state.optimizer.state[p]["momentum_buffer"])
                       for name, p in model.named_parameters()}

    # broadcast_optimizer_state: rank 0's trained state into a fresh SGD.
    fresh = sgd([p for _, p in convert.jax_leaf_order(model)]) if rank \
        else state.optimizer
    if rank:
        fresh.param_groups[0]["lr"] = 0.5
    hvd.broadcast_optimizer_state(fresh)
    out["bcast_opt_lr"] = fresh.param_groups[0]["lr"]
    out["bcast_momentum"] = {
        name: _np(fresh.state[p]["momentum_buffer"])
        for name, p in model.named_parameters()}

    # broadcast_parameters over differently initialised models.
    other = ResNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(10 + rank))
    hvd.broadcast_parameters(other)
    out["bcast_params"] = {k: _np(v) for k, v in
                           other.state_dict().items()}

    # Eager collectives.
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    out["sum"] = _np(hvd.allreduce(base, average=False))
    out["avg"] = _np(hvd.allreduce(base))
    out["op_sum_ranked"] = _np(hvd.allreduce(base * (rank + 1),
                                             op=hvd.Op.SUM))
    out["max_ranked"] = _np(hvd.allreduce(base * (rank + 1),
                                          op=hvd.Op.MAX))
    out["int_sum"] = hvd.allreduce(torch.arange(5) + rank,
                                   average=False).tolist()
    out["gather"] = _np(hvd.allgather(torch.full((2, 3), float(rank))))
    out["bcast"] = [_np(hvd.broadcast(torch.full((4,), float(rank) + 1),
                                      root_rank=r)) for r in range(world)]
    out["input_untouched"] = bool(torch.equal(
        base, torch.arange(12, dtype=torch.float32).reshape(3, 4)))
    hvd.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_lm(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the LM check of tests/test_torch_lm_training.py: one
    ``make_parallel_train_step`` step (AdamW) on this rank's rows of the
    global batch, from the weights in ``<workdir>/inputs.pkl``; writes
    the world-averaged loss and the updated parameters (as the JAX tree)
    to ``<workdir>/lm_rank<r>.pkl``."""
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel.transformer import (
        TransformerConfig, make_parallel_train_step)

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=120))
    cfg = TransformerConfig(**inp["dims"], dtype=torch.float32,
                            unembed_dtype=torch.float32)
    init_state, step = make_parallel_train_step(
        cfg, functools.partial(torch.optim.AdamW, **inp["adamw"]),
        device="cpu")
    state = init_state(model=convert.params_from_jax(inp["tree"], cfg,
                                                     device="cpu"))
    n = inp["tokens"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    state, loss = step(state, torch.from_numpy(inp["tokens"][rows]),
                       torch.from_numpy(inp["labels"][rows]))
    out = {"loss": float(loss),
           "params": convert.params_to_numpy(state.model)}
    hvd.shutdown()
    with open(os.path.join(workdir, f"lm_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _pp_case(case, np_):
    """One case of :func:`run_pp` on this rank."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    from horovod_tpu_torch.parallel.pipeline import one_f_one_b
    from horovod_tpu_torch.parallel.pp_transformer import \
        make_pp_transformer_train_step
    from horovod_tpu_torch.parallel.transformer import TransformerConfig

    mesh = create_hybrid_mesh(dp=case["dp"], pp=case["pp"])
    if case["kind"] == "1f1b":
        stage = mesh.coords["pp"]
        w = torch.from_numpy(case["ws"][stage])
        x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
        head = case.get("head")
        kw = {}
        if head is not None:
            kw["head_params"] = torch.from_numpy(head)

            def loss_fn(act, yy, h):
                return ((act @ h - yy) ** 2).mean()
        else:
            def loss_fn(act, yy):
                return ((act - yy) ** 2).mean()
        if case["input_grads"]:
            kw["input_grad_acc"] = (torch.zeros_like(x[0]),
                                    lambda acc, i, din: acc.add_(din))
            kw["return_input_grads"] = True
        out = one_f_one_b(lambda p, a: torch.tanh(a @ p), w, x, y, loss_fn,
                          mesh=mesh, **kw)
        return {"stage": stage, "out": [np_(t) for t in out]}
    dt = getattr(torch, case["dtype"])
    cfg = TransformerConfig(**case["dims"], dtype=dt, unembed_dtype=dt,
                            attn_backend=case["backend"])
    init_state, step = make_pp_transformer_train_step(
        cfg, mesh, functools.partial(torch.optim.SGD, lr=case["lr"]),
        case["M"], device="cpu")
    state = init_state(params=convert.pp_params_from_jax(
        case["tree"], cfg, mesh, device="cpu"))
    n = case["tokens"].shape[0] // case["dp"]
    rows = slice(mesh.coords["dp"] * n, (mesh.coords["dp"] + 1) * n)
    state, loss = step(state, torch.from_numpy(case["tokens"][rows]),
                       torch.from_numpy(case["labels"][rows]))
    params, stage = convert.pp_params_to_numpy(state.params, mesh)
    return {"loss": float(loss), "params": params, "stage": stage,
            "dp": mesh.coords["dp"]}


def run_pp(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the pipeline checks of tests/test_torch_pipeline.py:
    every case in ``<workdir>/pp_inputs.pkl`` — ``one_f_one_b`` on the
    toy tanh stage and one ``make_pp_transformer_train_step`` step, each
    on its own dp × pp mesh over this world — in order; writes each
    case's result to ``<workdir>/pp_rank<r>.pkl``."""
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import horovod_tpu_torch as hvd

    with open(os.path.join(workdir, "pp_inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=120))
    out = [_pp_case(case, _np) for case in cases]
    hvd.shutdown()
    with open(os.path.join(workdir, f"pp_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=120))


def run_wire(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of tests/test_torch_wire.py's world: ``fused_allreduce``
    of this rank's slice of every input in ``<workdir>/wire_inputs.pkl``
    under each wire format (and its all-finite flag), then the path each
    format took; writes ``<workdir>/wire_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import fused_allreduce, wire_path

    with open(os.path.join(workdir, "wire_inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        ts = [torch.from_numpy(np.ascontiguousarray(a[rank]))
              for a in case["arrays"]]
        reduced, finite = fused_allreduce(
            ts, average=case["average"], wire_dtype=case["wire"],
            prescale=case["prescale"], fusion_threshold=case["threshold"],
            return_finite=True)
        out[name] = {"reduced": [_np(r) for r in reduced],
                     "finite": bool(finite),
                     "inputs_untouched": all(
                         np.array_equal(t.numpy(), a[rank],
                                        equal_nan=True)
                         for t, a in zip(ts, case["arrays"]))}
    out["paths"] = {w: wire_path(w) for w in ("fp32", "bf16", "fp8")}
    hvd.shutdown()
    with open(os.path.join(workdir, f"wire_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _resnet_state(inp):
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.resnet import ResNetConfig
    from horovod_tpu_torch.training import create_train_state
    model = convert.resnet_from_jax(inp["variables"],
                                    ResNetConfig(**inp["cfg"]),
                                    device="cpu")
    return create_train_state(model, functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9), device="cpu")


def _state_bits(state):
    """Every parameter, momentum buffer and BatchNorm buffer, copied."""
    model, opt = state.model, state.optimizer
    return {"params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "momentum": {n: opt.state[p]["momentum_buffer"].clone()
                         for n, p in model.named_parameters()
                         if "momentum_buffer" in opt.state.get(p, {})},
            "buffers": {n: b.detach().clone()
                        for n, b in model.named_buffers()}}


def _bits_equal(a, b) -> bool:
    return all(a[k].keys() == b[k].keys()
               and all(torch.equal(a[k][n], b[k][n]) for n in a[k])
               for k in a)


def run_guard(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of tests/test_torch_guard.py's world of 2: the ResNet
    step with the guard (a finite step, a step where only rank 0's batch
    holds a NaN image, a finite step); the LM step with the guard (a NaN
    in rank 1's embedding); and the pipelined step on a dp=1 × pp=2 mesh
    with the guard, once with a NaN weight in stage 1 and once with stage
    1's flag forced False (the fold over pp); writes
    ``<workdir>/guard_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    from horovod_tpu_torch.parallel.pp_transformer import \
        make_pp_transformer_train_step
    from horovod_tpu_torch.parallel.transformer import (
        TransformerConfig, make_parallel_train_step)
    from horovod_tpu_torch.training import make_train_step

    with open(os.path.join(workdir, "guard_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}

    # ResNet: finite, NaN on rank 0 only, finite.
    state = _resnet_state(inp)
    step = make_train_step(guard_nonfinite=True)
    n = inp["x"].shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    steps = []
    for x, y in zip(inp["x"], inp["y"]):
        before = _state_bits(state)
        state, m = step(state, (torch.from_numpy(x[rows]),
                                torch.from_numpy(y[rows])))
        steps.append({"loss": float(m["loss"]),
                      "bad_step": float(m["bad_step"]),
                      "unchanged": _bits_equal(before,
                                               _state_bits(state))})
    out["resnet"] = {"steps": steps, "step": state.step,
                     "variables": convert.resnet_to_numpy(state.model)}

    # LM: a NaN in rank 1's embedding poisons its gradients only.
    cfg = TransformerConfig(**inp["lm_dims"], dtype=torch.float32,
                            attn_backend="xla")
    init_state, lm_step = make_parallel_train_step(
        cfg, functools.partial(torch.optim.AdamW, lr=1e-3),
        guard_nonfinite=True, device="cpu")
    lm = init_state(0)
    toks = torch.from_numpy(inp["tokens"][rank])
    lm, _ = lm_step(lm, toks, toks)              # AdamW state exists now
    if rank == 1:
        with torch.no_grad():
            lm.model.embed[int(toks[0, 0])] = float("nan")
    def lm_bits():
        # NaN-safe copies: rank 1 holds the injected NaN on both sides.
        return ([torch.nan_to_num(v).clone()
                 for v in lm.model.state_dict().values()]
                + [v.clone() for st in lm.optimizer.state.values()
                   for v in st.values() if torch.is_tensor(v)])
    before = lm_bits()
    lm, loss = lm_step(lm, toks, toks)
    out["lm"] = {"loss": float(loss),
                 "unchanged": all(torch.equal(a, b) for a, b in
                                  zip(before, lm_bits())),
                 "adam_steps": sorted({float(st["step"]) for st in
                                       lm.optimizer.state.values()})}

    # Pipelined: dp=1 x pp=2, the guard's verdict folded over pp.
    mesh = create_hybrid_mesh(dp=1, pp=2)
    pcfg = TransformerConfig(**inp["lm_dims"], dtype=torch.float32,
                             attn_backend="xla")
    init_pp, pp_step = make_pp_transformer_train_step(
        pcfg, mesh, functools.partial(torch.optim.SGD, lr=0.1), 2,
        guard_nonfinite=True, device="cpu")
    pp_out = {}
    for case in ("nan_stage1", "flag_stage1", "finite"):
        st = init_pp(0)
        if case == "nan_stage1" and rank == 1:
            with torch.no_grad():
                st.params["stages"]["w1"][0, 0, 0] = float("nan")
        if case == "flag_stage1" and rank == 1:
            sync = st.optimizer.synchronize

            def forced(return_finite=False, _sync=sync):
                flag = _sync(return_finite=return_finite)
                return torch.zeros_like(flag) if return_finite else flag
            st.optimizer.synchronize = forced
        before = {k: v.detach().clone() for k, v in
                  _pp_named(st.params)}
        st, loss = pp_step(st, torch.from_numpy(inp["tokens"][0]),
                           torch.from_numpy(inp["tokens"][1]))
        after = dict(_pp_named(st.params))
        pp_out[case] = {
            "loss": float(loss),
            "unchanged": all(torch.equal(torch.nan_to_num(after[k]),
                                         torch.nan_to_num(v))
                             for k, v in before.items())}
    out["pp"] = pp_out
    hvd.shutdown()
    with open(os.path.join(workdir, f"guard_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _pp_named(params):
    """The pipelined step's parameters by name (JAX leaf order)."""
    from horovod_tpu_torch.parallel.pp_transformer import named_leaves
    return named_leaves(params)


def _raises(fn) -> str:
    """The message of the ValueError or NotImplementedError ``fn()``
    raises ("" when it raises none)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def run_collectives(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of tests/test_torch_collectives.py's world: every eager
    collective on this rank's slice of ``<workdir>/coll_inputs.pkl``,
    the async handles redeemed in reverse order, the object collectives,
    the sparse path (``IndexedSlices`` and an ``nn.Embedding(sparse=
    True)`` gradient) and the refusals; writes
    ``<workdir>/coll_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops.sparse import IndexedSlices

    with open(os.path.join(workdir, "coll_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)

    def mine(name):
        return torch.from_numpy(np.ascontiguousarray(inp[name][rank]))

    def raw(t):
        return t.detach().cpu().numpy().copy()
    out = {}
    x = mine("f32")
    out["allreduce"] = {op.name: raw(C.allreduce(x, op=op)) for op in C.Op}
    out["bool"] = {op: raw(C.allreduce(mine("bools"), op=C.Op[op]))
                   for op in ("SUM", "AVERAGE", "MIN", "MAX")}
    out["i16"] = {op: raw(C.allreduce(mine("i16"), op=C.Op[op]))
                  for op in ("SUM", "MAX")}
    out["allgather"] = raw(C.allgather(x))
    out["allgather_var"] = raw(C.allgather(
        torch.from_numpy(inp["var"][rank])))
    out["allgather_scalar"] = raw(C.allgather(torch.tensor(rank + 0.5)))
    out["ragged"] = [raw(t) for t in C.allgather_ragged(
        mine("ragged"), int(inp["valid"][rank]), inp["ragged"].shape[1])]
    out["broadcast"] = [raw(C.broadcast(x, root_rank=r))
                        for r in range(world)]
    out["broadcast_bool"] = raw(C.broadcast(mine("bools"), root_rank=1))
    out["alltoall"] = raw(C.alltoall(mine("a2a")))
    out["reducescatter"] = {op: raw(C.reducescatter(mine("rs"), op=C.Op[op]))
                            for op in ("SUM", "AVERAGE", "MAX")}
    handles = [C.allreduce_async_(x), C.allgather_async_(
        torch.from_numpy(inp["var"][rank])),
        C.broadcast_async_(x, root_rank=world - 1)]
    out["async"] = [raw(C.synchronize(h)) for h in reversed(handles)][::-1]
    out["async_again"] = raw(C.synchronize(handles[0]))
    out["broadcast_object"] = C.broadcast_object(
        {"rank": rank, "epoch": 7 * rank}, root_rank=1)
    out["allgather_object"] = C.allgather_object(["x"] * rank)
    out["grouped"] = [raw(t) for t in C.grouped_allreduce(
        [torch.from_numpy(np.ascontiguousarray(a[rank]))
         for a in inp["group"]], fusion_threshold=64)]
    sl = IndexedSlices(mine("values"), mine("indices"), inp["dense_shape"])
    red = C.allreduce(sl)
    out["slices"] = (raw(red.values), raw(red.indices), red.dense_shape)
    out["slices_sum"] = raw(C.allreduce(sl, average=False).values)

    emb = torch.nn.Embedding(10, 4, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(inp["emb"]))
    emb(torch.from_numpy(inp["tokens"][rank])).pow(2).sum().backward()
    g = emb.weight.grad
    s = IndexedSlices.from_sparse_coo(g)
    out["emb"] = {"is_sparse": g.is_sparse,
                  "roundtrip": torch.equal(s.to_sparse_coo().to_dense(),
                                           g.to_dense()),
                  "sparse_avg": raw(C.allreduce(s).to_dense()),
                  "dense_avg": raw(C.allreduce(g.to_dense()))}

    ref = {}
    ref["bad_root"] = _raises(lambda: C.broadcast(x, root_rank=world))
    ref["bad_root_async"] = _raises(
        lambda: C.broadcast_async_(x, root_rank=-1))
    ref["bad_root_object"] = _raises(
        lambda: C.broadcast_object(1, root_rank=world))
    ref["ragged_shapes"] = _raises(
        lambda: C.allgather(torch.zeros(2, 3 + rank)))
    ref["ragged_rows"] = _raises(
        lambda: C.allgather_ragged(torch.zeros(5, 3), 2, 4))
    ref["ragged_valid"] = _raises(
        lambda: C.allgather_ragged(torch.zeros(4, 3), 5, 4))
    ref["sparse_op"] = _raises(lambda: C.allreduce(sl, op=C.Op.MAX))
    ref["alltoall_rows"] = _raises(
        lambda: C.alltoall(torch.zeros(world + 1, 2)))
    ref["alltoall_axis"] = _raises(
        lambda: C.alltoall(torch.zeros(world, 2), split_axis=1))
    ref["reducescatter_rows"] = _raises(
        lambda: C.reducescatter(torch.zeros(world + 1, 2)))
    out["refusals"] = ref
    out["after_refusals"] = raw(C.allreduce(x, average=False))
    out["process"] = (hvd.process_index(), hvd.process_count())
    out["compression"] = _compression_cases(inp, rank)
    hvd.shutdown()
    with open(os.path.join(workdir, f"coll_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _compression_cases(inp, rank) -> dict:
    """``Compression.bf16`` against ``wire_dtype="bf16"`` on both planes:
    the exchanged gradients of the same per-rank inputs, and the
    refusals of a contradicting ``wire_dtype``."""
    import horovod_tpu_torch as hvd

    def exchange(zero, **kw):
        params = [torch.nn.Parameter(torch.zeros(a.shape[1:]))
                  for a in inp["comp"]]
        for p, a in zip(params, inp["comp"]):
            p.grad = torch.from_numpy(a[rank].copy())   # reduced in place
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.0),
            [(f"p{i}", p) for i, p in enumerate(params)],
            fusion_threshold=1 << 20, zero=zero, **kw)
        opt.synchronize()
        return [p.grad.detach().numpy().copy() for p in params]
    out = {}
    for zero in (False, True):
        out[zero] = {
            "compression": exchange(zero,
                                    compression=hvd.Compression.bf16),
            "wire": exchange(zero, wire_dtype="bf16"),
            "none": exchange(zero, compression=hvd.Compression.none)}
    out["alias"] = exchange(True, compression=hvd.Compression.bf16,
                            wire_dtype="bf16")
    out["refusals"] = {
        "both": _raises(lambda: exchange(
            False, compression=hvd.Compression.bf16, wire_dtype="bf16")),
        "zero_fp8": _raises(lambda: exchange(
            True, compression=hvd.Compression.bf16, wire_dtype="fp8")),
        "unknown": _raises(lambda: exchange(False, compression=object()))}
    return out


class _Counter:
    """Counts the calls of each ``torch.distributed`` collective the port
    makes while it is entered (module attributes are patched; the port
    looks them up at call time)."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "all_gather", "broadcast", "all_to_all_single")

    def __enter__(self):
        import torch.distributed as dist
        self.counts = dict.fromkeys(self.NAMES, 0)
        self._saved = {n: getattr(dist, n) for n in self.NAMES}

        def wrap(name, fn):
            def counted(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return counted
        for n, fn in self._saved.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self._saved.items():
            setattr(dist, n, fn)


class _MLP(torch.nn.Module):
    """Dense layers of ``widths`` with relu between them over 8 features
    (default Dense(16) → relu → Dense(10): the JAX ZeRO tests' model;
    the overlap tests take three Dense(64) before it, as JAX's), f32,
    from a seed."""

    def __init__(self, seed: int = 0, widths=(16, 10)):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        dims = (8,) + tuple(widths)
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x, train=True):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == 0 else layer(torch.relu(x))
        return x


OPTS = {
    "sgd": functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                             foreach=False),
    "adam": functools.partial(torch.optim.Adam, lr=1e-2, foreach=False),
    "adamw": functools.partial(torch.optim.AdamW, lr=1e-2,
                               weight_decay=0.01, foreach=False),
}


def _mlp_run(opt, zero, batches, rows, accum=1, guard=False, threshold=300,
             overlap=False, wire=None, widths=(16, 10), remat=False,
             count=False, nan_step=None):
    """Steps of the MLP from seed 0 on this rank's ``rows`` of each
    global batch (rank 0's first row NaN at step ``nan_step``); returns
    (state, per-step metrics) — with ``count``, each step's collective
    counts under "counts" and whether it left params and optimizer state
    bit-unchanged under "unchanged"."""
    from horovod_tpu_torch.training import create_train_state, make_train_step
    state = create_train_state(_MLP(widths=widths), OPTS[opt], zero=zero,
                               overlap=overlap, fusion_threshold=threshold,
                               wire_dtype=wire, device="cpu")
    step = make_train_step(accum_steps=accum, guard_nonfinite=guard,
                           remat=remat)
    ms = []
    for i, (x, y) in enumerate(batches):
        x = x[rows].copy()
        if i == nan_step and torch.distributed.get_rank() == 0:
            x[0, 0] = np.nan
        before = _state_words(state) if count else None
        with _Counter() as c:
            state, m = step(state, (torch.from_numpy(x),
                                    torch.from_numpy(y[rows])))
        ms.append({k: float(v) for k, v in m.items()})
        if count:
            ms[-1]["counts"] = c.counts
            ms[-1]["unchanged"] = all(torch.equal(a, b) for a, b in
                                      zip(before, _state_words(state)))
    return state, ms


def _state_words(state):
    """Params and every optimizer-state tensor (either plane), copied."""
    opt = state.optimizer
    st = (opt.zero_state().inner if opt.zero
          else [opt.state.get(p, {}) for p in state.model.parameters()])
    return ([p.detach().clone() for p in state.model.parameters()]
            + [v.clone() for d in st for v in d.values()
               if torch.is_tensor(v)])


def _params_np(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def run_zero(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of tests/test_torch_zero.py's world: ``fused_reduce_
    scatter`` and ``fused_allgather_params`` on this rank's slice of each
    case of ``<workdir>/zero_inputs.pkl``; the MLP's ZeRO and replicated
    steps under three optimizers, with accumulation, and with the guard
    (a NaN on rank 0's rows), with the collectives of a step counted; the
    tiny LM's ZeRO and replicated steps; the canonical form (saved to
    ``<workdir>/canonical.pkl``, or restored from ``inp["restore"]``);
    writes ``<workdir>/zero_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion as F
    from horovod_tpu_torch.optimizer import (zero_from_canonical,
                                             zero_to_canonical)
    from horovod_tpu_torch.parallel.transformer import (
        TransformerConfig, make_parallel_train_step)

    with open(os.path.join(workdir, "zero_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"cases": {}}
    for name, case in inp["cases"].items():
        ts = [torch.from_numpy(np.ascontiguousarray(a[rank]))
              for a in case["arrays"]]
        plan = F.plan_zero(ts, world, case["threshold"])
        shards, local = F.fused_reduce_scatter(
            ts, plan, average=case["average"], prescale=case["prescale"],
            return_finite=True, wire_dtype=case["wire"])
        leaves, everywhere = F.fused_allgather_params(shards, plan,
                                                      and_finite=local)
        out["cases"][name] = {"shards": [_np(s) for s in shards],
                              "local": bool(local),
                              "gathered": [_np(t) for t in leaves],
                              "all_finite": bool(everywhere)}

    n = inp["x"].shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    batches = list(zip(inp["x"], inp["y"]))
    runs = {}
    for opt in OPTS:
        for zero in (False, True):
            state, ms = _mlp_run(opt, zero, batches, rows)
            runs[(opt, zero)] = {"params": _params_np(state.model),
                                 "losses": [m["loss"] for m in ms]}
            if zero:
                st = state.optimizer.zero_state()
                runs[(opt, zero)]["state_elems"] = {
                    k: sum(s[k].numel() for s in st.inner)
                    for k in st.inner[0] if st.inner[0][k].dim() == 1}
                runs[(opt, zero)]["shard_len"] = [
                    st.plan.shard_len(i) for i in range(len(st.plan.buckets))]
                if opt == "adamw":
                    adamw_state = state
    for zero in (False, True):
        state, ms = _mlp_run("adamw", zero, batches[:1], rows, accum=2)
        runs[("accum", zero)] = {"params": _params_np(state.model),
                                 "losses": [m["loss"] for m in ms]}
    out["runs"] = runs

    # The guard: finite, NaN on rank 0's rows, finite.
    from horovod_tpu_torch.training import create_train_state, make_train_step
    state = create_train_state(_MLP(), OPTS["adamw"], zero=True,
                               fusion_threshold=300, device="cpu")
    guarded = make_train_step(guard_nonfinite=True)
    steps = []
    for i, (x, y) in enumerate(batches):
        x = x[rows].copy()
        if i == 1 and rank == 0:
            x[0, 0] = np.nan
        before = _state_words(state)
        with _Counter() as c:
            state, m = guarded(state, (torch.from_numpy(x),
                                       torch.from_numpy(y[rows])))
        steps.append({"bad_step": float(m["bad_step"]),
                      "loss": float(m["loss"]), "counts": c.counts,
                      "unchanged": all(torch.equal(a, b) for a, b in
                                       zip(before, _state_words(state)))})
    plain = make_train_step()
    with _Counter() as c:
        plain(state, (torch.from_numpy(batches[0][0][rows]),
                      torch.from_numpy(batches[0][1][rows])))
    out["guard"] = {"steps": steps, "plain_counts": c.counts,
                    "n_buckets": len(state.optimizer.plan.buckets)}

    # The tiny LM: the spec-grouped plan of the dp mesh.
    cfg = TransformerConfig(**inp["lm_dims"], dtype=torch.float32,
                            attn_backend="xla")
    lm = {}
    for zero in (False, True):
        init_state, lm_step = make_parallel_train_step(
            cfg, OPTS["adamw"], zero=zero, fusion_threshold=20_000,
            device="cpu")
        st = init_state(0)
        for toks in inp["tokens"]:
            st, loss = lm_step(st, torch.from_numpy(toks[rows]),
                               torch.from_numpy(toks[rows]))
        lm[zero] = {"params": _params_np(st.model), "loss": float(loss)}
        if zero:
            plan = st.optimizer.plan
            lm["plan"] = (plan.scatter_axis, plan.denoms, len(plan.buckets))
    out["lm"] = lm

    # The canonical form: round trip, then save or restore.
    opt = adamw_state.optimizer
    canon = zero_to_canonical(opt.zero_state())
    opt.load_zero_state(zero_from_canonical(canon, opt.zero_state()))
    out["roundtrip"] = all(
        torch.equal(a, b) for a, b in zip(
            [v for st in zero_to_canonical(opt.zero_state()).inner
             for v in st.values()],
            [v for st in canon.inner for v in st.values()]))
    out["canonical"] = [{k: _np(v) for k, v in st.items()}
                        for st in canon.inner]
    if inp.get("restore"):
        with open(inp["restore"], "rb") as f:
            saved = pickle.load(f)
        from horovod_tpu_torch.optimizer import ZeroShardedState
        state, _ = _mlp_run("adamw", True, [], rows)
        opt = state.optimizer
        loaded = zero_from_canonical(
            ZeroShardedState(inner=[{k: torch.from_numpy(v)
                                     for k, v in st.items()}
                                    for st in saved], plan=opt.plan),
            opt.zero_state())
        opt.load_zero_state(loaded)
        out["restored"] = {
            "shards": [{k: _np(v) for k, v in st.items()}
                       for st in opt.zero_state().inner],
            "canonical": [{k: _np(v) for k, v in st.items()} for st in
                          zero_to_canonical(opt.zero_state()).inner],
            "plan": (opt.plan.padded, [opt.plan.shard_len(i) for i in
                                       range(len(opt.plan.buckets))])}
    elif rank == 0:
        with open(os.path.join(workdir, "canonical.pkl"), "wb") as f:
            pickle.dump(out["canonical"], f)
    hvd.shutdown()
    with open(os.path.join(workdir, f"zero_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_overlap(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of tests/test_torch_overlap.py's world: the overlapped
    step against the plain one on the MLP of three Dense(64) (f32,
    AdamW) — regrouped buckets and one bucket per leaf, with ZeRO, with
    accumulation, with remat, with the guard and a bf16 wire (a NaN on
    rank 0's rows) — the collectives of each step counted, the probed
    order, and a backward left in flight then drained; writes
    ``<workdir>/overlap_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd

    with open(os.path.join(workdir, "overlap_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    n = inp["x"].shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    batches = list(zip(inp["x"], inp["y"]))
    wide = dict(widths=(64, 64, 64, 10), threshold=inp["threshold"])
    variants = {
        "plain": dict(), "overlap": dict(overlap=True),
        "plain_t0": dict(threshold=0), "overlap_t0": dict(threshold=0,
                                                          overlap=True),
        "zero": dict(zero=True), "zero_overlap": dict(zero=True,
                                                      overlap=True),
        "accum": dict(accum=2), "accum_overlap": dict(accum=2,
                                                      overlap=True),
        "accum_t0": dict(accum=2, threshold=0),
        "accum_overlap_t0": dict(accum=2, threshold=0, overlap=True),
        "remat": dict(remat=True), "remat_overlap": dict(remat=True,
                                                         overlap=True),
        "guard_bf16": dict(guard=True, wire="bf16", nan_step=1),
        "guard_bf16_overlap": dict(guard=True, wire="bf16", nan_step=1,
                                   overlap=True),
        "zero_guard_bf16_overlap": dict(zero=True, guard=True, wire="bf16",
                                        nan_step=1, overlap=True),
    }
    out = {}
    for name, kw in variants.items():
        kw = {**wide, **kw}
        zero = kw.pop("zero", False)
        state, ms = _mlp_run("adamw", zero, batches, rows, count=True, **kw)
        opt = state.optimizer
        out[name] = {"params": _params_np(state.model), "steps": ms,
                     "order": opt.grad_order,
                     "source": opt.grad_order_source}
    # A backward armed with no exchange after it, drained at zero_grad.
    state, _ = _mlp_run("adamw", False, batches[:1], rows, overlap=True,
                        widths=(64, 64, 64, 10),
                        threshold=inp["threshold"])
    opt = state.optimizer
    opt.zero_grad()
    opt.arm()
    state.model(torch.from_numpy(batches[0][0][rows])).sum().backward()
    in_flight = len(opt._overlap._pending)
    opt.zero_grad()
    out["drain"] = {"in_flight": in_flight,
                    "after": len(opt._overlap._pending),
                    "armed": opt._overlap.armed}
    hvd.shutdown()
    with open(os.path.join(workdir, f"overlap_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ckpt(world: int, workdir, inp: dict) -> list:
    """Write ``inp`` to ``<workdir>/ckpt_inputs.pkl``, run :func:`run_ckpt`
    in a gloo world of ``world`` spawned processes, and return each
    rank's output."""
    import socket
    import torch.multiprocessing as mp
    with open(os.path.join(workdir, "ckpt_inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(run_ckpt, args=(world, port, str(workdir)), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"ckpt_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def zero_canonical_for(plan, seed: int = 7):
    """A seeded canonical AdamW ZeRO state for ``plan``'s buckets (the
    same bytes at every world size: only the unpadded sizes are read)."""
    rng = np.random.RandomState(seed)
    return [{"exp_avg": rng.randn(n).astype(np.float32),
             "exp_avg_sq": rng.rand(n).astype(np.float32),
             "step": np.asarray(3.0, np.float32)} for n in plan.sizes]


def run_ckpt(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the checkpoint/Trainer tests' world, each part gated
    by ``<workdir>/ckpt_inputs.pkl``: ``Trainer.fit`` with the warmup
    callback on the CIFAR ResNet (history and lr per batch);
    ``MetricAverageCallback``; ``restore_checkpoint`` where each rank
    reads its own directory; a ZeRO MLP state loaded from a seeded
    canonical form and written with ``save_sharded`` (and, with
    ``restore_from``, another world's checkpoint restored with
    ``restore_sharded``); ``process_index``/``process_count``. Writes
    ``<workdir>/ckpt_rank<r>.pkl``."""
    _join(rank, world, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.resnet import ResNetConfig
    from horovod_tpu_torch.optimizer import (ZeroShardedState,
                                             zero_from_canonical)
    from horovod_tpu_torch.parallel.checkpoint import (read_manifest,
                                                       restore_sharded,
                                                       save_sharded)
    from horovod_tpu_torch.trainer import Trainer, restore_checkpoint
    from horovod_tpu_torch.training import create_train_state, make_train_step

    with open(os.path.join(workdir, "ckpt_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"process": (hvd.process_index(), hvd.process_count())}
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)

    def resnet_state(variables, opt=sgd):
        model = convert.resnet_from_jax(variables,
                                        ResNetConfig(**inp["cfg"]),
                                        device="cpu")
        return create_train_state(model, opt, device="cpu")

    if "fit" in inp:
        state = resnet_state(inp["variables"], functools.partial(
            torch.optim.SGD, **inp["fit"]["sgd"]))
        lrs = []

        class Spy(cb.Callback):
            def on_batch_begin(self, batch, logs=None):
                g = self.trainer.state.optimizer.param_groups[0]
                lrs.append((g["lr"], g["momentum"]))
        trainer = Trainer(make_train_step(), state,
                          steps_per_epoch=inp["fit"]["steps"], verbose=False)
        out["history"] = trainer.fit(
            lambda: inp["fit"]["batches"], epochs=inp["fit"]["epochs"],
            callbacks=[cb.BroadcastGlobalVariablesCallback(0),
                       cb.LearningRateWarmupCallback(
                           warmup_epochs=inp["fit"]["warmup"]), Spy()])
        out["lrs"] = lrs

    logs = {"loss": float(rank + 1), "acc": 0.25 * rank, "name": "x"}
    cb.MetricAverageCallback().on_epoch_end(0, logs)
    out["metric_average"] = logs

    if "restore_dirs" in inp:
        state = resnet_state(inp["variables"])
        restore_checkpoint(inp["restore_dirs"][rank], state)
        out["restored"] = {
            "variables": convert.resnet_to_numpy(state.model),
            "momentum": [_np(state.optimizer.state[p]["momentum_buffer"])
                         for _, p in state.optimizer.named_parameters],
            "lr": state.optimizer.param_groups[0]["lr"],
            "step": state.step}

    state = create_train_state(_MLP(), OPTS["adamw"], zero=True,
                               fusion_threshold=300, device="cpu")
    opt = state.optimizer
    canon = ZeroShardedState(
        inner=[{k: torch.from_numpy(v) for k, v in st.items()}
               for st in zero_canonical_for(opt.plan)], plan=opt.plan)
    opt.load_zero_state(zero_from_canonical(canon, opt.zero_state()))
    path = save_sharded(os.path.join(workdir, f"zero_w{world}"), 5,
                        state.model, opt)
    out["zero_manifest"] = read_manifest(path)
    if "restore_from" in inp:
        fresh = create_train_state(_MLP(seed=1), OPTS["adamw"], zero=True,
                                   fusion_threshold=300, device="cpu")
        _, _, step = restore_sharded(inp["restore_from"], fresh.model,
                                     fresh.optimizer)
        out["zero_restored"] = {
            "step": step, "params": _params_np(fresh.model),
            "shards": [{k: _np(v) for k, v in st.items()}
                       for st in fresh.optimizer.zero_state().inner],
            "padded": fresh.optimizer.plan.padded}
    hvd.shutdown()
    with open(os.path.join(workdir, f"ckpt_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
