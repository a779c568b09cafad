"""One rank of a spawned gloo world for tests/test_torch_training.py
(:func:`run`), tests/test_torch_lm_training.py (:func:`run_lm`),
tests/test_torch_pipeline.py (:func:`run_pp`), tests/test_torch_wire.py
(:func:`run_wire`) and tests/test_torch_guard.py (:func:`run_guard`).

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
