"""One rank of a spawned gloo world for tests/test_torch_training.py
(:func:`run`), tests/test_torch_lm_training.py (:func:`run_lm`) and
tests/test_torch_pipeline.py (:func:`run_pp`).

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
