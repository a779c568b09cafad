"""One rank of a spawned gloo world for the mesh-axis tests
(tests/test_torch_mesh.py, test_torch_mesh_step.py, test_torch_mesh_pp.py).

Started by ``torch.multiprocessing.spawn`` with the launcher's environment
contract; it imports only torch and the port. It reads a list of cases
from ``<workdir>/cases.pkl``, runs each on a mesh over this world — the
tp column/row pair, ring and Ulysses attention, ``moe_ffn``, ``gpipe``
(forwards and gradients), the gradient-sync reference against the
spec-grouped plane, the four-axis LM step, the guard, the pipelined step
with tp and the checkpoint's mesh reshape — and writes what it saw to
``<workdir>/rank<r>.pkl`` for the test process to compare against the
JAX functions.
"""

import datetime
import functools
import os
import pickle

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _axes_case(c, mesh):
    from horovod_tpu_torch.parallel import comm, moe, ring, tp
    from horovod_tpu_torch.parallel.mesh import local_slice
    from horovod_tpu_torch.parallel.pipeline import gpipe
    kind = c["kind"]
    if kind == "tp":
        x = _t(c["x"])
        w1 = _t(local_slice(c["w1"], (None, "tp"), mesh), True)
        w2 = _t(local_slice(c["w2"], ("tp", None), mesh), True)
        out = tp.row_parallel(tp.column_parallel(x, w1), w2, mesh)
        (out * _t(c["cot"])).sum().backward()
        return {"out": _np(out), "g1": _np(w1.grad), "g2": _np(w2.grad)}
    if kind in ("ring", "ulysses"):
        fn = ring.ring_attention if kind == "ring" else ring.ulysses_attention
        q, k, v = (_t(local_slice(c[n], (None, "sp"), mesh), True)
                   for n in "qkv")
        out = fn(q, k, v, mesh=mesh, causal=c["causal"])
        (out * _t(local_slice(c["cot"], (None, "sp"), mesh))).sum().backward()
        return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
                "dv": _np(v.grad)}
    if kind == "moe":
        x = _t(local_slice(c["x"], ("ep", None), mesh), True)
        gate = _t(c["gate"], True)
        w1 = _t(local_slice(c["w1"], ("ep",), mesh)[0], True)
        w2 = _t(local_slice(c["w2"], ("ep",), mesh)[0], True)
        y, aux = moe.moe_ffn(x, gate, w1, w2, mesh=mesh,
                             capacity_factor=c["cf"])
        cot = _t(local_slice(c["cot"], ("ep", None), mesh))
        ((y * cot).sum() + aux).backward()
        expert = torch.softmax((x @ gate).float(), -1).argmax(-1)
        return {"y": _np(y), "aux": float(aux), "expert": expert.numpy(),
                "dx": _np(x.grad), "dgate": _np(gate.grad),
                "dw1": _np(w1.grad), "dw2": _np(w2.grad)}
    if kind == "gpipe":
        w = _t(c["ws"][mesh.coords["pp"]], True)
        x = _t(c["x"], True)
        out = gpipe(lambda p, a: torch.tanh(a @ p), w, x, mesh=mesh)
        loss = comm.pmean((out * out).mean(), mesh.groups["pp"])
        loss.backward()
        return {"out": _np(out), "loss": float(loss), "dw": _np(w.grad),
                "dx": _np(x.grad)}
    raise ValueError(kind)


def _sync_case(c, mesh):
    """``grad_sync_by_spec`` (one collective per leaf) against the
    spec-grouped plane's exchange of the same gradients."""
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    from horovod_tpu_torch.parallel.mesh import grad_sync_by_spec
    rng = np.random.RandomState(100 + mesh.coords.get("dp", 0) * 7
                                + mesh.coords.get("tp", 0))
    params = [torch.nn.Parameter(torch.zeros(s)) for s in c["shapes"]]
    grads = [torch.tensor(rng.randn(*s).astype(np.float32))
             for s in c["shapes"]]
    ref = grad_sync_by_spec(grads, c["specs"], mesh)
    opt = DistributedOptimizer(
        torch.optim.SGD(params, lr=0.0),
        named_parameters=[(f"p{i}", p) for i, p in enumerate(params)],
        mesh=mesh, param_specs=c["specs"], fusion_threshold=c["threshold"])
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt.synchronize()
    return {"ref": [_np(g) for g in ref],
            "plan": [_np(p.grad) for p in params],
            "buckets": opt._grouped.buckets}


def _lm_cfg(c, ttr):
    return ttr.TransformerConfig(**c["dims"], dtype=torch.float32,
                                 unembed_dtype=torch.float32,
                                 attn_backend="xla")


def _step_case(c, mesh):
    """One (or ``steps``) four-axis LM step(s) from the JAX weights;
    the loss and the global parameters after."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.training import shard_for_mesh
    cfg = _lm_cfg(c, ttr)
    init_state, step = ttr.make_parallel_train_step(
        cfg, functools.partial(torch.optim.SGD, lr=c["lr"]), mesh=mesh,
        accum_steps=c.get("accum", 1), wire_dtype=c.get("wire"),
        aux_weight=c.get("aux_weight", 0.01), device="cpu")
    state = init_state(model=convert.params_from_jax(
        c["tree"], cfg, device="cpu", mesh=mesh))
    tok, lab = shard_for_mesh((c["tokens"], c["labels"]), mesh)
    state, loss = step(state, tok, lab)
    return {"loss": float(loss),
            "params": convert.params_to_global(state.model),
            "coords": dict(mesh.coords)}


def _bits(state):
    out = [p.detach().clone() for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        out += [v.detach().clone() for v in st.values()
                if torch.is_tensor(v)]
    return out


def _guard_case(c, mesh):
    """A NaN in one tp rank's gradient of a tp-sharded leaf (the ranks
    at tp 1, dp 0): the step must skip on every rank and leave params
    and optimizer state bit-unchanged; the next clean step trains."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import batch_block
    cfg = _lm_cfg(c, ttr)
    init_state, step = ttr.make_parallel_train_step(
        cfg, functools.partial(torch.optim.Adam, lr=1e-2), mesh=mesh,
        guard_nonfinite=True, device="cpu")
    state = init_state(model=convert.params_from_jax(
        c["tree"], cfg, device="cpu", mesh=mesh))
    tok = batch_block(torch.from_numpy(c["tokens"]), mesh)
    lab = batch_block(torch.from_numpy(c["labels"]), mesh)
    state, _ = step(state, tok, lab)            # state exists
    before = _bits(state)
    hook = None
    if mesh.coords["tp"] == 1 and mesh.coords["dp"] == 0:
        w2 = state.model.layers[0].w2
        def poison(p):
            p.grad.fill_(float("nan"))
        hook = w2.register_post_accumulate_grad_hook(poison)
    state, loss = step(state, tok, lab)
    skipped_loss = float(loss)
    same = all(torch.equal(a, b) for a, b in zip(before, _bits(state)))
    if hook is not None:
        hook.remove()
    state, loss2 = step(state, tok, lab)
    changed = not all(torch.equal(a, b)
                      for a, b in zip(before, _bits(state)))
    return {"skipped_loss": skipped_loss, "same": same,
            "next_loss": float(loss2), "changed": changed}


def _pp_case(c, mesh):
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import pp_transformer as tpp
    from horovod_tpu_torch.parallel import transformer as ttr
    cfg = _lm_cfg(c, ttr)
    init_state, step = tpp.make_pp_transformer_train_step(
        cfg, mesh, functools.partial(torch.optim.SGD, lr=c["lr"]), c["M"],
        guard_nonfinite=c.get("guard", False), device="cpu")
    state = init_state(params=convert.pp_params_from_jax(
        c["tree"], cfg, mesh, device="cpu"))
    n = c["tokens"].shape[0] // mesh.shape["dp"]
    rows = slice(mesh.coords["dp"] * n, (mesh.coords["dp"] + 1) * n)
    state, loss = step(state, torch.from_numpy(c["tokens"][rows]),
                       torch.from_numpy(c["labels"][rows]))
    params, stage = convert.pp_params_to_global(state.params, mesh)
    return {"loss": float(loss), "params": params, "stage": stage,
            "coords": dict(mesh.coords),
            "groups": sorted({s.psum for s in
                              state.optimizer._grouped.syncs}),
            "n_buckets": len(state.optimizer._grouped.buckets)}


def _ckpt_case(c, workdir):
    """Two momentum-SGD steps: the first at dp2×tp2, saved (``save_sharded``
    and the Trainer's ``save_checkpoint``); the second after a restore at
    dp1×tp4 into a model drawn from another seed (each flavour). Then the
    restore into a dp=4 mesh, which must name the axis-name change."""
    from horovod_tpu_torch import convert, trainer
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import batch_block, create_hybrid_mesh
    cfg = _lm_cfg(c, ttr)
    adam = functools.partial(torch.optim.SGD, lr=c["lr"], momentum=0.9)
    d = os.path.join(workdir, "ckpt")
    mesh1 = create_hybrid_mesh(dp=2, tp=2)
    init1, step1 = ttr.make_parallel_train_step(cfg, adam, mesh=mesh1,
                                                device="cpu")
    st = init1(model=convert.params_from_jax(c["tree"], cfg, device="cpu",
                                             mesh=mesh1))
    tok, lab = torch.from_numpy(c["tokens"]), torch.from_numpy(c["labels"])
    st, _ = step1(st, batch_block(tok, mesh1), batch_block(lab, mesh1))
    path = ckpt.save_sharded(d, 1, st.model, st.optimizer)
    verified = ckpt.verify_checkpoint(path)
    st.step = 1
    trainer.save_checkpoint(d + "_trainer", st)
    saved = convert.params_to_global(st.model)

    mesh2 = create_hybrid_mesh(dp=1, tp=4)
    init2, step2 = ttr.make_parallel_train_step(cfg, adam, mesh=mesh2,
                                                device="cpu")
    st2 = init2(seed=9)
    _, _, step_no = ckpt.restore_sharded(d, st2.model, st2.optimizer)
    restored = convert.params_to_global(st2.model)
    st2, loss = step2(st2, batch_block(tok, mesh2), batch_block(lab, mesh2))
    after = convert.params_to_global(st2.model)
    st4 = init2(seed=11)
    trainer.restore_checkpoint(d + "_trainer", st4)
    st4, _ = step2(st4, batch_block(tok, mesh2), batch_block(lab, mesh2))
    trainer_after = convert.params_to_global(st4.model)

    mesh3 = create_hybrid_mesh(dp=4)
    init3, _ = ttr.make_parallel_train_step(cfg, adam, mesh=mesh3,
                                            device="cpu")
    st3 = init3(seed=3)
    try:
        ckpt.restore_sharded(d, st3.model, st3.optimizer)
        axis_error = ""
    except ValueError as e:
        axis_error = str(e)
    world1 = None
    if mesh2.coords["tp"] == 0:
        tree = ckpt.read_checkpoint(ckpt._ckpt_path(d, 1))
        world1 = convert.params_to_numpy(convert.params_from_jax(
            tree["params"], cfg, device="cpu"))
    return {"verified": verified, "step": step_no, "saved": saved,
            "restored": restored, "after": after, "loss": float(loss),
            "axis_error": axis_error, "world1": world1,
            "trainer_step": st4.step, "trainer_after": trainer_after}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    os.environ.update(HVD_RANK=str(rank), HVD_SIZE=str(world),
                      HVD_LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    hvd.init(device="cpu", timeout=datetime.timedelta(seconds=120))
    out = []
    for c in cases:
        if c["kind"] == "ckpt":
            out.append(_ckpt_case(c, workdir))
            continue
        mesh = make_mesh(c["mesh"])
        if c["kind"] == "sync":
            out.append(_sync_case(c, mesh))
        elif c["kind"] == "step":
            out.append(_step_case(c, mesh))
        elif c["kind"] == "guard":
            out.append(_guard_case(c, mesh))
        elif c["kind"] == "pp":
            out.append(_pp_case(c, mesh))
        else:
            out.append(_axes_case(c, mesh))
    hvd.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, cases: list, workdir) -> list:
    """Run ``cases`` in a gloo world of ``world`` ranks; per case the
    list of each rank's result."""
    import socket
    import torch.multiprocessing as mp
    workdir = str(workdir)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(world, port, workdir), nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return [[ranks[r][i] for r in range(world)] for i in range(len(cases))]
