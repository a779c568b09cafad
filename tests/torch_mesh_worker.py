"""One rank of a spawned gloo world for the mesh-axis tests
(tests/test_torch_mesh.py, test_torch_mesh_step.py, test_torch_mesh_pp.py,
test_torch_mesh_zero.py, test_torch_mesh_zero_ckpt.py, test_torch_pp3d.py).

Started by ``torch.multiprocessing.spawn`` with the launcher's environment
contract; it imports only torch and the port. It reads a list of cases
from ``<workdir>/cases.pkl``, runs each on a mesh over this world — the
tp column/row pair, ring and Ulysses attention, ``moe_ffn``, ``gpipe``
(forwards and gradients), the gradient-sync reference against the
spec-grouped plane, the four-axis LM step (with ZeRO and overlap), the
tp MLP on the core stack, the guard, the pipelined step with tp and on
dp×tp×pp, the checkpoints' mesh reshapes (the 2-D canonical ZeRO form,
the pipelined stages) and the sharded serving restore — and writes what
it saw to
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


def _zero_report(opt) -> dict:
    """A ZeRO optimizer's plan and the state elements this rank holds."""
    plan = opt.plan
    return {"shard_axes": [plan.bucket_shard_axes(i)
                           for i in range(len(plan.buckets))],
            "shard_lens": [plan.shard_len(i)
                           for i in range(len(plan.buckets))],
            "canonical_sizes": list(plan.canonical_sizes()),
            "state_elems": [int(st["exp_avg"].numel()) if "exp_avg" in st
                            else int(st["momentum_buffer"].numel())
                            for st in opt.zero_state().inner],
            "nonscatter": plan.nonscatter}


def _step_case(c, mesh):
    """``steps`` (default 1) four-axis LM steps from the JAX weights with
    SGD (``momentum`` optional) and the case's knobs; the losses and the
    global parameters after."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.training import shard_for_mesh
    cfg = _lm_cfg(c, ttr)
    init_state, step = ttr.make_parallel_train_step(
        cfg, functools.partial(torch.optim.SGD, lr=c["lr"],
                               momentum=c.get("momentum", 0.0),
                               foreach=False),
        mesh=mesh, accum_steps=c.get("accum", 1), wire_dtype=c.get("wire"),
        aux_weight=c.get("aux_weight", 0.01), zero=c.get("zero", False),
        overlap=c.get("overlap", False), device="cpu")
    state = init_state(model=convert.params_from_jax(
        c["tree"], cfg, device="cpu", mesh=mesh))
    tok, lab = shard_for_mesh((c["tokens"], c["labels"]), mesh)
    losses = []
    for _ in range(c.get("steps", 1)):
        state, loss = step(state, tok, lab)
        losses.append(float(loss))
    out = {"loss": losses[-1], "losses": losses,
           "params": convert.params_to_global(state.model),
           "coords": dict(mesh.coords),
           "order": state.optimizer.grad_order_source}
    if state.optimizer.zero:
        out["zero"] = _zero_report(state.optimizer)
    return out


class _TpMLP(torch.nn.Module):
    """``tests/test_hybrid.py``'s ``TpMLP`` on a mesh: a column (``w1``)
    and row (``w2``) tp pair with the row product summed over tp, and a
    replicated bias, from the JAX global weights."""

    def __init__(self, tree, mesh):
        super().__init__()
        from horovod_tpu_torch.parallel.mesh import local_slice
        from horovod_tpu_torch.parallel.tp import tp_reduce
        self._reduce = tp_reduce(mesh)
        self.b = torch.nn.Parameter(_t(tree["b"]))
        self.w1 = torch.nn.Parameter(
            local_slice(_t(tree["w1"]), (None, "tp"), mesh).clone())
        self.w2 = torch.nn.Parameter(
            local_slice(_t(tree["w2"]), ("tp", None), mesh).clone())

    def forward(self, x, train=True):
        y = torch.relu(x @ self.w1) @ self.w2
        if self._reduce is not None:
            y = self._reduce(y)
        return y + self.b


def _mlp_case(c, mesh):
    """The core stack (``make_train_step`` + ``DistributedOptimizer(mesh=,
    param_specs=, zero=)``) on the tp MLP: Adam(1e-2) over the case's
    batches, each dp rank feeding its rows; the losses, the global
    parameters and the ZeRO report."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    from horovod_tpu_torch.parallel.mesh import gather_global
    from horovod_tpu_torch.training import TrainState, make_train_step
    model = _TpMLP(c["tree"], mesh)
    named = convert.jax_leaf_order(model)
    tp = "tp" if "tp" in mesh.shape else None
    specs = {"b": (), "w1": (None, tp), "w2": (tp, None)}
    opt = DistributedOptimizer(
        torch.optim.Adam([p for _, p in named], lr=1e-2, foreach=False),
        named_parameters=named, mesh=mesh,
        param_specs=[specs[n] for n, _ in named], zero=c.get("zero", False),
        wire_dtype=c.get("wire"), overlap=c.get("overlap", False))
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(guard_nonfinite=c.get("guard", False))
    dp, d = mesh.shape["dp"], mesh.coords["dp"]
    losses, bad = [], []
    for x, y in c["batches"]:
        n = x.shape[0] // dp
        state, m = step(state, (_t(x[d * n:(d + 1) * n]),
                                torch.from_numpy(y[d * n:(d + 1) * n])))
        losses.append(float(m["loss"]))
        bad.append(float(m.get("bad_step", 0.0)))
    params = {n: _np(gather_global(p, specs[n], mesh)) for n, p in named}
    out = {"losses": losses, "params": params, "bad": bad,
           "coords": dict(mesh.coords),
           "order": opt.grad_order_source}
    if opt.zero:
        out["zero"] = _zero_report(opt)
    return out


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
        guard_nonfinite=True, zero=c.get("zero", False), device="cpu")
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


def _records(path):
    """A checkpoint's manifest leaf records (path, shape, dtype, CRC)."""
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    return ckpt.read_manifest(path)["leaves"]


def _canon(opt):
    from horovod_tpu_torch.optimizer import zero_to_canonical
    return [{k: _np(v) for k, v in st.items() if torch.is_tensor(v)}
            for st in zero_to_canonical(opt.zero_state()).inner]


def _zckpt_case(c, workdir):
    """The hybrid ZeRO checkpoint: one momentum-SGD step at dp2×tp2 with
    ``zero=True``, its 2-D canonical state and this rank's shards, the
    round trip through ``zero_from_canonical``, ``save_sharded`` and
    ``trainer.save_checkpoint``; a second step (the uninterrupted run);
    the restore of each flavour at dp1×tp4 into a model drawn from
    another seed, its canonical state, a re-save (leaf records), one
    step; then the restore into a dp=4 mesh, which must name the axis
    names."""
    from horovod_tpu_torch import convert, trainer
    from horovod_tpu_torch.optimizer import zero_from_canonical
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import batch_block, create_hybrid_mesh
    cfg = _lm_cfg(c, ttr)
    sgd = functools.partial(torch.optim.SGD, lr=c["lr"], momentum=0.9,
                            foreach=False)
    d = os.path.join(workdir, "zckpt")
    tok, lab = torch.from_numpy(c["tokens"]), torch.from_numpy(c["labels"])
    mesh1 = create_hybrid_mesh(dp=2, tp=2)
    init1, step1 = ttr.make_parallel_train_step(cfg, sgd, mesh=mesh1,
                                                zero=True, device="cpu")
    st = init1(model=convert.params_from_jax(c["tree"], cfg, device="cpu",
                                             mesh=mesh1))
    st, _ = step1(st, batch_block(tok, mesh1), batch_block(lab, mesh1))
    live = st.optimizer.zero_state()
    shards = [{k: _np(v) for k, v in s_.items() if torch.is_tensor(v)}
              for s_ in live.inner]
    canon1 = _canon(st.optimizer)
    from horovod_tpu_torch.optimizer import zero_to_canonical
    back = zero_from_canonical(zero_to_canonical(live), live)
    roundtrip = all(torch.equal(a[k], b[k]) for a, b in
                    zip(live.inner, back.inner) for k in a
                    if torch.is_tensor(a[k]))
    path = ckpt.save_sharded(d, 1, st.model, st.optimizer)
    verified = ckpt.verify_checkpoint(path)
    zero_mesh = ckpt.read_manifest(path)["zero_mesh"]
    st.step = 1
    trainer.save_checkpoint(d + "_trainer", st)
    saved = convert.params_to_global(st.model)
    st, loss_a = step1(st, batch_block(tok, mesh1), batch_block(lab, mesh1))
    after_a = convert.params_to_global(st.model)

    mesh2 = create_hybrid_mesh(dp=1, tp=4)
    init2, step2 = ttr.make_parallel_train_step(cfg, sgd, mesh=mesh2,
                                                zero=True, device="cpu")
    st2 = init2(seed=9)
    _, _, step_no = ckpt.restore_sharded(d, st2.model, st2.optimizer)
    restored = convert.params_to_global(st2.model)
    canon2 = _canon(st2.optimizer)
    path2 = ckpt.save_sharded(d + "_again", 1, st2.model, st2.optimizer)
    st2, loss = step2(st2, batch_block(tok, mesh2), batch_block(lab, mesh2))
    after = convert.params_to_global(st2.model)
    st4 = init2(seed=11)
    trainer.restore_checkpoint(d + "_trainer", st4)
    canon4 = _canon(st4.optimizer)
    st4, _ = step2(st4, batch_block(tok, mesh2), batch_block(lab, mesh2))
    trainer_after = convert.params_to_global(st4.model)

    mesh3 = create_hybrid_mesh(dp=4)
    init3, _ = ttr.make_parallel_train_step(cfg, sgd, mesh=mesh3, zero=True,
                                            device="cpu")
    st3 = init3(seed=3)
    errors = []
    try:
        ckpt.restore_sharded(d, st3.model, st3.optimizer)
    except ValueError as e:
        errors.append(str(e))
    try:
        zero_from_canonical(zero_to_canonical(live),
                            st3.optimizer.zero_state())
    except ValueError as e:
        errors.append(str(e))
    return {"verified": verified, "step": step_no, "saved": saved,
            "restored": restored, "after": after, "loss": float(loss),
            "after_a": after_a, "loss_a": float(loss_a),
            "canon1": canon1, "canon2": canon2, "canon4": canon4,
            "shards": shards, "coords": dict(mesh1.coords),
            "roundtrip": roundtrip, "zero_mesh": zero_mesh,
            "records": (_records(path), _records(path2)),
            "errors": errors, "trainer_after": trainer_after}


def _pp_state(c, mesh, zero, seed=None):
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import pp_transformer as tpp
    from horovod_tpu_torch.parallel import transformer as ttr
    cfg = _lm_cfg(c, ttr)
    init, step = tpp.make_pp_transformer_train_step(
        cfg, mesh, functools.partial(torch.optim.SGD, lr=c["lr"],
                                     momentum=0.9, foreach=False),
        c["M"], zero=zero, device="cpu")
    st = init(seed) if seed is not None else init(
        params=convert.pp_params_from_jax(c["tree"], cfg, mesh,
                                          device="cpu"))
    return st, step


def _ppckpt_case(c, workdir):
    """The pipelined stages' checkpoint, with and without ZeRO: one step
    at pp2×tp2, ``save_sharded``; the restore at dp2×pp2×tp1 (the same
    axis names) into stages drawn from another seed and a re-save (leaf
    records); then a restore at pp4, which must give both sizes."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    from horovod_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for zero in (False, True):
        d = os.path.join(workdir, f"ppckpt_{zero}")
        mesh1 = make_mesh({"dp": 1, "pp": 2, "tp": 2})
        st, step = _pp_state(c, mesh1, zero)
        st, _ = step(st, torch.from_numpy(c["tokens"]),
                     torch.from_numpy(c["labels"]))
        canon1 = _canon(st.optimizer) if zero else None
        path = ckpt.save_sharded(d, 1, st.params, st.optimizer)
        saved = ckpt.read_checkpoint(path)["params"]
        gathered, stage = convert.pp_params_to_global(st.params, mesh1)
        mesh2 = make_mesh({"dp": 2, "pp": 2, "tp": 1})
        st2, _ = _pp_state(c, mesh2, zero, seed=5)
        ckpt.restore_sharded(d, st2.params, st2.optimizer)
        restored, stage2 = convert.pp_params_to_global(st2.params, mesh2)
        canon2 = _canon(st2.optimizer) if zero else None
        path2 = ckpt.save_sharded(d + "_again", 1, st2.params,
                                  st2.optimizer)
        mesh3 = make_mesh({"dp": 1, "pp": 4, "tp": 1})
        st3, _ = _pp_state(c, mesh3, zero, seed=6)
        try:
            ckpt.restore_sharded(d, st3.params, st3.optimizer)
            error = ""
        except ValueError as e:
            error = str(e)
        out[zero] = {"saved": {k: np.asarray(v) for k, v in
                               saved["stages"].items()},
                     "gathered": gathered, "stage": stage,
                     "restored": restored, "stage2": stage2,
                     "canon1": canon1, "canon2": canon2,
                     "records": (_records(path), _records(path2)),
                     "error": error}
    return out


def _infer_case(c, workdir):
    """``restore_for_inference`` of a tp=2 model's checkpoint: with
    ``mesh=`` and ``spec_fn=`` (the model's specs), with ``mesh=`` alone
    (replicated) and without (the world-1 form)."""
    from horovod_tpu_torch.parallel import checkpoint as ckpt
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
    cfg = _lm_cfg(c, ttr)
    mesh = create_hybrid_mesh(tp=2)
    init, _ = ttr.make_parallel_train_step(
        cfg, functools.partial(torch.optim.SGD, lr=0.1), mesh=mesh,
        device="cpu")
    st = init(seed=3)
    d = os.path.join(workdir, "infer")
    ckpt.save_sharded(d, 0, st.model, st.optimizer)
    specs = ttr.param_specs(cfg, mesh)

    def spec_fn(path, leaf):
        node = specs
        for k in path[1:]:
            node = node[k]
        return node
    return {"blocks": ckpt.restore_for_inference(d, mesh=mesh,
                                                 spec_fn=spec_fn),
            "replicated": ckpt.restore_for_inference(d, mesh=mesh),
            "full": ckpt.restore_for_inference(d),
            "coords": dict(mesh.coords)}


class _Counts:
    """Calls of the collectives that carry a step's gradients, counted by
    wrapping ``torch.distributed``'s functions."""

    NAMES = ("reduce_scatter_tensor", "all_gather_into_tensor",
             "all_reduce")

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.real = dist, {n: getattr(dist, n)
                                      for n in self.NAMES}
        self.n = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        def wrap(name):
            def counted(*a, **kw):
                self.n[name] += 1
                return self.real[name](*a, **kw)
            return counted
        for name in self.NAMES:
            setattr(self.dist, name, wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.dist, name, fn)


def _pp3d_case(c, mesh):
    """The pipelined step on dp2×tp2×pp2 from JAX's ``init_pp_params``
    weights: two SGD steps plain, with ``overlap`` and with ``zero`` (the
    losses and every stage's global parameters), and the collectives of
    one step under ``zero`` and without, with and without the guard."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.parallel import pp_transformer as tpp
    from horovod_tpu_torch.parallel import transformer as ttr
    cfg = _lm_cfg(c, ttr)
    n = c["tokens"].shape[0] // mesh.shape["dp"]
    rows = slice(mesh.coords["dp"] * n, (mesh.coords["dp"] + 1) * n)
    tok = torch.from_numpy(c["tokens"][rows])
    lab = torch.from_numpy(c["labels"][rows])

    def build(**kw):
        init, step = tpp.make_pp_transformer_train_step(
            cfg, mesh, functools.partial(torch.optim.SGD, lr=c["lr"],
                                         foreach=False),
            c["M"], device="cpu", **kw)
        return init(params=convert.pp_params_from_jax(
            c["tree"], cfg, mesh, device="cpu")), step

    out = {"coords": dict(mesh.coords)}
    for name, kw in (("plain", {}), ("overlap", dict(overlap=True)),
                     ("zero", dict(zero=True))):
        st, step = build(**kw)
        losses = []
        for _ in range(2):
            st, loss = step(st, tok, lab)
            losses.append(float(loss))
        params, stage = convert.pp_params_to_global(st.params, mesh)
        out[name] = {"losses": losses, "params": params, "stage": stage}
        if st.optimizer.zero:
            out[name]["shard_axes"] = [
                st.optimizer.plan.bucket_shard_axes(i)
                for i in range(len(st.optimizer.plan.buckets))]
    counts = {}
    for zero in (False, True):
        for guard in (False, True):
            st, step = build(zero=zero, guard_nonfinite=guard)
            st, _ = step(st, tok, lab)          # groups and state exist
            with _Counts() as k:
                step(st, tok, lab)
            counts[zero, guard] = dict(k.n)
    out["counts"] = counts
    return out


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
        if c["kind"] in ("ckpt", "zckpt", "ppckpt", "infer"):
            fn = {"ckpt": _ckpt_case, "zckpt": _zckpt_case,
                  "ppckpt": _ppckpt_case, "infer": _infer_case}[c["kind"]]
            out.append(fn(c, workdir))
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
        elif c["kind"] == "mlp":
            out.append(_mlp_case(c, mesh))
        elif c["kind"] == "pp3d":
            out.append(_pp3d_case(c, mesh))
        else:
            out.append(_axes_case(c, mesh))
    hvd.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, cases: list, workdir, timeout: float = 600) -> list:
    """Run ``cases`` in a gloo world of ``world`` ranks; per case the
    list of each rank's result. The world is killed, and the call
    raises, when it has not finished within ``timeout`` seconds."""
    import socket
    import time
    import torch.multiprocessing as mp
    workdir = str(workdir)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.spawn(run, args=(world, port, workdir), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"a gloo world of {world} did not finish "
                               f"its {len(cases)} cases in {timeout} s")
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return [[ranks[r][i] for r in range(world)] for i in range(len(cases))]
