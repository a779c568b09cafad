"""Pipeline parallelism over ``pp``: GPipe and the 1F1B training schedule.

Port of the JAX package's ``parallel/pipeline.py``: ``gpipe`` (:37) and
``one_f_one_b`` (:84-236). Layers are partitioned into S stages, one per rank of the
mesh's ``pp`` group; activations go to the next stage and cotangents to
the previous one by point-to-point sends over that group
(``batch_isend_irecv``), where the JAX function rides ``ppermute``.

The schedule is the JAX one: on tick ``d`` (of ``M + 2S - 2``) stage
``r`` runs the forward of microbatch ``d - r`` and the backward of
microbatch ``d - (2S - 2 - r)``. Only each in-flight microbatch's input
is kept (a ring of 2S); the backward recomputes the stage forward under
``torch.enable_grad()`` and differentiates it, as ``jax.vjp`` does inside
the JAX loop. Gradients accumulate in ascending microbatch order and are
divided by M at the end.

Masked work is skipped. The JAX loop is lockstep SPMD: every stage
computes a forward and a backward on every tick and masks the results
that fall outside ``[0, M)``, and the last stage's primal forward, whose
output the cyclic handoff gives to stage 0, which drops it. Eager
PyTorch computes neither: bubble ticks do no work, and the last stage
runs its forward only inside the backward's recompute. The results are
those of the JAX function; at one stage this saves a whole forward per
microbatch.

:func:`gpipe` runs microbatches forward through the stages in ``M + S
- 1`` ticks and gives the last stage's outputs to every pp rank (the JAX
function's one-hot sum over pp). It is differentiable: one autograd
function whose backward runs the ticks in reverse, recomputing each
stage forward from its saved input and sending each input cotangent to
the previous stage; the closing sum's backward is a sum of the
cotangents over pp, as JAX transposes ``psum`` under its full-manual
``shard_map``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import runtime


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a tree of dicts (in sorted key order, as JAX
    flattens them), lists and tuples, and the function that rebuilds the
    tree from such a list."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        raise TypeError(f"unsupported parameter tree node {type(tree)}")
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(xs[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return [x for leaves, _ in parts for x in leaves], rebuild


def _exchange(sends, recvs, group) -> None:
    """Post every ``(tensor, peer)`` send and receive of one tick
    together and wait on them."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, mesh, axis_name, x_micro, *leaves):
        S = mesh.shape[axis_name]
        r = mesh.coords[axis_name]
        peers, group = mesh.ranks[axis_name], mesh.groups[axis_name]
        M = x_micro.shape[0]
        params = tree(list(leaves))
        outs = torch.zeros_like(x_micro)
        saved, buf = {}, None
        for t in range(M + S - 1):
            m, act = t - r, None
            if 0 <= m < M:
                inp = x_micro[m] if r == 0 else buf
                saved[m] = inp
                act = stage_fn(params, inp).contiguous()
                if r == S - 1:
                    outs[m] = act
            sends, recvs, buf = [], [], None
            if act is not None and r < S - 1:
                sends.append((act, peers[r + 1]))
            if r > 0 and 0 <= t + 1 - r < M:
                buf = torch.empty_like(x_micro[0])
                recvs.append((buf, peers[r - 1]))
            _exchange(sends, recvs, group)
        if S > 1:   # the last stage's outputs to every rank: a one-hot sum
            if r != S - 1:
                outs.zero_()
            dist.all_reduce(outs, group=group)
        ctx.args = (stage_fn, tree, mesh, axis_name, saved, M)
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        stage_fn, tree, mesh, axis_name, saved, M = ctx.args
        leaves = ctx.saved_tensors
        S = mesh.shape[axis_name]
        r = mesh.coords[axis_name]
        peers, group = mesh.ranks[axis_name], mesh.groups[axis_name]
        g = g_outs.contiguous().clone()
        if S > 1:   # the sum's transpose is a sum of the cotangents
            dist.all_reduce(g, group=group)
        grads = [None] * len(leaves)
        dx = torch.zeros_like(g) if ctx.needs_input_grad[4] else None
        ct_in = None
        for t in reversed(range(M + S - 1)):
            m, din_out = t - r, None
            if 0 <= m < M:
                ct = g[m] if r == S - 1 else ct_in
                want_in = r > 0 or dx is not None
                inp = saved.pop(m).detach().requires_grad_(want_in)
                ps = [p.detach().requires_grad_() for p in leaves]
                with torch.enable_grad():
                    out = stage_fn(tree(ps), inp)
                    gs = torch.autograd.grad(
                        out, ps + ([inp] if want_in else []),
                        grad_outputs=ct, allow_unused=True)
                for i, gi in enumerate(gs[:len(ps)]):
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
                if r == 0 and dx is not None:
                    dx[m] = gs[-1]
                elif r > 0:
                    din_out = gs[-1].contiguous()
            sends, recvs, ct_in = [], [], None
            if din_out is not None:
                sends.append((din_out, peers[r - 1]))
            if r < S - 1 and 0 <= t - 1 - r < M:
                ct_in = torch.empty_like(g[0])
                recvs.append((ct_in, peers[r + 1]))
            _exchange(sends, recvs, group)
        grads = [torch.zeros_like(p) if gi is None else gi
                 for gi, p in zip(grads, leaves)]
        return (None, None, None, None, dx, *grads)


@runtime.maps_peer_failures
def gpipe(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *,
          mesh, axis_name: str = "pp") -> torch.Tensor:
    """Run microbatches through the pipeline (JAX ``gpipe``).

    ``stage_fn(params, act) -> act`` is one stage's computation (the
    same structure on every rank; the output has the input's shape and
    dtype), ``stage_params`` this rank's stage parameters (a tensor, or
    dicts, lists and tuples of tensors), ``x_micro`` the ``[M, mb, ...]``
    microbatches (the same on every pp rank; stage 0 reads them).
    Returns ``[M, mb, ...]``: the last stage's outputs, on every pp rank.
    Differentiable in ``stage_params`` and ``x_micro`` (the latter's
    gradient lands on stage 0); every pp rank must run the backward."""
    leaves, tree = _flatten(stage_params)
    return _GPipe.apply(stage_fn, tree, mesh, axis_name, x_micro, *leaves)


@runtime.maps_peer_failures
def one_f_one_b(stage_fn: Callable, stage_params, x_micro, y_micro,
                loss_fn: Callable, *, mesh, axis_name: str = "pp",
                head_params=None, inject_fn: Optional[Callable] = None,
                input_grad_acc: Optional[Tuple[Any, Callable]] = None,
                return_input_grads: bool = False):
    """One pipelined training step's gradients (the 1F1B schedule).

    Args:
      stage_fn: ``(params, act) -> act``, one stage's computation.
      stage_params: this rank's stage parameters (a tensor, or dicts,
        lists and tuples of tensors); not modified.
      x_micro: ``[M, mb, ...]`` microbatched input (stage 0 reads it);
        with ``inject_fn`` it may be the raw input (token ids).
      y_micro: ``[M, mb, ...]`` labels (the last stage reads them).
      loss_fn: ``(act, y) -> scalar``, or ``(act, y, head_params) ->
        scalar`` with ``head_params``, on the last stage's output.
      mesh: the :class:`~.mesh.Mesh` whose ``axis_name`` group is the
        pipeline (its size is the number of stages S).
      head_params: a loss head's parameters; their gradients are returned
        (non-zero on the last stage: sum over pp to share).
      inject_fn: ``x_micro[i] -> act`` at stage-0 injection (run without
        a gradient; differentiate into it through ``input_grad_acc``).
      input_grad_acc: ``(acc0, update)``: ``update(acc, i, din) -> acc``
        is called on stage 0 once per microbatch with the cotangent of
        its injected input (e.g. a scatter-add into an embedding
        gradient); ``acc / M`` is returned.
      return_input_grads: also return the ``[M, mb, ...]`` cotangents of
        the injected inputs divided by M (non-zero on stage 0).

    Returns ``(loss, grads[, head_grads][, acc][, x_grads])``: the mean
    loss over microbatches (the same on every stage) and this stage's
    parameter gradients of it, each a tree like its parameters.
    """
    S = mesh.shape[axis_name]
    r = mesh.coords[axis_name]
    peers = mesh.ranks[axis_name]
    group = mesh.groups[axis_name]
    M = x_micro.shape[0]
    if inject_fn is None:
        inject_fn = lambda x: x  # noqa: E731
    with_head = head_params is not None
    first, last = r == 0, r == S - 1
    p_leaves, p_tree = _flatten(stage_params)
    h_leaves, h_tree = _flatten(head_params) if with_head else ([], None)
    n_p = len(p_leaves)
    # Gradient sums, in ascending microbatch order; None until the first
    # (0 + g is g, so starting from the first gradient changes nothing).
    grad_acc = [None] * len(p_leaves)
    head_acc = [None] * len(h_leaves)
    ig_acc = input_grad_acc[0] if input_grad_acc is not None else None
    act_like = None                  # a stage input's shape and dtype
    if S > 1 or return_input_grads:
        with torch.no_grad():
            probe = inject_fn(x_micro[0])
        act_like = dict(size=tuple(probe.shape), dtype=probe.dtype,
                        device=probe.device)
        del probe
    xg_buf = None
    if return_input_grads:
        xg_buf = torch.zeros((M, *act_like["size"]), dtype=act_like["dtype"],
                             device=act_like["device"])
    # Only stage 0 hands its input cotangent to anyone (the accumulator);
    # every other stage sends it upstream.
    want_din = not first or input_grad_acc is not None or return_input_grads
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=x_micro.device)
    saved = {}                       # microbatch -> its stage input
    act_in = ct_in = None            # received on the previous tick

    for d in range(M + 2 * S - 2):
        ops, act_out, din_out = [], None, None
        # -- forward of microbatch f = d - r --------------------------------
        f = d - r
        if 0 <= f < M:
            if first:
                with torch.no_grad():
                    x_in = inject_fn(x_micro[f])
            else:
                x_in = act_in
            saved[f] = x_in
            if not last:             # the last stage's output is dead here
                with torch.no_grad():
                    act_out = stage_fn(stage_params, x_in).contiguous()
        # -- backward of microbatch b = d - (2S - 2 - r) --------------------
        b = d - (2 * S - 2 - r)
        if 0 <= b < M:
            a_in = saved.pop(b).detach().requires_grad_(want_din)
            leaves = [p.detach().requires_grad_() for p in p_leaves]
            heads = [h.detach().requires_grad_() for h in h_leaves]
            with torch.enable_grad():
                out = stage_fn(p_tree(leaves), a_in)
                wrt = leaves + ([a_in] if want_din else [])
                if last:
                    if with_head:
                        loss_val = loss_fn(out, y_micro[b], h_tree(heads))
                    else:
                        loss_val = loss_fn(out, y_micro[b])
                    gs = torch.autograd.grad(loss_val, wrt + heads)
                    loss_acc += loss_val.detach().float()
                    _accumulate(head_acc, gs[len(wrt):])
                else:
                    gs = torch.autograd.grad(out, wrt, grad_outputs=ct_in)
            _accumulate(grad_acc, gs[:n_p])
            din = gs[n_p] if want_din else None
            if first and din is not None:
                if input_grad_acc is not None:
                    ig_acc = input_grad_acc[1](ig_acc, b, din)
                if return_input_grads:
                    xg_buf[b] = din
            elif not first:
                din_out = din.contiguous()
            del out, gs
        # -- neighbour exchange: one hop forward, one hop back ---------------
        if act_out is not None:
            ops.append(dist.P2POp(dist.isend, act_out, peers[r + 1], group))
        if din_out is not None:
            ops.append(dist.P2POp(dist.isend, din_out, peers[r - 1], group))
        act_in = ct_in = None
        if not first and 0 <= d + 1 - r < M:
            act_in = torch.empty(**act_like)
            ops.append(dist.P2POp(dist.irecv, act_in, peers[r - 1], group))
        if not last and 0 <= d + 1 - (2 * S - 2 - r) < M:
            ct_in = torch.empty(**act_like)
            ops.append(dist.P2POp(dist.irecv, ct_in, peers[r + 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    loss = loss_acc
    if S > 1:   # the loss lives on the last stage: one-hot sum over pp
        dist.all_reduce(loss, group=group)
    loss = loss / M
    out: tuple = (loss, p_tree(_mean(grad_acc, p_leaves, M)))
    if with_head:
        out += (h_tree(_mean(head_acc, h_leaves, M)),)
    if input_grad_acc is not None:
        out += (ig_acc / M,)
    if return_input_grads:
        out += (xg_buf / M,)
    return out


def _accumulate(acc: List, grads) -> None:
    """``acc[i] += grads[i]``, taking the first gradient as it is (a
    tensor this backward made, or a view of the received cotangent: this
    function's own buffers either way)."""
    for i, g in enumerate(grads):
        acc[i] = g if acc[i] is None else acc[i].add_(g)


def _mean(acc: List, like: List[torch.Tensor], M: int) -> List:
    """The sums divided by M (zeros for a leaf no microbatch reached)."""
    return [torch.zeros_like(p) if a is None else a.div_(M)
            for a, p in zip(acc, like)]
