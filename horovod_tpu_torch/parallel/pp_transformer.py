"""The pipelined transformer LM: dp × pp × tp over one mesh.

Port of the JAX package's ``parallel/pp_transformer.py`` for the dp × pp
× tp mesh (:func:`~.mesh.create_hybrid_mesh`). The layers are split into ``pp`` stages driven by the 1F1B
schedule (:func:`~.pipeline.one_f_one_b`); data parallelism splits the
batch over ``dp``. The embedding and the loss head (final RMSNorm and
the tied unembedding) live outside the pipeline: stage 0 embeds each
microbatch as it injects it, and the embedding gradient is the head's
unembedding gradient (last stage) plus the scatter-add of the input
cotangents (stage 0), summed over pp.

Each block is the data-parallel model's layer (:func:`~.transformer.
_layer`: bf16 projections of f32 weights, f32 RMSNorm statistics,
tanh-GELU) with its attention on :func:`~..ops.attention.
flash_attention` under ``cfg.attn_backend``: at the default "pallas" a
tilable layer runs the ``[B, T, H, D]`` flash forward with lse and the dq
and dk/dv kernels in the backward's recompute. Under tp each stage holds
the Megatron blocks of its layers (:func:`pp_param_specs`), attends over
its ``n_heads / tp`` heads and sums the products of ``wo`` and ``w2``
over the stage's tp group (:mod:`.tp`).

``cfg.remat`` checkpoints each block inside the stage (keeping its matmul
outputs) and ``cfg.loss_chunk`` takes the head's loss in vocab chunks
(:func:`~.transformer.chunked_nll`).

Gradient sync is the spec-grouped all-reduce plane
(``DistributedOptimizer(mesh=, param_specs=, skip_axes=("pp",))``:
:func:`~..ops.fusion.plan_grad_sync` over :func:`pp_param_specs`, each
stage owning its weights). Without tp every leaf sums over dp, one
group; with tp the replicated head and norm leaves sum over ``(dp,
tp)`` and the tp-sharded matrices over dp with the tp correction in
their prescale — two groups, bucketed in the JAX leaf order. Under
``zero`` it is the hybrid ZeRO plane with nothing skipped, as JAX
builds it: pp rides as a real shard axis of the state, so on (dp, pp,
tp) there are three groups — the replicated head (reduced over dp, then
summed over (pp, tp) on its shard), the pp-owned norms and the pp×tp
matrices —, one reduce-scatter and one all-gather over dp each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..optimizer import DistributedOptimizer
from ..utils import config as _config
from .mesh import local_slice
from .pipeline import one_f_one_b
from .tp import tp_reduce
from .transformer import (TransformerConfig, _layer, _logits, attend_heads,
                          check_dense, chunked_nll, dense_nll, remat_layer,
                          rms_norm)

_STAGE_KEYS = ("ln1", "ln2", "w1", "w2", "wo", "wqkv")   # JAX (sorted) order
_PROJ = ("wqkv", "wo", "w1", "w2")


def init_pp_params(generator: torch.Generator, cfg: TransformerConfig,
                   n_stages: int, stage: int, *, mesh=None,
                   device: DeviceLike = "cuda") -> Dict:
    """This stage's parameters in the pipeline layout (JAX
    ``init_pp_params``): ``{"embed", "lnf", "stages": {leaf: [lps,
    ...]}}``, the stage's slice of the per-layer weights stacked as
    ``[n_stages, lps, ...]``, with the JAX scales (embedding N(0, 0.02²),
    projections N(0, 1/fan_in), norm scales 1). Every rank draws the full
    stacks from ``generator`` (a ``torch.Generator`` on ``device``, seeded
    alike on every rank), so the head is the same on every stage. On a
    ``mesh`` with tp the stage's projections are this rank's tp blocks
    (:func:`pp_param_specs`)."""
    check_dense(cfg, "init_pp_params")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"pp={n_stages} stages")
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} is outside 0..{n_stages - 1}")
    dev = resolve_device(device)
    lps = cfg.n_layers // n_stages
    d, f = cfg.d_model, cfg.d_ff

    def norm(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    def ones(*shape):
        return torch.ones(shape, device=dev)

    embed = norm((cfg.vocab, d), 0.02)
    stacks = {"wqkv": norm((n_stages, lps, d, 3 * d), d ** -0.5),
              "wo": norm((n_stages, lps, d, d), d ** -0.5),
              "w1": norm((n_stages, lps, d, f), d ** -0.5),
              "w2": norm((n_stages, lps, f, d), f ** -0.5)}
    specs = pp_param_specs(mesh)["stages"]
    stages = {k: torch.nn.Parameter(
        (v[stage] if mesh is None
         else local_slice(v[stage], specs[k][1:], mesh)).clone())
        for k, v in stacks.items()}
    stages["ln1"] = torch.nn.Parameter(ones(lps, d))
    stages["ln2"] = torch.nn.Parameter(ones(lps, d))
    return {"embed": torch.nn.Parameter(embed),
            "lnf": torch.nn.Parameter(ones(d)),
            "stages": {k: stages[k] for k in _STAGE_KEYS}}


def pp_param_specs(mesh) -> Dict:
    """The sharded axis of each leaf of the stacked layout (JAX
    ``pp_param_specs``), as plain data: per dimension the mesh axis it is
    split over, or None. The stage dimension is split over pp, the
    Megatron column (``wqkv``, ``w1``) and row (``wo``, ``w2``)
    dimensions over tp when the mesh has it; the head is replicated."""
    tp = "tp" if mesh is not None and "tp" in mesh.shape else None
    column, row = ("pp", None, None, tp), ("pp", None, tp, None)
    return {"embed": (), "lnf": (),
            "stages": {"ln1": ("pp", None, None), "ln2": ("pp", None, None),
                       "w1": column, "w2": row, "wo": row,
                       "wqkv": column}}


def pp_global_shapes(cfg: TransformerConfig, n_stages: int) -> list:
    """The global shapes of the stacked layout's leaves (JAX
    ``init_pp_params``: the stages ``[n_stages, lps, ...]``), in
    :func:`named_leaves` order: what the ZeRO plan is made on, whatever
    the tp split."""
    lps, d, f = cfg.n_layers // n_stages, cfg.d_model, cfg.d_ff
    stages = {"ln1": (lps, d), "ln2": (lps, d), "w1": (lps, d, f),
              "w2": (lps, f, d), "wo": (lps, d, d), "wqkv": (lps, d, 3 * d)}
    return [(cfg.vocab, d), (d,)] + [(n_stages,) + stages[k]
                                     for k in _STAGE_KEYS]


def named_specs(specs: Dict) -> list:
    """The specs of :func:`pp_param_specs` in :func:`named_leaves`
    order."""
    return [specs["embed"], specs["lnf"]] + [specs["stages"][k]
                                             for k in _STAGE_KEYS]


def named_leaves(params: Dict) -> List[Tuple[str, torch.Tensor]]:
    """``params``' leaves with dotted names in the JAX tree-flatten order
    (sorted keys at every level): the bucket plan's order."""
    return ([("embed", params["embed"]), ("lnf", params["lnf"])]
            + [(f"stages.{k}", params["stages"][k]) for k in _STAGE_KEYS])


@dataclasses.dataclass
class PPTrainState:
    """This rank's parameters (its stage's slice and the head), the
    distributed optimizer over them, and the step."""

    params: Dict
    optimizer: DistributedOptimizer
    step: int = 0


def make_pp_transformer_train_step(cfg: TransformerConfig, mesh,
                                   optimizer: Callable[...,
                                                       torch.optim.Optimizer],
                                   n_microbatches: int, *,
                                   wire_dtype=None,
                                   guard_nonfinite: Optional[bool] = None,
                                   fusion_threshold: Optional[int] = None,
                                   zero: bool = False,
                                   overlap: Optional[bool] = None,
                                   device: DeviceLike = "cuda"):
    """Build ``(init_state, step)``: the pipelined LM's 1F1B train step.

    ``mesh`` is a :func:`~.mesh.create_hybrid_mesh` dp × pp (× tp) mesh
    over the world; ``optimizer`` builds the wrapped optimizer from the
    parameter list (e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)``).

    ``init_state(seed=0, params=None)`` draws this rank's stage (its tp
    blocks under tp) and head from ``seed`` (:func:`init_pp_params`; or
    takes ``params``, e.g. from :func:`~horovod_tpu_torch.convert.
    pp_params_from_jax`) and wraps the optimizer in a
    :class:`~horovod_tpu_torch.DistributedOptimizer` on the spec-grouped
    plane of :func:`pp_param_specs` (pp skipped), bucketed in the JAX
    leaf order. ``step(state, tokens, labels) -> (state, loss)`` takes
    this dp rank's ``[B_local, T]`` rows (the same on every stage and tp
    rank of a pipeline; ``B_local`` divisible by ``n_microbatches``),
    runs one 1F1B update in place, and returns the mean loss averaged
    over dp.

    ``wire_dtype`` (``"bf16"``/``"fp8"``; default ``HVD_WIRE_DTYPE``)
    puts the gradient buckets on the wire in reduced precision.
    ``guard_nonfinite`` (default ``HVD_GUARD_NONFINITE``) skips the
    update when any rank's gradients are non-finite: the plan never sums
    over pp, so its flag is folded over pp with one scalar MIN (with tp,
    the plane first folds its tp-sharded buckets' flags over (dp, tp):
    one more) and read on the host once; a skipped step returns loss 0
    and leaves params and optimizer state bit-unchanged. Accumulation is native: the microbatches are the
    accumulation.

    ``zero`` is ZeRO-1 over dp with pp and tp as non-scatter axes (the
    JAX step's ``skip_axes=()`` plan over the stacked layout's global
    shapes, :func:`pp_global_shapes`): the head leaves take the full
    (dp, pp, tp) reduce — the step's pp sum has already made them the
    same on every stage, and the plan's ``1/(dp·pp·tp)`` gives their
    pp-skip mean —, and the guard's verdict folds over the plan's
    non-scatter axes (one scalar MIN) instead of over pp. ``overlap``
    (default ``HVD_OVERLAP``): the gradients come out of the 1F1B
    schedule whole, after its last backward tick, so every bucket is
    started in plan order before the first is waited on — a pure
    reorder of the plain step, bitwise the same (``grad_order_source``
    reads ``"plan"``)."""
    check_dense(cfg, "make_pp_transformer_train_step")
    dev = resolve_device(device)
    guard = (_config.guard_nonfinite() if guard_nonfinite is None
             else bool(guard_nonfinite))
    if overlap is None:
        overlap = _config.overlap_enabled()
    S = mesh.shape["pp"]
    stage = mesh.coords["pp"]
    M = n_microbatches
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"pp={S} stages")
    tp = mesh.shape.get("tp", 1)
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must "
                         f"divide by tp={tp}")
    heads = cfg.n_heads // tp
    lps = cfg.n_layers // S
    specs = named_specs(pp_param_specs(mesh))
    dp_group = mesh.groups["dp"]
    pp_group = mesh.groups["pp"]
    reduce = tp_reduce(mesh)

    def stage_fn(st, x):
        # Cast each stacked projection once and unbind it into its layers:
        # the backward then stacks the layers' gradients in one pass, where
        # indexing layer by layer would add lps zero-padded copies of the
        # whole stack. (JAX casts per layer; the values are the same.)
        per_layer = {k: (st[k].to(cfg.dtype) if k in _PROJ else st[k])
                     .unbind(0) for k in _STAGE_KEYS}
        run = remat_layer if cfg.remat else _layer
        for i in range(lps):
            layer = {k: per_layer[k][i] for k in _STAGE_KEYS}
            x = run(layer, x, cfg,
                    lambda qkv: attend_heads(qkv, cfg, heads), reduce)
        return x

    def head_loss(act, labels, head):
        h = rms_norm(act, head["lnf"])
        u = head["embed"].to(cfg.unembed_dtype)
        if cfg.loss_chunk:
            return chunked_nll(h, u, labels, cfg).mean()
        return dense_nll(_logits(h, u, cfg), labels).mean()

    def init_state(seed: int = 0, params: Optional[Dict] = None
                   ) -> PPTrainState:
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_pp_params(gen, cfg, S, stage, mesh=mesh,
                                    device=dev)
        named = named_leaves(params)
        zero_kw = dict(skip_axes=("pp",))
        if zero:
            zero_kw = dict(zero=True, skip_axes=(),
                           global_shapes=pp_global_shapes(cfg, S))
        opt = DistributedOptimizer(
            optimizer([p for _, p in named]), named_parameters=named,
            fusion_threshold=fusion_threshold, wire_dtype=wire_dtype,
            overlap=bool(overlap), mesh=mesh, param_specs=specs,
            **zero_kw)
        if overlap:
            opt.grad_order_source = "plan"
        return PPTrainState(params=params, optimizer=opt)

    def step(state: PPTrainState, tokens: torch.Tensor,
             labels: torch.Tensor):
        params = state.params
        B, T = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        tok_m = tokens.reshape(M, B // M, T)
        y_m = labels.reshape(M, B // M, T)
        embed = params["embed"]

        def inject(toks):
            return embed[toks.long()].to(cfg.dtype)

        def accumulate_embed_grad(acc, i, din):
            return acc.index_add_(0, tok_m[i].reshape(-1).long(),
                                  din.float().reshape(-1, cfg.d_model))

        loss, sg, hg, d_embed_in = one_f_one_b(
            stage_fn, params["stages"], tok_m, y_m, head_loss, mesh=mesh,
            head_params={"embed": embed, "lnf": params["lnf"]},
            inject_fn=inject,
            input_grad_acc=(torch.zeros_like(embed), accumulate_embed_grad))
        # The embedding gradient: the unembedding's (last stage) plus the
        # input lookup's (stage 0), summed over pp with lnf's.
        if S > 1:
            for g in (hg["embed"], hg["lnf"], d_embed_in):
                torch.distributed.all_reduce(g, group=pp_group)
        grads = {"embed": hg["embed"] + d_embed_in, "lnf": hg["lnf"],
                 **{f"stages.{k}": sg[k] for k in _STAGE_KEYS}}
        for name, p in named_leaves(params):
            p.grad = grads[name]
        if guard and zero:
            # The verdict folds over the plan's non-scatter axes and rides
            # the dp all-gather; a skip puts the shards' state back.
            finite, _ = state.optimizer.guarded_step()
            loss = torch.where(finite, loss, torch.zeros_like(loss))
        elif guard:
            finite = state.optimizer.synchronize(return_finite=True)
            if S > 1:   # the plan never sums over pp: fold the verdict
                f = finite.to(torch.int32).reshape(1)
                torch.distributed.all_reduce(
                    f, op=torch.distributed.ReduceOp.MIN, group=pp_group)
                finite = f[0] > 0
            if bool(finite):        # the guard's one host read
                state.optimizer.optimizer.step()
            loss = torch.where(finite, loss, torch.zeros_like(loss))
        else:
            state.optimizer.step()
        state.step += 1
        loss = loss.reshape(1)
        torch.distributed.all_reduce(loss, group=dp_group)
        return state, loss[0] / mesh.shape["dp"]

    return init_state, step
