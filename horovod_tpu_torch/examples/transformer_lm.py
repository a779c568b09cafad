"""A transformer LM over a hybrid mesh: data, sequence, tensor and
pipeline parallelism composing on one world (port of the JAX package's
``examples/transformer_lm.py``).

Run one process per GPU through the launcher; the mesh must use the
whole world (``--dp 0`` takes what the other axes leave)::

    python -m horovod_tpu_torch.launcher -np 8 python -m \\
        horovod_tpu_torch.examples.transformer_lm --dp 2 --sp 2 --tp 2
    python -m horovod_tpu_torch.launcher -np 8 python -m \\
        horovod_tpu_torch.examples.transformer_lm --dp 2 --pp 2 --tp 2
    python -m horovod_tpu_torch.launcher -np 4 --cpu python -m \\
        horovod_tpu_torch.examples.transformer_lm --dp 2 --tp 2 \\
        --steps 6 --checkpoint-dir /tmp/lm --checkpoint-every 2

A synthetic copy task (predict the previous token) checks that it
learns. ``--pp`` selects the pipelined family (1F1B, with tp inside the
stages); it composes with dp and tp, not sp. ``--checkpoint-dir`` saves
the canonical (world-1) form every ``--checkpoint-every`` steps and
``--resume`` continues from the newest one, on any mesh with the same
axis names; both cover the non-pp family.
"""

import argparse
import functools
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import runtime
from horovod_tpu_torch.parallel import checkpoint as ckpt
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch.parallel.pp_transformer import \
    make_pp_transformer_train_step
from horovod_tpu_torch.parallel.transformer import (TransformerConfig,
                                                    make_parallel_train_step)
from horovod_tpu_torch.training import shard_for_mesh


def _say(text: str) -> None:
    if hvd.rank() == 0:
        sys.stdout.write(text + "\n")
        sys.stdout.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ways (0 = the world over the others)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ways (ring attention)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (Megatron column/row)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (1F1B; composes with dp/tp)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (--pp > 1)")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the canonical (params, optimizer state) here "
                        "every --checkpoint-every steps")
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    args = p.parse_args(argv)
    if args.pp > 1 and args.sp > 1:
        raise SystemExit("--pp composes with dp/tp, not sp")
    if args.pp > 1 and (args.checkpoint_dir or args.resume):
        raise SystemExit("--checkpoint-dir/--resume cover the non-pp "
                         "family, as in the JAX package's example "
                         "(examples/transformer_lm.py); the pipelined "
                         "stages checkpoint through parallel.checkpoint."
                         "save_sharded")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")

    hvd.init()
    try:
        return _run(args)
    finally:
        hvd.shutdown()


def _run(args) -> int:
    n = hvd.size()
    dp = args.dp or max(n // (args.sp * args.tp * args.pp), 1)
    mesh = create_hybrid_mesh(dp=dp, sp=args.sp, tp=args.tp, pp=args.pp)
    dev = runtime.device()
    cuda = dev.type == "cuda"
    cfg = TransformerConfig(vocab=256, d_model=args.d_model, n_heads=8,
                            n_layers=2 * max(args.pp, 1),
                            d_ff=4 * args.d_model, dtype=torch.bfloat16,
                            attn_backend="pallas" if cuda else "xla")
    _say(f"mesh: dp={dp} sp={args.sp} tp={args.tp} pp={args.pp} "
         f"({n} ranks), seq={args.seq}")
    adam = functools.partial(torch.optim.Adam, lr=3e-3)

    # Synthetic task: predict the PREVIOUS token (causal attention can
    # solve it exactly; random labels could not be learned).
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab,
                                          (args.batch, args.seq)))
    labels = torch.roll(tokens, 1, dims=1)
    if args.pp > 1:
        init_state, step = make_pp_transformer_train_step(
            cfg, mesh, adam, args.microbatches, device=dev)
        rows = args.batch // dp
        i = mesh.coords["dp"]
        tok = tokens[i * rows:(i + 1) * rows].to(dev)
        lab = labels[i * rows:(i + 1) * rows].to(dev)
    else:
        init_state, step = make_parallel_train_step(cfg, adam, mesh=mesh,
                                                    device=dev)
        tok, lab = (x.to(dev) for x in shard_for_mesh((tokens, labels),
                                                      mesh))
    state = init_state(0)

    start = 0
    if args.resume:
        _, _, start = ckpt.restore_sharded(args.checkpoint_dir, state.model,
                                           state.optimizer)
        state.step = start
        _say(f"resumed from step {start}")
        if start >= args.steps:
            _say(f"nothing to do: checkpoint step {start} >= --steps "
                 f"{args.steps}")
            return 0

    losses = []
    for i in range(start, args.steps):
        state, loss = step(state, tok, lab)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            _say(f"step {i:4d} loss {losses[-1]:.4f}")
        if args.checkpoint_dir and (i + 1) % args.checkpoint_every == 0:
            ckpt.save_sharded(args.checkpoint_dir, i + 1, state.model,
                              state.optimizer, max_to_keep=3)
    if len(losses) > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses[0]} -> "
                         f"{losses[-1]}")
    _say(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
