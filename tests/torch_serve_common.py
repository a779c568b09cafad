"""Shared pieces of the port's KV-plane tests: the tiny model of the JAX
package's KV tests (vocab 32, d_model 16, 2 heads, 2 layers, d_ff 32,
f32, ``attn_backend="xla"``: dense attention on the JAX side), its JAX
weights as f32 numpy, the same weights in the port, and engine factories
for both sides.

At these widths every GEMM contracts over K <= 256, where torch's f32
CPU matmul gives a row the same bits whatever the row count, so the
port's speculative verify rows can be held bitwise to its decode rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu import serve as jserve
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch.convert import params_from_jax
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine

DIMS = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32)
TIMEOUT = 120


def jax_config():
    return jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def torch_config():
    return ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                 unembed_dtype=torch.float32)


def make_tree():
    """The JAX ``init_params`` of the tiny model, as f32 numpy."""
    params = jtr.init_params(jax.random.PRNGKey(0), jax_config())
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


def jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def torch_model(tree):
    return params_from_jax(tree, torch_config(), device="cpu")


def torch_weights(model):
    with torch.no_grad():
        return ttr.gen_weights(model)


def engine(model, spec=None, **kw):
    """A port engine on the CPU (2 slots, max_len 16, 4 new tokens by
    default)."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 16)
    kw.setdefault("default_max_new_tokens", 4)
    return GenerationEngine(model, GenerationConfig(**kw), device="cpu",
                            spec=spec)


def jax_engine(tree, spec=None, **kw):
    """The JAX engine with the same knobs (the same defaults as the
    port's: contiguous unless ``kv_layout`` says otherwise)."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 16)
    kw.setdefault("default_max_new_tokens", 4)
    return jserve.GenerationEngine(jax_params(tree), jax_config(),
                                   jserve.GenerationConfig(**kw), spec=spec)


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- the tp-group fleet's toy (tests/test_torch_tp_fleet*.py) -----------------
# Two tp = 2 groups of subprocesses serve it on the CPU; the JAX engine
# serves the same weights unsharded: the port's seeded draw, read back
# through ``convert.params_to_numpy``.

TP_DIMS = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128)
TP_SEED = 3
TP_GEN = dict(max_slots=2, max_len=32, default_max_new_tokens=6)
TP_LAYOUTS = {"contiguous": {},
              "paged": dict(kv_layout="paged", block_size=4,
                            paged_kernel=True)}
TP_SAMPLED = dict(temperature=0.8, top_k=8)
TP_MARGIN = 1e-4


def tp_spec(layout: str, **extra) -> dict:
    """The subprocess replica spec of one tp = 2 group on the CPU."""
    return dict({"model": dict(TP_DIMS, dtype="float32",
                               unembed_dtype="float32"),
                 "seed": TP_SEED, "device": "cpu", "tp": 2,
                 "generation": dict(TP_GEN, **TP_LAYOUTS[layout])}, **extra)


def tp_model():
    """The port's unsharded model from the spec's seed (what every rank
    of a group draws before keeping its blocks)."""
    cfg = ttr.TransformerConfig(**TP_DIMS, dtype=torch.float32,
                                unembed_dtype=torch.float32)
    return ttr.Transformer(cfg, generator=torch.Generator().manual_seed(
        TP_SEED), device="cpu")


def tp_tree(model) -> dict:
    from horovod_tpu_torch.convert import params_to_numpy
    return params_to_numpy(model)


def tp_requests(n: int = 16) -> list:
    """``n`` requests of 3 to 12 prompt tokens (seeded), greedy and
    seeded sampling in turns: ``(tokens, sampling kwargs or None)``."""
    rng = np.random.RandomState(11)
    return [(rng.randint(1, TP_DIMS["vocab"], 3 + i % 10).tolist(),
             None if i % 2 == 0 else dict(TP_SAMPLED, seed=100 + i))
            for i in range(n)]


def jax_tp_engine(tree, layout: str):
    """The JAX engine on the tree, unsharded (the XLA gather where the
    port's paged engine takes the kernel's route)."""
    kw = {k: v for k, v in TP_LAYOUTS[layout].items() if k != "paged_kernel"}
    cfg = jtr.TransformerConfig(**TP_DIMS, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    return jserve.GenerationEngine(jax_params(tree), cfg,
                                   jserve.GenerationConfig(**TP_GEN, **kw))


def greedy_margins(model, prompt, tokens) -> list:
    """The top-2 logit margin at each generated position of a greedy
    stream (one teacher-forced prefill of the unsharded model)."""
    seq = list(prompt) + list(tokens[:-1])
    cache = ttr.init_kv_cache(model.cfg, 1, len(seq), device="cpu")
    with torch.no_grad():
        _, lg = ttr.prefill(torch_weights(model), torch.tensor(seq), cache,
                            0, model.cfg)
    top = lg[len(prompt) - 1:].topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()
