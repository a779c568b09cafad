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
