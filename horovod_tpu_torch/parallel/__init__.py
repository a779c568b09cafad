"""Model layers of the port: the transformer LM, its data-parallel train
step and its paged KV cache."""

from .kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                        init_paged_kv_cache, paged_decode_step, paged_prefill)
from .transformer import (Transformer, TransformerConfig, dense_nll, forward,
                          forward_hidden, gen_weights,
                          make_parallel_train_step, prompt_forward, rms_norm,
                          step_forward, unembed)

__all__ = ["Transformer", "TransformerConfig", "forward", "forward_hidden",
           "unembed", "dense_nll", "make_parallel_train_step", "gen_weights",
           "prompt_forward", "step_forward", "rms_norm", "TRASH_BLOCK",
           "BlockManager", "blocks_for", "init_paged_kv_cache",
           "paged_prefill", "paged_decode_step"]
