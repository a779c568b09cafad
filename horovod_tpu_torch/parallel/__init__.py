"""Model layers of the port: the transformer LM and its paged KV cache."""

from .kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                        init_paged_kv_cache, paged_decode_step, paged_prefill)
from .transformer import (Transformer, TransformerConfig, forward,
                          gen_weights, prompt_forward, rms_norm,
                          step_forward)

__all__ = ["Transformer", "TransformerConfig", "forward", "gen_weights",
           "prompt_forward", "step_forward", "rms_norm", "TRASH_BLOCK",
           "BlockManager", "blocks_for", "init_paged_kv_cache",
           "paged_prefill", "paged_decode_step"]
