"""Model layers of the port: the transformer LM, its data-parallel train
step, its paged KV cache, the pipelined (dp × pp, 1F1B) train step over a
mesh, and the integrity-checked checkpoints (``checkpoint``)."""

from .checkpoint import (read_manifest, restore_for_inference,
                         restore_sharded, save_sharded, snapshot_to_host,
                         verify_checkpoint, write_manifest)

from .kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                        init_paged_kv_cache, paged_decode_step, paged_prefill)
from .mesh import Mesh, create_hybrid_mesh
from .pipeline import one_f_one_b
from .pp_transformer import (init_pp_params, make_pp_transformer_train_step,
                             pp_param_specs)
from .transformer import (Transformer, TransformerConfig, dense_nll, forward,
                          forward_hidden, gen_weights,
                          make_parallel_train_step, prompt_forward, rms_norm,
                          step_forward, unembed)

__all__ = ["Transformer", "TransformerConfig", "forward", "forward_hidden",
           "unembed", "dense_nll", "make_parallel_train_step", "gen_weights",
           "prompt_forward", "step_forward", "rms_norm", "TRASH_BLOCK",
           "BlockManager", "blocks_for", "init_paged_kv_cache",
           "paged_prefill", "paged_decode_step", "Mesh",
           "create_hybrid_mesh", "one_f_one_b", "init_pp_params",
           "pp_param_specs", "make_pp_transformer_train_step",
           "save_sharded", "restore_sharded", "restore_for_inference",
           "verify_checkpoint", "write_manifest", "read_manifest",
           "snapshot_to_host"]
