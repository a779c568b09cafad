"""Model layers of the port: the named mesh (dp / pp / ep / sp / tp), the
tp, sp (ring, Ulysses), ep (MoE) and pp (GPipe, 1F1B) layers, the
transformer LM and its train steps (dp × tp × sp × ep, and dp × pp × tp
pipelined), its paged KV cache, and the integrity-checked checkpoints
(``checkpoint``)."""

from .checkpoint import (read_manifest, restore_for_inference,
                         restore_sharded, save_sharded, snapshot_to_host,
                         verify_checkpoint, write_manifest)

from .kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                        init_paged_kv_cache, paged_decode_step, paged_prefill)
from .mesh import (AXES, Mesh, axis_size, create_hybrid_mesh,
                   grad_sync_by_spec, make_mesh)
from .moe import moe_ffn
from .pipeline import gpipe, one_f_one_b
from .ring import ring_attention, ulysses_attention
from .tp import column_parallel, init_column, init_row, row_parallel
from .pp_transformer import (init_pp_params, make_pp_transformer_train_step,
                             pp_param_specs)
from .transformer import (Transformer, TransformerConfig, dense_nll, forward,
                          forward_hidden, gen_weights,
                          make_parallel_train_step, param_specs,
                          prompt_forward, rms_norm, step_forward, unembed)

__all__ = ["Transformer", "TransformerConfig", "forward", "forward_hidden",
           "unembed", "dense_nll", "make_parallel_train_step", "gen_weights",
           "prompt_forward", "step_forward", "rms_norm", "TRASH_BLOCK",
           "BlockManager", "blocks_for", "init_paged_kv_cache",
           "paged_prefill", "paged_decode_step", "Mesh", "AXES",
           "axis_size", "create_hybrid_mesh", "make_mesh",
           "grad_sync_by_spec", "moe_ffn", "gpipe", "ring_attention",
           "ulysses_attention", "column_parallel", "row_parallel",
           "init_column", "init_row", "param_specs", "one_f_one_b",
           "init_pp_params",
           "pp_param_specs", "make_pp_transformer_train_step",
           "save_sharded", "restore_sharded", "restore_for_inference",
           "verify_checkpoint", "write_manifest", "read_manifest",
           "snapshot_to_host"]
