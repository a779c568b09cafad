"""The port's kernels: each a hand-written CUDA kernel for Hopper
(``csrc/``) beside a plain PyTorch version of the same math.

* :func:`~.attention.flash_attention_prefill` — causal flash attention
  forward (prefill), replacing the JAX package's Pallas ``_attn_kernel``.
* :func:`~.attention.flash_attention` — the differentiable ``[B, T, H,
  D]`` flash attention of the pipelined LM: the forward with lse
  (``_attn_kernel`` as ``_fwd_pallas`` launches it with lse) and the dq
  and dk/dv kernels with K6's (``_dqkv_kernel``'s) constants.
* :func:`~.attention.flash_attention_qkv` — the differentiable flash
  attention of LM training over the packed qkv projection: the forward
  with lse (``_attn_kernel`` as ``_fwd_pallas_qkv`` launches it) and the
  dq and dk/dv backward kernels (``_dq_kernel``, ``_dkv_kernel``,
  ``_dqkv_packed_kernel``).
* :func:`~.paged_attention.paged_decode_attention` — paged decode
  attention, replacing the Pallas ``_paged_kernel``.
* :func:`~.fused_conv_bn.fused_linear_bn_act` — fused 1x1 conv +
  BatchNorm statistics, forward and backward, replacing the Pallas
  ``_fwd_kernel`` and ``_bwd_kernel`` of ``pallas_conv.py``.

Each family has one routing predicate
(:func:`~.attention.flash_supported`,
:func:`~.paged_attention.paged_attention_supported`,
:func:`~.fused_conv_bn.conv_bn_supported`): on the card the kernels take
bf16 (d_head 128; channels multiples of 64), on the CPU the plain
versions take every input. The model that calls them routes by it; a
wrapper given a CUDA input its kernel does not take raises.
:data:`~._build.LAUNCHES` counts each kernel's launches. The eager
collectives, the fused gradient allreduce and the sparse allreduce live
beside them (``collectives.py``, ``fusion.py``, ``sparse.py``) and are
re-exported here as the reference's ``ops`` does.
"""

from ._build import LAUNCHES
from .collectives import (Op, allgather, allreduce, alltoall, broadcast,
                          grouped_allreduce, reducescatter)
from .fusion import fused_allreduce, plan_buckets
from .sparse import IndexedSlices, allreduce_indexed_slices
from .attention import (flash_attention, flash_attention_bwd_reference,
                        flash_attention_lse_reference,
                        flash_attention_prefill, flash_attention_qkv,
                        flash_attention_qkv_bwd_reference,
                        flash_attention_qkv_reference,
                        flash_attention_reference, flash_supported,
                        qkv_flash_tilable, xla_attention)
from .fused_conv_bn import (conv_bn_supported, fused_linear_bn_act,
                            fused_linear_bn_act_bwd_reference,
                            fused_linear_bn_act_reference)
from .paged_attention import (paged_attention_reference,
                              paged_attention_supported,
                              paged_decode_attention)

__all__ = ["LAUNCHES", "Op", "allreduce", "allgather", "broadcast",
           "alltoall", "reducescatter", "grouped_allreduce", "plan_buckets",
           "fused_allreduce", "IndexedSlices", "allreduce_indexed_slices",
           "flash_attention", "flash_attention_prefill",
           "flash_attention_reference", "flash_attention_lse_reference",
           "flash_attention_bwd_reference",
           "flash_attention_qkv", "flash_attention_qkv_reference",
           "flash_attention_qkv_bwd_reference", "qkv_flash_tilable",
           "xla_attention", "flash_supported",
           "paged_decode_attention", "paged_attention_reference",
           "paged_attention_supported", "fused_linear_bn_act",
           "conv_bn_supported",
           "fused_linear_bn_act_reference",
           "fused_linear_bn_act_bwd_reference"]
