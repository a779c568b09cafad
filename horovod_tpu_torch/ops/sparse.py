"""Sparse (embedding) gradients: the ``IndexedSlices`` path.

Port of the JAX package's ``ops/sparse.py``. A sparse gradient is a
(values, indices) pair, ``dense[indices[i]] += values[i]``; its
"allreduce" is two allgathers (values and indices) with the values
divided by ``size()`` when averaging. The gathered slices may repeat an
index across ranks; the repeats sum when the slices are applied
(:meth:`IndexedSlices.to_dense` is a scatter-add).

PyTorch's own sparse gradient is a COO tensor: ``nn.Embedding(...,
sparse=True)`` leaves one in ``weight.grad``.
:meth:`IndexedSlices.from_sparse_coo` and :meth:`IndexedSlices.
to_sparse_coo` convert between the two. Unlike the JAX package, whose
ranks hold equal slice counts under SPMD, each rank here may hold its
own count: the gathers exchange the counts first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class IndexedSlices:
    """A sparse gradient: ``dense[indices[i]] += values[i]``; ``values``
    is ``[n, *dense_shape[1:]]`` and ``indices`` ``[n]`` (int64)."""

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 dense_shape: Sequence[int]):
        self.values = values
        self.indices = indices
        self.dense_shape = tuple(int(d) for d in dense_shape)

    @classmethod
    def from_sparse_coo(cls, t: torch.Tensor) -> "IndexedSlices":
        """The slices of a sparse COO tensor with one sparse dimension
        (an embedding's gradient); uncoalesced entries stay as they are."""
        if not t.is_sparse or t.sparse_dim() != 1:
            raise ValueError(
                "IndexedSlices.from_sparse_coo takes a sparse COO tensor "
                f"with one sparse dimension; got layout {t.layout} with "
                f"{t.sparse_dim() if t.is_sparse else 0} sparse dims")
        return cls(t._values(), t._indices()[0], t.shape)

    def to_sparse_coo(self) -> torch.Tensor:
        """The sparse COO tensor of these slices (uncoalesced: a repeated
        index keeps one entry per slice)."""
        return torch.sparse_coo_tensor(self.indices.reshape(1, -1),
                                       self.values, self.dense_shape)

    def to_dense(self) -> torch.Tensor:
        """Scatter-add the slices into a dense tensor."""
        dense = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.indices.long(), self.values)

    def __repr__(self):
        return (f"IndexedSlices(values={tuple(self.values.shape)}, "
                f"indices={tuple(self.indices.shape)}, "
                f"dense_shape={self.dense_shape})")


def allreduce_indexed_slices(slices: IndexedSlices, average: bool = True,
                             name: Optional[str] = None) -> IndexedSlices:
    """Sparse allreduce: the allgather of the values and of the indices
    (rank order), values divided by ``size()`` when averaging."""
    from .. import runtime
    from .collectives import allgather
    del name
    values = allgather(slices.values)
    indices = allgather(slices.indices)
    if average:
        values = values / runtime.size()
    return IndexedSlices(values, indices, slices.dense_shape)
