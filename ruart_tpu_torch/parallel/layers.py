"""Collectives and layers that cross ranks inside the forward pass.

What GSPMD inserts into the JAX program from the sharding layout
(``parallel/mesh.py``), written out for torch ranks. Every collective on a
differentiable path is ``torch.distributed.nn.functional.all_reduce`` (a
sum), whose backward is again an all-reduce of the incoming gradients: the
exact adjoint when each rank backpropagates its own share of the global
loss. Without a process group (an axis of size 1) each is the identity.

* :func:`all_reduce` — the differentiable sum over a group.
* :func:`gather_rows` — rows [a, b) of a table computed on this rank, the
  other rows on the other ranks of the group: the whole table on every
  rank (zero-padded, then :func:`all_reduce`, so the backward stays an
  all-reduce too, which gloo and NCCL both run).
* :class:`VocabParallelEmbedding` — an embedding whose rows are split over
  tp: a masked lookup of this rank's rows, then :func:`all_reduce`.

A parameter that holds a tp shard carries the sharded dim of the full
tensor as ``param.tp_dim`` (:func:`mark_sharded`); the optimizer sums its
gradient over dp only, and a save gathers it over tp.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def mark_sharded(module: nn.Module, **dims: int) -> nn.Module:
    """Set ``tp_dim`` on the named parameters of ``module``."""
    for name, dim in dims.items():
        getattr(module, name).tp_dim = dim
    return module


def tp_dim(param: torch.Tensor) -> Optional[int]:
    """The sharded dim of a parameter holding a tp shard, else None."""
    return getattr(param, "tp_dim", None)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (the identity for None)."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    return _all_reduce(x, group=group)


def row_range(n: int, parts: int, index: int):
    """[a, b): the contiguous share of ``n`` rows of part ``index`` of
    ``parts`` (ceil-sized shares; the last ones may be short or empty)."""
    per = -(-n // parts)
    a = min(index * per, n)
    return a, min(a + per, n)


def gather_rows(part: torch.Tensor, a: int, n: int, group) -> torch.Tensor:
    """The [n, ...] table whose rows [a, a + len(part)) this rank computed
    (``part``) and whose other rows the other ranks of ``group`` computed."""
    if group is None:
        return part
    b = a + part.shape[0]
    pad = (0, 0) * (part.dim() - 1) + (a, n - b)
    return all_reduce(F.pad(part, pad), group)


class VocabParallelEmbedding(nn.Embedding):
    """Rows [vocab_start, vocab_start + num_embeddings) of a vocab-sharded
    table. An id outside them looks up zeros here; the sum over the tp
    group gives every rank the full lookup."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 vocab_start: int, group):
        super().__init__(num_embeddings, embedding_dim)
        self.vocab_start = vocab_start
        self.group = group

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(local.clamp(0, self.num_embeddings - 1), self.weight)
        return all_reduce(rows * inside[..., None].to(rows.dtype), self.group)


def vocab_embedding(num_embeddings: int, embedding_dim: int, dim: Optional[int],
                    mesh) -> nn.Embedding:
    """``nn.Embedding`` of the full table, or this rank's
    :class:`VocabParallelEmbedding` shard when the layout shards it
    (``dim == 0``)."""
    if dim is None:
        return nn.Embedding(num_embeddings, embedding_dim)
    per = num_embeddings // mesh.tp
    return mark_sharded(VocabParallelEmbedding(
        per, embedding_dim, mesh.tp_rank * per, mesh.tp_group), weight=0)
