"""Rank mesh + sharding layout — port of ``ruart_tpu/parallel/mesh.py``.

A JAX ``Mesh`` of devices becomes a :class:`Mesh` of torch ranks (one card
each): a [dp, tp] grid of global ranks, tp contiguous, with this rank's
coordinates and the process groups of its dp column and tp row.

* ``dp`` — data parallel over the batch axis: every rank of a tp row holds
  the same contiguous slice of the global batch (:func:`shard_batch`); the
  gradients are summed over dp after the backward (``train/optim.py``).
* ``tp`` — tensor parallel over the BERT encoder's heads and FFN hidden
  units (the FLOP-dominant stage): Q/K/V and the FFN's expansion hold this
  rank's output features, the attention output and FFN contraction its
  input features and sum their partial products over tp, as
  ``_PARAM_RULES`` lays them out.

The fusion stack's parameters are replicated; its activations follow the
batch over dp. ``_PARAM_RULES`` are the JAX package's rules over the
port's state-dict names. flax kernels are [in, out] and ``nn.Linear``
weights [out, in], so a flax ``P(None, 'tp')`` kernel is a torch weight
sharded on dim 0, and ``P('tp', None)`` one sharded on dim 1. A rule whose
dimension tp does not divide falls back to replication (:func:`_fits`), and
so does a Q/K/V or attention-output rule whose layer's heads tp does not
divide: the kernel runs on whole heads (``ops.attention.tp_kernel_ok``).
The int8 encoder's layers (``INT8_BERT``) are replicated whole
(:func:`param_shardings`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (dp, tp) grid of global ranks and this rank's place in it.

    ``ranks[d, t]`` is the global rank at dp index d and tp index t;
    ``dp_group`` joins this rank's column (same t), ``tp_group`` its row
    (same d), ``group`` every rank of the mesh; each is None when it holds
    one rank (no collective), or when the mesh only describes one shard of
    a single-process call (:meth:`local`)."""

    ranks: np.ndarray
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Any = None
    tp_group: Any = None
    group: Any = None

    @property
    def dp(self) -> int:
        return int(self.ranks.shape[0])

    @property
    def tp(self) -> int:
        return int(self.ranks.shape[1])

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp}

    @classmethod
    def local(cls, dp: int, tp: int, dp_rank: int = 0,
              tp_rank: int = 0) -> "Mesh":
        """The coordinates of one shard of a (dp, tp) grid without process
        groups: what a single process needs to compute that shard."""
        return cls(np.arange(dp * tp).reshape(dp, tp), dp_rank, tp_rank)


def make_mesh(ranks: Optional[Iterable[int]] = None, tp: int = 1,
              dp: Optional[int] = None) -> Optional[Mesh]:
    """Build a (dp, tp) mesh over the given (default: all) ranks. Every rank
    of the world must call it, in the same order: it creates the dp and tp
    process groups (``torch.distributed.new_group``). A rank outside
    ``ranks`` gets None."""
    from ruart_tpu_torch.parallel.distributed import world_rank, world_size

    ranks = list(ranks if ranks is not None else range(world_size()))
    n = len(ranks)
    if dp is None:
        assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
        dp = n // tp
    assert dp * tp == n, f"dp*tp={dp * tp} != {n} devices"
    grid = np.asarray(ranks).reshape(dp, tp)
    me = world_rank()
    groups = {}
    for axis, lines in (("all", grid.reshape(1, -1)), (DP_AXIS, grid.T),
                        (TP_AXIS, grid)):
        for line in lines:
            group = (dist.new_group([int(r) for r in line])
                     if len(line) > 1 else None)
            if me in line:
                groups[axis] = group
    if me not in grid:
        return None
    d, t = (int(i[0]) for i in np.nonzero(grid == me))
    return Mesh(grid, d, t, groups[DP_AXIS], groups[TP_AXIS], groups["all"])


def auto_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """Default mesh layout: pure data parallelism unless ``tp`` (the
    ``tensor_parallel`` conf key) asks for a (dp, tp) mesh. BERT-base fits
    one card, the fusion stack is replicated anyway, and dp avoids the
    per-layer reduces tensor parallelism adds; the attention kernel stays
    on under tp on each rank's local heads
    (``ops.attention.sharded_fused_attention``)."""
    from ruart_tpu_torch.parallel.distributed import world_size

    n = n_devices or world_size()
    tp = int(tp or 1)
    if n % tp != 0:
        raise ValueError(f"tensor_parallel={tp} does not divide {n} devices")
    return make_mesh(range(n), tp=tp)


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

# (regex over a state-dict name, the sharded dim of the torch tensor) —
# first match wins; the JAX package's rules, flax [in, out] kernels turned
# into torch [out, in] weights
_PARAM_RULES: Tuple[Tuple[str, int], ...] = (
    # BERT attention projections: shard the head (output-feature) axis
    (r"^Bert\..*attention_self\.(query|key|value)\.weight$", 0),
    (r"^Bert\..*attention_self\.(query|key|value)\.bias$", 0),
    # attention output: its input axis is the sharded head axis -> local
    # product + all-reduce over tp
    (r"^Bert\..*attention_output_dense\.weight$", 1),
    # FFN: expand on the hidden axis, contract back
    (r"^Bert\..*intermediate_dense\.weight$", 0),
    (r"^Bert\..*intermediate_dense\.bias$", 0),
    (r"^Bert\..*output_dense\.weight$", 1),
    # big embedding tables: shard the vocab axis over tp
    (r"^Bert\.embeddings\.word_embeddings\.weight$", 0),
    (r"^(glove|fast|phoc)_embed\.weight$", 0),
)
_HEAD_RULE = re.compile(r"attention_(self|output_dense)\.")


def param_pspec(name: str) -> Optional[int]:
    """The dim the rule for ``name`` shards over tp, or None (replicated)."""
    for pattern, dim in _PARAM_RULES:
        if re.search(pattern, name):
            return dim
    return None


def _fits(dim: Optional[int], shape, tp: int) -> bool:
    """A rule is usable only if its sharded dim divides evenly (e.g. an
    odd-sized vocabulary cannot shard over tp=2)."""
    if dim is None:
        return True
    return dim < len(shape) and shape[dim] % tp == 0


def param_dim(name: str, shape, tp: int, heads: Optional[int] = None
              ) -> Optional[int]:
    """The dim of parameter ``name`` (of full ``shape``) sharded over ``tp``,
    or None: :func:`param_pspec` where it :func:`_fits`, and for the
    attention's Q/K/V and output only when tp also divides ``heads``."""
    if tp <= 1:
        return None
    dim = param_pspec(name)
    if dim is None or not _fits(dim, shape, tp):
        return None
    if heads is not None and _HEAD_RULE.search(name) and heads % tp:
        return None
    return dim


def param_shardings(shapes: Dict[str, Tuple[int, ...]], mesh: Mesh,
                    heads: Optional[int] = None) -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} for a full state dict's shapes. The
    layers of an int8 encoder (a ``weight_q`` beside the bias) stay whole:
    the JAX rules match ``kernel`` and never ``kernel_q``, and the port
    keeps their bias whole with them (``models.bert.model._dense``)."""
    int8 = {k[:-len("weight_q")] for k in shapes if k.endswith(".weight_q")}
    return {k: None if k[:k.rfind(".") + 1] in int8 else
            param_dim(k, s, mesh.tp, heads) for k, s in shapes.items()}


def shard_tensor(x: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's tp shard of a full tensor along ``dim`` (a copy)."""
    if dim is None:
        return x
    return x.chunk(mesh.tp, dim=dim)[mesh.tp_rank].clone()


def shard_params(state: Dict[str, torch.Tensor], mesh: Mesh,
                 heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A full state dict -> this rank's local shards (same names). Every
    rank holds the identical full state (the same seeded init, or the same
    checkpoint) and slices its own part; a replicated tensor is kept as
    it is (the JAX ``replicate`` has nothing to do on a rank)."""
    dims = param_shardings({k: tuple(v.shape) for k, v in state.items()},
                           mesh, heads)
    return {k: shard_tensor(v, dims[k], mesh) for k, v in state.items()}


# ---------------------------------------------------------------------------
# Batch layout
# ---------------------------------------------------------------------------

def batch_pspec(mesh: Mesh) -> Callable[[int], slice]:
    """All per-sample batch tensors split dim 0 (the per-question axis) over
    dp: this rank's rows of a global batch of ``n`` are
    ``batch_pspec(mesh)(n)``."""
    from ruart_tpu_torch.parallel.distributed import process_batch_slice

    return lambda n: process_batch_slice(n, mesh.dp_rank, mesh.dp)


def shard_batch(batch_tree: Any, mesh: Mesh, n: int,
                replicated_keys: Iterable[str] = ()) -> Any:
    """This rank's dp slice of a global host batch of ``n`` samples: every
    per-sample array or tensor keeps its rows of dim 0; dict keys in
    ``replicated_keys`` (batch-global tables) stay whole; None stays None.
    An array under several keys is sliced once."""
    rows = batch_pspec(mesh)(n)
    rep = frozenset(replicated_keys)
    cut: Dict[int, Any] = {}

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(walk(v, key) for v in tree)
        if tree is None or key in rep:
            return tree
        if tree.shape[0] != n:
            raise ValueError(f"batch key {key!r}: dim 0 is {tree.shape[0]}, "
                             f"not the batch {n}")
        got = cut.get(id(tree))
        if got is None:
            got = cut[id(tree)] = tree[rows]
        return got

    return walk(batch_tree)
