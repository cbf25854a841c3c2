"""Fusion-network building blocks in PyTorch.

Port of ``ruart_tpu/models/fusion/layers.py`` (from-scratch equivalents of
the reference's `Models/Layers.py`).

* :func:`seq_dropout` / :class:`Dropper` — variational (time-shared) and
  plain dropout (`Layers.py:23-39`). Masks come from the ``torch.Generator``
  the root model hands every :class:`Dropper` (``RUArtModel.seed_dropout``);
  every dropout is the identity under ``model.eval()``. On a rank of a dp
  mesh each site draws the mask of the GLOBAL batch and keeps its rows
  (``Dropper.rows``), so a dp step equals the single-process step.
* :class:`AttentionScore` / :class:`Attention` — the 5 correlation kernels
  and the masked softmax-attend (`Layers.py:182-295`), including the
  ``x2_row_index`` gathered-row form candidate compaction uses.
* :class:`LinearSelfAttn`, :class:`BilinearSeqAttn`,
  :class:`GetFinalScores` (ES split, no-answer / yes-no heads, final
  softmax; the reference's never-read GRU pointer hop is not built).
* :func:`whole_tensor_layer_norm` — moments over the WHOLE batch tensor
  (summed over the dp ranks' rows on a mesh).

Input widths are constructor arguments (flax infers them at init); the
module and parameter names follow the flax tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ruart_tpu_torch.parallel.layers import all_reduce

NEG_INF = -1e30  # finite -inf stand-in: keeps softmax NaN-free on all-masked rows


def seq_dropout(x: torch.Tensor, p: float, variational: bool,
                generator: torch.Generator,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Dropout with keep probability 1 - p, scaled by 1 / (1 - p). A 3-D
    input under ``variational`` keeps one [B, 1, D] mask shared across the
    time axis (`Layers.py:23-30`); anything else gets a mask per element.
    With ``rows`` = (global rows, first row), ``x`` holds rows [first,
    first + len(x)) of a tensor of that many rows: the mask of the whole
    tensor is drawn and those rows kept."""
    n, start = rows if rows is not None else (x.shape[0], 0)
    shape = (n, 1, x.shape[2]) if variational and x.dim() == 3 else (
        n, *x.shape[1:])
    keep = torch.empty(shape, dtype=x.dtype, device=x.device)
    keep.bernoulli_(1.0 - p, generator=generator)
    return x * keep[start:start + x.shape[0]] / (1.0 - p)


class Dropper(nn.Module):
    """Dropout at one site of the JAX forward (``dropout_fn``): the identity
    in eval mode or at p 0, :func:`seq_dropout` in training mode. Holds no
    parameters; ``generator`` is set by ``RUArtModel.seed_dropout``.

    ``rows`` is the root model's map {row layout: (global rows, first row)}
    for the forward in flight, shared by every site: a call names the
    layout of its input's dim 0 — ``'dense'`` for the batch axis,
    ``'flat'`` for the candidate rows — and, where the map holds it, draws
    the global mask and keeps this rank's rows. Empty on one rank."""

    def __init__(self, p: float = 0.0, variational: bool = True):
        super().__init__()
        self.p = p
        self.variational = variational
        self.generator: Optional[torch.Generator] = None
        self.rows: Dict[str, Tuple[int, int]] = {}

    def forward(self, x: torch.Tensor, layout: str = "dense") -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: call "
                "RUArtModel.seed_dropout(seed) first"
            )
        return seq_dropout(x, self.p, self.variational, self.generator,
                           self.rows.get(layout))


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax with invalid positions forced to ~0 probability."""
    if mask is not None:
        scores = torch.where(
            mask.bool(), scores, torch.full_like(scores, NEG_INF)
        )
    return torch.softmax(scores, dim=dim)


def weighted_avg(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[B, L, D] x [B, L] -> [B, D] (`Layers.py:529-534`)."""
    return torch.bmm(weights[:, None, :], x)[:, 0]


class AttentionScore(nn.Module):
    """Pairwise correlation scores (`Layers.py:182-245`).

    correlation_func: 1 x1·x2ᵀ | 2 (Wx1)D(Wx2)ᵀ | 3 relu(Wx1)D relu(Wx2)ᵀ |
    4 x1ᵀWx2 | 5 relu(Wx1)·relu(Wx2)ᵀ. ``do_similarity`` freezes D to
    1/sqrt(hidden) (not a parameter) as in the reference.
    """

    def __init__(self, in_size: int, hidden_size: int,
                 correlation_func: int = 1, do_similarity: bool = False,
                 dropout_p: float = 0.0, variational: bool = True):
        super().__init__()
        self.drop = Dropper(dropout_p, variational)
        self.cf = correlation_func
        self.hidden_size = hidden_size
        self.do_similarity = do_similarity
        if correlation_func in (2, 3, 5):
            self.linear = nn.Linear(in_size, hidden_size, bias=False)
        elif correlation_func == 4:
            self.linear = nn.Linear(in_size, in_size, bias=False)
        if correlation_func in (2, 3) and not do_similarity:
            self.diagonal = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x1, x2, x2_row_index=None):
        """``x2_row_index`` [R] maps each x1 row to its x2 batch row: x1 is
        [R, Lx, D] gathered rows (candidate-row layout), x2 stays
        [B, Ly, D] and is projected once at batch granularity before the
        per-row gather."""
        cf = self.cf
        x1 = self.drop(x1, "dense" if x2_row_index is None else "flat")
        x2 = self.drop(x2)
        if cf in (2, 3):
            x1r, x2r = self.linear(x1), self.linear(x2)
            if cf == 3:
                x1r, x2r = torch.relu(x1r), torch.relu(x2r)
            if self.do_similarity:
                # the JAX package multiplies by a float32 1/sqrt(hidden)
                diag = torch.tensor(
                    1.0 / self.hidden_size ** 0.5, dtype=torch.float32
                )
            else:
                diag = self.diagonal
            x1r = x1r * diag
        elif cf == 4:
            x1r, x2r = x1, self.linear(x2)
        elif cf == 5:
            x1r, x2r = torch.relu(self.linear(x1)), torch.relu(self.linear(x2))
        else:
            x1r, x2r = x1, x2
        if x2_row_index is not None:
            x2r = x2r.index_select(0, x2_row_index)
        return torch.bmm(x1r, x2r.transpose(1, 2))


class Attention(nn.Module):
    """Masked attend: softmax(score(x1, x2)) @ x3 (`Layers.py:247-295`)."""

    def __init__(self, in_size: int, hidden_size: int,
                 correlation_func: int = 1, do_similarity: bool = False,
                 dropout_p: float = 0.0, variational: bool = True):
        super().__init__()
        self.scoring = AttentionScore(
            in_size, hidden_size, correlation_func, do_similarity,
            dropout_p, variational,
        )
        # a list while introspect.record_intermediates records: every
        # alpha of this module's calls, in call order
        self.sown: Optional[List[torch.Tensor]] = None

    def forward(self, x1, x2, x2_mask, x3=None, x2_row_index=None):
        """With ``x2_row_index`` [R], x1 is [R, Lx, D] gathered rows while
        x2/x2_mask/x3 stay batch-shaped [B, ...]: row r attends to batch row
        x2_row_index[r]."""
        if x3 is None:
            x3 = x2
        scores = self.scoring(x1, x2, x2_row_index=x2_row_index)
        if x2_row_index is not None:
            x2_mask = x2_mask.index_select(0, x2_row_index)
            x3 = x3.index_select(0, x2_row_index)
        alpha = masked_softmax(scores, x2_mask[:, None, :])
        if self.sown is not None:
            self.sown.append(alpha)
        return torch.bmm(alpha, x3)


class LinearSelfAttn(nn.Module):
    """softmax(Wx) summary weights over a sequence (`Layers.py:320-341`)."""

    def __init__(self, in_size: int, dropout_p: float = 0.0,
                 variational: bool = True):
        super().__init__()
        self.drop = Dropper(dropout_p, variational)
        self.linear = nn.Linear(in_size, 1)

    def forward(self, x, x_mask):
        return masked_softmax(self.linear(self.drop(x))[..., 0], x_mask)


class BilinearSeqAttn(nn.Module):
    """o_i = x_i' W y scores over a sequence (`Layers.py:435-468`)."""

    def __init__(self, x_size: int, y_size: int, dropout_p: float = 0.0,
                 variational: bool = True):
        super().__init__()
        self.drop = Dropper(dropout_p, variational)
        self.linear = nn.Linear(y_size, x_size)

    def forward(self, x, y, x_mask, mask_flag: bool = True):
        x, y = self.drop(x), self.drop(y)
        xWy = torch.bmm(x, self.linear(y)[:, :, None])[..., 0]
        if mask_flag:
            xWy = torch.where(
                x_mask.bool(), xWy, torch.full_like(xWy, NEG_INF)
            )
        return xWy


class GetFinalScores(nn.Module):
    """Final candidate scores (`Layers.py:352-432`): with ``use_es`` the
    candidate axis splits at ``es_len`` (ES candidates score through a
    second bilinear head); sentinel heads (yes/no/noread, no-answer) each
    use an attended summary + linear-to-scalar; the concatenated score
    vector is softmaxed (`Layers.py:418`)."""

    def __init__(self, x_size: int, h_size: int, yesno: bool = False,
                 no_answer: bool = False, use_es: bool = False,
                 dropout_p: float = 0.0, variational: bool = True):
        super().__init__()
        self.yesno, self.no_answer, self.use_es = yesno, no_answer, use_es
        self.drop = Dropper(dropout_p, variational)
        self.attn = BilinearSeqAttn(x_size, h_size, dropout_p, variational)
        if use_es:
            self.attn2 = BilinearSeqAttn(x_size, h_size, dropout_p, variational)
        heads = (("no", "yes", "no_read") if yesno else ()) + (
            ("noanswer",) if no_answer else ()
        )
        for prefix in heads:
            self.add_module(f"{prefix}_linear", nn.Linear(h_size, x_size))
            self.add_module(f"{prefix}_w", nn.Linear(x_size, 1))

    def forward(self, x, h0, x_mask, es_len: Optional[int] = None,
                mask_flag: bool = False):
        if self.use_es:
            if es_len is None:
                raise ValueError("GetFinalScores(use_es=True) needs es_len")
            score_ocr = self.attn(
                x[:, es_len:], h0, x_mask[:, es_len:], mask_flag
            )
            score_es = self.attn2(
                x[:, :es_len], h0, x_mask[:, :es_len], mask_flag
            )
            score_s = torch.cat([score_es, score_ocr], dim=-1)
        else:
            score_s = self.attn(x, h0, x_mask, mask_flag)
        if self.yesno:
            h0d = self.drop(h0)
            score_s = torch.cat(
                [self._single(x, h0d, x_mask, "no_read"),
                 self._single(x, h0d, x_mask, "yes"),
                 self._single(x, h0d, x_mask, "no"), score_s],
                dim=-1,
            )
        if self.no_answer:
            score_s = torch.cat(
                [score_s, self._single(x, self.drop(h0), x_mask, "noanswer")],
                dim=-1,
            )
        return torch.softmax(score_s, dim=-1)

    def _single(self, x, h, x_mask, prefix: str):
        """Attended-summary scalar score (`Layers.py:421-432`)."""
        Wh = getattr(self, f"{prefix}_linear")(h)
        xWh = torch.bmm(x, Wh[:, :, None])[..., 0]
        alpha = masked_softmax(xWh, x_mask)
        attn_x = torch.bmm(alpha[:, None, :], x)[:, 0]
        return getattr(self, f"{prefix}_w")(attn_x)


def whole_tensor_layer_norm(x: torch.Tensor, eps: float = 1e-5,
                            group=None) -> torch.Tensor:
    """``F.layer_norm(x, x.size())`` — normalization over ALL axes of the
    batch tensor with no learned affine, the form used after every context
    RNN layer (`Layers.py:167-168`). Every score in a batch therefore
    depends on every row of it.

    With ``group`` (the dp group of a mesh) ``x`` is this rank's rows of
    the global batch tensor, whose moments the JAX program takes over all
    of it: the sum and the count are summed over the group, then the sum of
    squared deviations from the global mean — two differentiable
    all-reduces, so the gradient crosses ranks as it does in the global
    program."""
    if group is None:
        mean = x.mean()
        var = x.var(unbiased=False)
    else:
        stats = torch.stack([x.sum(), x.new_tensor(float(x.numel()))])
        total, count = all_reduce(stats, group).unbind()
        mean = total / count
        var = all_reduce(((x - mean) ** 2).sum(), group) / count
    return (x - mean) * torch.rsqrt(var + eps)

