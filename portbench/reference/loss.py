"""Training losses — port of ``ruart_tpu/train/loss.py``.

``BCE_D1`` (the shipped loss): elementwise binary cross entropy **with
logits** applied to the already-softmaxed score vector, mean over all
elements, scaled by the number of label slots — the reference's
`SDNetTrainer.instance_bce_with_logits:510-518`, including the quirk that
the "logits" are softmax outputs in [0, 1]. ``CE`` uses the argmax target
(`SDNetTrainer.py:343-344`).
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE-with-logits, mean-reduced, written
    as the JAX package writes it."""
    loss = (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return loss.mean()


def instance_bce_with_logits(
    scores: torch.Tensor, labels: torch.Tensor, scale_d1: bool = True
) -> torch.Tensor:
    if scores.dim() != 2:
        raise ValueError(f"scores must be [B, n], got {tuple(scores.shape)}")
    loss = bce_with_logits(scores, labels)
    if scale_d1:
        loss = loss * labels.shape[1]
    return loss


def cross_entropy(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE over the soft-label argmax (`SDNetTrainer.py:343-344`)."""
    targets = labels.argmax(dim=-1)
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(1, targets[:, None]).mean()


def make_loss_fn(loss_name: str):
    if loss_name in ("BCE", "BCE_D1"):
        scale = loss_name == "BCE_D1"
        return lambda s, l: instance_bce_with_logits(s, l, scale_d1=scale)
    if loss_name == "CE":
        return cross_entropy
    raise ValueError(f"unknown loss {loss_name!r}")
