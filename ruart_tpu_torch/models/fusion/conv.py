"""Character-CNN building blocks (`Models/Layers.py:41-122`) — port of
``ruart_tpu/models/fusion/conv.py``.

Library-surface parity: the reference defines a char-CNN + max/average
pooling trio used by SDNet's character path (`SDNet.character_cnn:563-571`,
dormant in the shipped conf).
"""

from __future__ import annotations

import torch
from torch import nn

from ruart_tpu_torch.models.fusion.layers import Dropper


class CharCNN(nn.Module):
    """tanh(Conv1d(window, out)) over [N, L, In] -> [N, L, Out]; odd window,
    same padding, no bias (`Layers.py:41-71`). ``cnn.weight`` is torch's
    [Out, In, window]; the flax kernel is [window, In, Out]. Dropout on the
    input draws an element-wise mask (the JAX module passes
    ``variational=False`` to its dropout)."""

    def __init__(self, input_size: int, window_size: int, output_size: int,
                 dropout_p: float = 0.0):
        super().__init__()
        if window_size % 2 != 1:
            raise ValueError("window size must be an odd number")
        self.drop = Dropper(dropout_p, variational=False)
        self.cnn = nn.Conv1d(input_size, output_size, window_size,
                             padding=window_size // 2, bias=False)

    def forward(self, x: torch.Tensor, x_mask=None) -> torch.Tensor:
        x = self.drop(x)
        return torch.tanh(self.cnn(x.transpose(1, 2)).transpose(1, 2))


def max_pooling(x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """Masked max over the subitem axis; all-masked rows -> 0
    (`Layers.py:74-95`)."""
    MIN = -1e6
    masked = torch.where(x_mask[..., None].bool(), x, torch.full_like(x, MIN))
    out = masked.max(dim=-2).values
    return torch.where(out == MIN, torch.zeros_like(out), out)


def average_pooling(x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the subitem axis (`Layers.py:97-122`)."""
    m = x_mask[..., None].to(x.dtype)
    s = (x * m).sum(dim=-2)
    n = m.sum(dim=-2).clamp(min=1.0)
    return s / n
