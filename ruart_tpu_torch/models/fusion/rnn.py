"""LSTM stacks — port of ``ruart_tpu/models/fusion/rnn.py``.

The reference runs cuDNN LSTMs over fully padded sequences — no packing,
no mask gating (`Models/Layers.py:156-180`) — so the backward direction
passes through the pads. The JAX package reproduces that with a
``lax.scan`` in the torch parameter layout (``w_ih [4H, in]``, gates
i, f, g, o), so ``torch.nn.LSTM`` takes its parameters as they are: each
layer here is one ``nn.LSTM`` over the padded batch. Callers that need
length-aware outputs gather by index afterwards (:func:`gather_last_state`).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ruart_tpu_torch.models.fusion.layers import Dropper, whole_tensor_layer_norm


class StackedBRNN(nn.Module):
    """Multi-layer (Bi)LSTM with per-layer outputs (`Layers.py:124-180`).

    * dropout on each layer's input in training mode (``dropout_p``)
    * optional whole-tensor layer norm after each layer (``ln=True``),
      its moments summed over ``ln_group`` (a mesh's dp group) when set
    * ``concat_layers`` concatenates per-layer outputs on the feature axis

    Layer i is ``rnn_<i>``, an ``nn.LSTM`` (``weight_ih_l0`` and, when
    bidirectional, ``weight_ih_l0_reverse`` ...)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = True, concat_layers: bool = False,
                 dropout_p: float = 0.0, variational: bool = True):
        super().__init__()
        self.drop = Dropper(dropout_p, variational)
        self.num_layers = num_layers
        self.concat_layers = concat_layers
        self.ln_group = None
        width = hidden_size * (2 if bidirectional else 1)
        for i in range(num_layers):
            self.add_module(f"rnn_{i}", nn.LSTM(
                input_size if i == 0 else width, hidden_size,
                batch_first=True, bidirectional=bidirectional,
            ))

    def forward(self, x: torch.Tensor, ln: bool = False,
                return_list: bool = False, layout: str = "dense"):
        """``layout``: the row layout of ``x``'s dim 0 for the dropout
        (``Dropper``)."""
        hiddens: List[torch.Tensor] = [x]
        for i in range(self.num_layers):
            out = getattr(self, f"rnn_{i}")(self.drop(hiddens[-1], layout))[0]
            if ln:
                out = whole_tensor_layer_norm(out, group=self.ln_group)
            hiddens.append(out)
        output = (
            torch.cat(hiddens[1:], dim=-1) if self.concat_layers
            else hiddens[-1]
        )
        if return_list:
            return output, hiddens[1:]
        return output


def gather_last_state(outputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """outputs [B, L, D], lengths [B] -> the output at index len-1 per row
    (the multi2one last-valid-state pick, `SDNet.py:303-311`). Rows with
    length 0 take position 0."""
    idx = (lengths.long() - 1).clamp(min=0)
    return outputs[torch.arange(outputs.shape[0], device=outputs.device), idx]
