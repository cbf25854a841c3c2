"""History-of-word multi-level inter-attention (`Models/Layers.py:471-524`)
— port of ``ruart_tpu/models/fusion/deep_attention.py``.

x1 (context/candidates) attends to x2 (question) at every abstraction
level: the attention keys are the concatenation of word-level and
all-but-last abstraction layers on both sides; each level's values are one
x2 abstraction layer; the concatenated [x1 abstractions ‖ attended levels]
feeds a BiLSTM. Under ``no_DeepAttention`` the BiLSTM reads the x1
abstractions alone.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from portbench.reference.layers import Attention
from portbench.reference.rnn import StackedBRNN


class DeepAttention(nn.Module):
    def __init__(self, att_size: int, value_sizes: Sequence[int],
                 abstr_size: int, deep_att_hidden_size_per_abstr: int,
                 highlvl_hidden_size: int, correlation_func: int = 3,
                 no_deep_attention: bool = False,
                 dropout_p: float = 0.0, variational: bool = True):
        """``att_size``: width of the concatenated attention keys (equal on
        both sides); ``value_sizes``: width of each x2 abstraction layer;
        ``abstr_size``: width of the concatenated x1 abstraction layers."""
        super().__init__()
        self.levels = 0 if no_deep_attention else len(value_sizes)
        for i in range(self.levels):
            self.add_module(f"int_attn_{i}", Attention(
                att_size, deep_att_hidden_size_per_abstr, correlation_func,
                dropout_p=dropout_p, variational=variational,
            ))
        attended = sum(value_sizes) if self.levels else 0
        self.rnn = StackedBRNN(
            abstr_size + attended, highlvl_hidden_size, num_layers=1,
            dropout_p=dropout_p, variational=variational,
        )

    def forward(self, x1_word, x1_abstr, x2_word, x2_abstr, x1_mask, x2_mask):
        """Returns (x1_hiddens, x1) — the BiLSTM output and its input."""
        x1 = [torch.cat(list(x1_abstr), dim=2)]
        if self.levels:
            x1_att = torch.cat(list(x1_word) + list(x1_abstr), dim=2)
            x2_att = torch.cat(list(x2_word) + list(x2_abstr[:-1]), dim=2)
            for i, values in enumerate(x2_abstr):
                x1.append(getattr(self, f"int_attn_{i}")(
                    x1_att, x2_att, x2_mask, x3=values
                ))
        x1 = torch.cat(x1, dim=2)
        return self.rnn(x1), x1
