"""A reference-style BERT directory -> the port's BERT weights — port of
``ruart_tpu/models/bert/convert.py``.

A directory holds ``bert_config.json`` and ``pytorch_model.bin`` (a
2018-era state dict with gamma/beta LayerNorm names, or a modern HF
``BertModel`` one); the name mapping itself is
``ruart_tpu_torch.convert.bert_state_from_torch``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from ruart_tpu_torch.convert import bert_state_from_torch
from ruart_tpu_torch.models.bert.config import BertConfig


def load_bert_params(model_dir: str
                     ) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """(config from ``bert_config.json``, the entries of ``RUArtModel``'s
    ``Bert`` submodule — ``Bert.<...>`` — from ``pytorch_model.bin``)."""
    config = BertConfig.from_json(os.path.join(model_dir, "bert_config.json"))
    state = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                       map_location="cpu", weights_only=True)
    return config, bert_state_from_torch(state, config.num_hidden_layers)
