"""Reference SDNet torch checkpoint <-> the port's ``RUArtModel`` state dict
— port of ``ruart_tpu/models/fusion/convert.py``.

The reference saves ``{'state_dict': {'network': ...}}``
(`SDNetTrainer.save/load_model:453-509`). The port names its modules after
the flax tree, which keeps most of the reference's names and layouts
(torch Linear and LSTM weights as they are); the differences:

* StackedBRNN layer ``<mod>.rnns.<i>.*`` -> ``<mod>.rnn_<i>.*``;
* deep attention ``deep_attn.int_attn_list.<i>`` -> ``deep_attn.int_attn_<i>``;
* AttentionScore ``diagonal`` [1, 1, H] -> [H]; the size-1 diagonal of a
  ``do_similarity`` attention (a frozen scalar, not a parameter here) is
  dropped;
* ``alphaBERT`` -> [n_layers];
* the nested BERT ``Bert.bert_model.*`` goes through
  ``ruart_tpu_torch.convert.bert_state_from_torch``;
* the reference's dead GRU pointer cell (``get_answer.rnn.*``) is dropped.

:func:`load_sdnet_checkpoint` keeps the reference's key-intersection
tolerance: an entry the model lacks, or of another shape, is skipped, and
the model keeps its value there. :func:`params_to_torch_state` is the
inverse for the fusion stack (export and round-trip tests).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from ruart_tpu_torch.convert import bert_state_from_torch

_BERT = "Bert.bert_model."
_DEAD = ("get_answer.rnn.",)


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def convert_sdnet_state_dict(state: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Reference names -> the port's state-dict entries (the subset the
    checkpoint holds)."""
    out: Dict[str, torch.Tensor] = {}
    bert = {}
    for key, value in state.items():
        if key.startswith(_BERT):
            bert[key[len(_BERT):]] = value
            continue
        if key.startswith(_DEAD):
            continue
        value = _tensor(value)
        name = re.sub(r"\.rnns\.(\d+)\.", r".rnn_\1.", key)
        name = re.sub(r"\.int_attn_list\.(\d+)\.", r".int_attn_\1.", name)
        if name.endswith(".scoring.diagonal") or name == "alphaBERT":
            if value.numel() == 1 and name != "alphaBERT":
                continue  # do_similarity's frozen 1/sqrt(hidden)
            value = value.reshape(-1)
        out[name] = value
    if bert:
        n_layers = 1 + max(int(k.split(".")[2]) for k in bert
                           if k.startswith("encoder.layer."))
        out.update(bert_state_from_torch(bert, n_layers))
    return out


def load_sdnet_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a reference ``.pt`` checkpoint into ``model`` in place, with the
    reference's key-intersection tolerance (`load_model:453-466`); returns
    ``model``. The file is a full pickle (the reference stores its conf and
    random states beside the weights): load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    converted = convert_sdnet_state_dict(ckpt["state_dict"]["network"])
    current = model.state_dict()
    merged = {
        k: v for k, v in converted.items()
        if k in current and tuple(v.shape) == tuple(current[k].shape)
    }
    model.load_state_dict(merged, strict=False)
    return model


def params_to_torch_state(model: Union[nn.Module, Mapping[str, Any]]
                          ) -> Dict[str, np.ndarray]:
    """The fusion stack's weights (not ``Bert.*``) under the reference's
    names and layouts, as numpy arrays."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        if key.startswith("Bert."):
            continue
        arr = _tensor(value).numpy()
        name = re.sub(r"\.rnn_(\d+)\.", r".rnns.\1.", key)
        name = re.sub(r"\.int_attn_(\d+)\.", r".int_attn_list.\1.", name)
        if name.endswith(".scoring.diagonal"):
            arr = arr.reshape(1, 1, -1)
        out[name] = arr
    return out
