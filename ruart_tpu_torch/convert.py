"""Weight bridge between a flax ``RUArtModel`` param tree and the port's
state dict, both ways (:func:`from_jax_params`, :func:`to_jax_params`).

The port names its modules after the flax tree, so each flax leaf maps to
one state-dict entry by its path ('/' becomes '.') and a leaf rename:

* Dense ``kernel`` [in, out]   -> Linear ``weight`` [out, in] (transposed)
* QuantDense ``kernel_q`` [in, out] / ``scale`` / ``bias`` -> QuantLinear
  ``weight_q`` [out, in] (transposed) / ``scale`` / ``bias`` (INT8_BERT)
* Embed ``embedding``          -> Embedding ``weight``
* LayerNorm ``scale``          -> LayerNorm ``weight``
* ``rnn_<i>/fwd|bwd/w_ih`` ... -> ``rnn_<i>.weight_ih_l0[_reverse]`` ...
  (the JAX LSTMs already use torch's layout and gate order)
* ``bias``, ``diagonal``, ``alphaBERT``, ``gammaBERT`` keep their names.

No JAX is imported: the caller hands over nested dicts of numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``) and gets them back.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ruart_tpu_torch.ops.quant import QuantLinear

_LSTM_LEAVES = {
    "w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
    "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0",
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (``{'params': {...}}`` or the inner tree) -> state dict
    of ``ruart_tpu_torch.models.fusion.model.RUArtModel``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    leaves = list(_leaves(tree))
    quant = {path[:-1] for path, _ in leaves if path[-1] == "kernel_q"}
    for path, value in leaves:
        arr = np.asarray(value)
        *mods, leaf = path
        if leaf in _LSTM_LEAVES:
            *mods, direction = mods
            name = _LSTM_LEAVES[leaf] + ("_reverse" if direction == "bwd" else "")
        elif leaf == "kernel":
            name, arr = "weight", arr.T
        elif leaf == "kernel_q":
            name, arr = "weight_q", arr.T
        elif leaf == "scale" and path[:-1] in quant:
            name = "scale"  # a QuantDense's per-channel scale
        elif leaf in ("embedding", "scale"):
            name = "weight"
        else:
            name = leaf
        out[".".join([*mods, name])] = torch.from_numpy(np.array(arr))
    return out


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The port's parameters as a flax tree ``{'params': {...}}`` of numpy
    arrays, under the flax paths and layouts (the inverse of
    :func:`from_jax_params`). The module type decides each leaf's flax
    name: Linear ``weight`` -> Dense ``kernel`` (transposed), QuantLinear
    ``weight_q`` -> ``kernel_q`` (transposed), Embedding ``weight`` ->
    ``embedding``, LayerNorm ``weight`` -> ``scale``, LSTM
    ``*_l0[_reverse]`` -> ``fwd|bwd/w_ih`` ..."""
    lstm = {v: k for k, v in _LSTM_LEAVES.items()}
    tree: Dict[str, Any] = {}
    for mod_name, mod in model.named_modules():
        mods = mod_name.split(".") if mod_name else []
        for leaf, p in mod.named_parameters(recurse=False):
            arr = p.detach().cpu().numpy()
            path = [*mods, leaf]
            if isinstance(mod, nn.LSTM):
                base = leaf[: -len("_reverse")] if leaf.endswith("_reverse") else leaf
                direction = "bwd" if leaf.endswith("_reverse") else "fwd"
                path = [*mods, direction, lstm[base]]
            elif isinstance(mod, nn.Linear) and leaf == "weight":
                path, arr = [*mods, "kernel"], arr.T
            elif isinstance(mod, QuantLinear) and leaf == "weight_q":
                path, arr = [*mods, "kernel_q"], arr.T
            elif isinstance(mod, nn.Embedding):
                path = [*mods, "embedding"]
            elif isinstance(mod, nn.LayerNorm) and leaf == "weight":
                path = [*mods, "scale"]
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


def bert_state_from_torch(state: Mapping[str, Any], num_layers: int
                          ) -> Dict[str, torch.Tensor]:
    """A pretrained torch BERT state dict (a 2018 ``pytorch_model.bin``
    with gamma/beta LayerNorm names, or a modern HF ``BertModel``) -> the
    entries of the port's ``Bert`` submodule (``Bert.<...>``). Same mapping
    as ``ruart_tpu/models/bert/convert.py::convert_bert_state_dict``."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else
              np.asarray(v)) for k, v in state.items()}
    if all(k.startswith("bert.") for k in sd if "embeddings" in k or "encoder" in k):
        sd = {k[len("bert."):] if k.startswith("bert.") else k: v
              for k, v in sd.items()}

    def ln(prefix):
        return {"scale": sd.get(prefix + ".gamma", sd.get(prefix + ".weight")),
                "bias": sd.get(prefix + ".beta", sd.get(prefix + ".bias"))}

    def dense(prefix):
        return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}

    tree: Dict[str, Any] = {
        "embeddings": {
            name: {"embedding": sd[f"embeddings.{name}.weight"]}
            for name in ("word_embeddings", "position_embeddings",
                         "token_type_embeddings")
        },
        "pooler_dense": dense("pooler.dense"),
    }
    tree["embeddings"]["LayerNorm"] = ln("embeddings.LayerNorm")
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        tree[f"layer_{i}"] = {
            "attention_self": {
                name: dense(p + "attention.self." + name)
                for name in ("query", "key", "value")
            },
            "attention_output_dense": dense(p + "attention.output.dense"),
            "attention_output_LayerNorm": ln(p + "attention.output.LayerNorm"),
            "intermediate_dense": dense(p + "intermediate.dense"),
            "output_dense": dense(p + "output.dense"),
            "output_LayerNorm": ln(p + "output.LayerNorm"),
        }
    return from_jax_params({"Bert": tree})
