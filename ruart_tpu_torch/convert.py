"""Weight bridge: a flax ``RUArtModel`` param tree -> the port's state dict.

The port names its modules after the flax tree, so each flax leaf maps to
one state-dict entry by its path ('/' becomes '.') and a leaf rename:

* Dense ``kernel`` [in, out]   -> Linear ``weight`` [out, in] (transposed)
* Embed ``embedding``          -> Embedding ``weight``
* LayerNorm ``scale``          -> LayerNorm ``weight``
* ``rnn_<i>/fwd|bwd/w_ih`` ... -> ``rnn_<i>.weight_ih_l0[_reverse]`` ...
  (the JAX LSTMs already use torch's layout and gate order)
* ``bias``, ``diagonal``, ``alphaBERT``, ``gammaBERT`` keep their names.

No JAX is imported: the caller hands over nested dicts of numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

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
    for path, value in _leaves(tree):
        arr = np.asarray(value)
        *mods, leaf = path
        if leaf in _LSTM_LEAVES:
            *mods, direction = mods
            name = _LSTM_LEAVES[leaf] + ("_reverse" if direction == "bwd" else "")
        elif leaf == "kernel":
            name, arr = "weight", arr.T
        elif leaf in ("embedding", "scale"):
            name = "weight"
        else:
            name = leaf
        out[".".join([*mods, name])] = torch.from_numpy(np.array(arr))
    return out
