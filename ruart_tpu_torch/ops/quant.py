"""Weight-only int8 quantization of the (frozen) BERT encoder — port of
``ruart_tpu/ops/quant.py``.

The ``INT8_BERT`` serving mode: every projection/FFN Linear of the encoder
layers (:data:`QUANT_LAYER_NAMES`) holds a symmetric per-output-channel
int8 weight and an fp32 scale; the product runs in the activation dtype on
the dequantized weight, with the scale folded into the epilogue
(:class:`QuantLinear`). Embeddings, LayerNorms and the pooler stay fp32.

Layouts: flax kernels are [in, out], torch weights [out, in]; the scale is
per OUTPUT channel in both (``amax`` over the flax kernel's axis 0, over
the torch weight's dim 1). Rounding is half-to-even in both packages
(``jnp.round``, ``torch.round``), so the int8 weights and scales of the
two packages are bit-equal.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Linear submodules of BertSelfAttention / BertLayer that get quantized.
# The pooler is excluded: its output feeds tanh directly and is tiny.
QUANT_LAYER_NAMES = (
    "query",
    "key",
    "value",
    "attention_output_dense",
    "intermediate_dense",
    "output_dense",
)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: w [out, in] -> (q int8 [out, in],
    scale fp32 [out]) with q * scale ~= w and |q| <= 127."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    # a true division on every device: on CUDA ``amax / 127.0`` (a Python
    # scalar) runs as a product with its reciprocal, which rounds apart
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


class QuantLinear(nn.Module):
    """Drop-in Linear with an int8 ``weight_q`` [out, in], a per-channel
    fp32 ``scale`` [out] and an fp32 ``bias`` [out] (frozen parameters).

    Placeholders at construction (zeros / ones) — real values come from
    :func:`quantize_bert_params` applied to an fp32 state dict. The forward
    follows the JAX package's ``QuantDense`` in the input's type (fp32, or
    bf16 under ``BF16``): the product of the input and the int8 weight with
    fp32 sums and an fp32 result, then ``y * scale + bias`` in fp32,
    rounded to the input's type. A bf16 input and the int8 weight are both
    exact in fp32, so the product runs as an fp32 one."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_q = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8),
            requires_grad=False,
        )
        self.scale = nn.Parameter(torch.ones(out_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.float(), self.weight_q.float())
        return (y * self.scale + self.bias).to(x.dtype)


def quantize_bert_params(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """fp32 state dict -> the state dict a ``quant='int8'`` model expects.

    Works on any state dict holding BERT encoder layers (the whole
    ``RUArtModel`` or a bare ``BertModel``): every ``<name>.weight`` whose
    module name is in :data:`QUANT_LAYER_NAMES` becomes ``<name>.weight_q``
    + ``<name>.scale`` (its bias is kept, as fp32); every other entry
    passes through unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        if mods and mods[-1] in QUANT_LAYER_NAMES and leaf in ("weight", "bias"):
            prefix = ".".join(mods)
            if leaf == "weight":
                q, scale = quantize_weight(value)
                out[prefix + ".weight_q"] = q
                out[prefix + ".scale"] = scale
            else:
                out[key] = value.float()
        else:
            out[key] = value
    return out
