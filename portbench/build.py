"""What a run is made of, built from its files and its seed: the conf of a
configuration, and seeded weights made on the device.

The weights follow the port's ``RUArtModel.init_weights`` distributions
(BERT weights N(0, initializer_range); word tables U(-1, 1); other linears
U(+-1/sqrt(fan_in)); LSTMs U(+-1/sqrt(hidden)); biases 0; LayerNorm 1 and
0; the layer-combine weights and attention diagonals 1), drawn in two
large calls of one ``torch.Generator`` on the device, in the order of the
parameters' sorted names. :func:`make_weights` gives the same tensors for
any module with the same parameter names and shapes, so the program and
the reference start from the same weights without one reading the other's.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(kind: str, name: str) -> Dict[str, Any]:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def conf_lines(config: Dict[str, Any], extra: Dict[str, Any]) -> List[str]:
    """The conf of ``config`` as conf-file lines, ``extra`` first (the
    first occurrence of a key wins)."""
    lines = []
    for opts in (extra, config["conf"]):
        for k, v in opts.items():
            lines.append(k if v is True else f"{k}\t{v}")
    return lines


def _rules(model: nn.Module) -> List[Tuple[str, torch.Tensor, str, float]]:
    """(name, parameter, rule, scale) for every parameter of ``model``;
    rule is 'normal', 'uniform' or 'fill'."""
    bert_std = None
    rules: Dict[str, Tuple[torch.Tensor, str, float]] = {}
    for name, mod in model.named_modules():
        in_bert = name == "Bert" or name.startswith("Bert.")
        if in_bert and bert_std is None:
            bert_std = float(getattr(getattr(mod, "config", None),
                                     "initializer_range", 0.02))
        prefix = f"{name}." if name else ""
        if isinstance(mod, nn.LayerNorm):
            rules[prefix + "weight"] = (mod.weight, "fill", 1.0)
            rules[prefix + "bias"] = (mod.bias, "fill", 0.0)
        elif isinstance(mod, nn.Embedding):
            rules[prefix + "weight"] = (
                (mod.weight, "normal", bert_std) if in_bert
                else (mod.weight, "uniform", 1.0))
        elif isinstance(mod, nn.Linear):
            rules[prefix + "weight"] = (
                (mod.weight, "normal", bert_std) if in_bert
                else (mod.weight, "uniform", 1.0 / math.sqrt(mod.in_features)))
            if mod.bias is not None:
                rules[prefix + "bias"] = (mod.bias, "fill", 0.0)
        elif isinstance(mod, nn.LSTM):
            for pname, p in mod.named_parameters():
                rules[prefix + pname] = (p, "uniform",
                                         1.0 / math.sqrt(mod.hidden_size))
    out = []
    for name, p in sorted(model.named_parameters()):
        if name in rules:
            out.append((name, *rules[name]))
        else:  # alphaBERT, gammaBERT, the attention diagonals
            out.append((name, p, "fill", 1.0))
    return out


@torch.no_grad()
def make_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``model`` (on its device) from ``seed``."""
    rules = _rules(model)
    device = rules[0][1].device
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    for kind in ("normal", "uniform"):
        group = [(p, scale) for _, p, rule, scale in rules if rule == kind]
        total = sum(p.numel() for p, _ in group)
        flat = torch.empty(total, device=device, dtype=torch.float32)
        if kind == "normal":
            flat.normal_(0.0, 1.0, generator=gen)
        else:
            flat.uniform_(-1.0, 1.0, generator=gen)
        at = 0
        for p, scale in group:
            n = p.numel()
            p.copy_(flat[at:at + n].view_as(p).mul_(scale))
            at += n
        del flat
    for _, p, rule, scale in rules:
        if rule == "fill":
            p.fill_(scale)
    return model
