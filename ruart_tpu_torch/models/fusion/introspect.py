"""Attention-map extraction (the reference's ``att_score`` surface) — port
of ``ruart_tpu/models/fusion/introspect.py``.

The reference threads a ``return_score`` flag through the forward pass and
collects per-module alphas (`SDNet.py:253-258`, `Layers.py:292-295`); the
JAX package has every Attention module ``sow`` its alpha into the
'intermediates' collection. Here :func:`record_intermediates` gives each
``Attention`` (and the model's candidate-embedding site) a list to append
to while it is open; outside it the lists are None and the forward does
no extra work. Keys follow the JAX package's module paths: the port names
its modules after the flax tree, '/' written as '.'.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import torch

from ruart_tpu_torch.models.fusion.layers import Attention


@contextlib.contextmanager
def record_intermediates(model) -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Record what the JAX forward sows while the context is open: yields
    ``{path: [tensor per call]}`` with ``<module path>/alpha`` for every
    Attention module and ``cand_emb`` for the candidate embedding before
    multi2one, filled as the model runs."""
    sites = {f"{name.replace('.', '/')}/alpha": mod
             for name, mod in model.named_modules() if isinstance(mod, Attention)}
    record: Dict[str, List[torch.Tensor]] = {}
    for path, mod in sites.items():
        mod.sown = record.setdefault(path, [])
    model.sown_cand_emb = record.setdefault("cand_emb", [])
    try:
        yield record
    finally:
        for mod in sites.values():
            mod.sown = None
        model.sown_cand_emb = None


def is_recording(model) -> bool:
    """True while :func:`record_intermediates` records ``model``."""
    return model.sown_cand_emb is not None


def forward_with_attention(model, q, ocr, od, **kwargs):
    """Returns (scores, {module_path: alpha tensor}). Alphas cover every
    Attention instance that ran (pre-align, deep attention levels, self
    attentions, OD→OCR and position attentions); a module that ran more
    than once gives ``<path>/alpha[i]`` for its i-th call, as the JAX
    package names a sown tuple."""
    with record_intermediates(model) as record:
        scores = model(q, ocr, od, **kwargs)
    alphas = {}
    for path, values in record.items():
        if not path.endswith("alpha"):
            continue
        if len(values) == 1:
            alphas[path] = values[0]
        else:
            for i, value in enumerate(values):
                alphas[f"{path}[{i}]"] = value
    return scores, alphas
