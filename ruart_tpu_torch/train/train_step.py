"""Train and eval steps — port of ``ruart_tpu/train/train_step.py``.

One train step: forward in training mode (dropout from the model's seeded
generator), loss, backward, the clipped optimizer update and the row
pinning, all enqueued on the device. The loss comes back as a device
tensor: the caller reads it when it needs the value (the trainer does so
every ``log_every`` steps), never with a per-step host sync.

``debug_nans`` (the ``DEBUG_NANS`` conf flag) checks ``torch.isfinite`` at
the JAX package's checkify sites — targets, float batch inputs, scores,
loss — and raises FloatingPointError with the same messages. Each check
reads a flag on the host: debug only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    """The counterpart of the JAX ``TrainState``: the model holds the
    parameters, the optimizer its state, ``generator`` the dropout
    stream, ``step`` the number of steps taken."""

    model: RUArtModel
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def init_train_state(model: RUArtModel, optimizer: Optimizer,
                     seed: int) -> TrainState:
    return TrainState(model, optimizer, model.seed_dropout(seed))


def _check_finite(ok: torch.Tensor, message: str):
    if not bool(ok):
        raise FloatingPointError(message)


def _check_inputs(q, ocr, od, targets):
    _check_finite(torch.isfinite(targets).all(),
                  "NaN/Inf in targets (SDNetTrainer.py:348-351 sentinel)")
    for name, item in (("q", q), ("ocr", ocr), ("od", od)):
        for key, arr in item.items():
            if arr.is_floating_point():
                _check_finite(
                    torch.isfinite(arr).all(),
                    f"NaN/Inf in batch input {name}.{key} "
                    "(SDNetTrainer.py:224-226 sentinel)",
                )


def make_train_step(
    loss_fn: Callable,
    row_pinner: Callable[[], None],
    debug_nans: bool = False,
):
    """Returns ``step(state, q, ocr, od, targets) -> (state, loss)``;
    ``state`` is updated in place and returned, ``loss`` is a 0-d device
    tensor."""

    def train_step(state: TrainState, q: Dict[str, torch.Tensor],
                   ocr: Dict[str, torch.Tensor], od: Dict[str, torch.Tensor],
                   targets: torch.Tensor):
        if debug_nans:
            _check_inputs(q, ocr, od, targets)
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        scores = model(q, ocr, od)
        if debug_nans:
            _check_finite(torch.isfinite(scores).all(),
                          "NaN/Inf in scores (SDNetTrainer.py:339-347 / "
                          "Layers.py:169,290 sentinel)")
        loss = loss_fn(scores, targets)
        if debug_nans:
            _check_finite(torch.isfinite(loss),
                          "NaN/Inf loss (SDNetTrainer.py:352-359 sentinel)")
        loss.backward()
        opt.step()
        row_pinner()
        state.step += 1
        return state, loss.detach()

    return train_step


def make_eval_step(model: RUArtModel, loss_fn: Optional[Callable] = None):
    """Returns ``step(q, ocr, od, targets) -> (scores, loss)`` in eval mode
    without a graph; the loss is 0 without ``loss_fn`` or targets."""

    def eval_step(q, ocr, od, targets):
        model.eval()
        with torch.no_grad():
            scores = model(q, ocr, od)
            if loss_fn is not None and targets is not None:
                loss = loss_fn(scores, targets)
            else:
                loss = torch.zeros((), device=scores.device)
        return scores, loss

    return eval_step
