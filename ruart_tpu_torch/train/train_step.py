"""Train and eval steps — port of ``ruart_tpu/train/train_step.py``.

One train step: forward in training mode (dropout from the model's seeded
generator), loss, backward, the clipped optimizer update and the row
pinning, all enqueued on the device. The loss comes back as a device
tensor: the caller reads it when it needs the value (the trainer does so
every ``log_every`` steps), never with a per-step host sync.

``debug_nans`` (the ``DEBUG_NANS`` conf flag, and the ``debug_nans`` conf
key through the CLIs) checks ``torch.isfinite`` at the JAX package's
checkify sites — targets, float batch inputs, scores, loss — and raises
FloatingPointError with the same messages; the eval step checks its
scores. Each check reads a flag on the host: debug only.

On a (dp, tp) mesh (``mesh``) the model computes this rank's rows of the
global batch; the rank backpropagates its loss divided by the mesh size
(the tp ranks of a dp slice compute the same loss), the optimizer sums the
gradients over their copies, and the loss returned is the global batch's
(the mean over dp). The eval step gathers the [B, C] scores over dp.

On a card the eval step is the counterpart of the JAX package's
``jax.jit(eval_step)``: one CUDA graph per batch signature
(``utils.graphs.SignatureGraphs``), behind serving, ``main_test`` and the
trainer's evaluation. The train step's device part is the counterpart of
``jax.jit(train_step, donate_argnums=(0,))`` in the same way, behind
``Trainer.train``: the parameters, the moments and the dropout
generator's state stay in place (the donated state), and what changes
from step to step on the host (the step count, the bias corrections)
reaches the graph as device tensors written before each replay.
:func:`eager_reason` says when a step stays eager.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ruart_tpu_torch.models.fusion.introspect import is_recording
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.train.optim import Optimizer
from ruart_tpu_torch.utils.graphs import SignatureGraphs


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


def _check_scores(scores: torch.Tensor):
    _check_finite(torch.isfinite(scores).all(),
                  "NaN/Inf in scores (SDNetTrainer.py:339-347 / "
                  "Layers.py:169,290 sentinel)")


def make_train_step(
    loss_fn: Callable,
    row_pinner: Callable[[], None],
    debug_nans: bool = False,
    mesh=None,
    graphs: bool = True,
):
    """Returns ``step(state, q, ocr, od, targets) -> (state, loss)``;
    ``state`` is updated in place and returned, ``loss`` is a 0-d device
    tensor of its own. On a ``mesh`` the batch is this rank's slice (see
    the module doc).

    A step is the host's part (``Optimizer.advance``: the step count and
    its bias corrections; ``state.step``) around the device's part: the
    forward in training mode, the loss, the backward, ``Optimizer.update``
    and the row pinning. On a card the device's part is a
    ``utils.graphs.SignatureGraphs`` over ``state``: one CUDA graph per
    batch signature with the dropout generator registered, the first call
    of a signature being its eager step, later calls replays. It stays
    eager where :func:`eager_reason` gives a reason. ``step.graphs`` is
    that ``SignatureGraphs`` once the first call with ``state`` made it,
    else None."""
    size = mesh.size if mesh is not None else 1

    def device_step(state: TrainState, q: Dict[str, torch.Tensor],
                    ocr: Dict[str, torch.Tensor], od: Dict[str, torch.Tensor],
                    targets: torch.Tensor) -> torch.Tensor:
        if debug_nans:
            _check_inputs(q, ocr, od, targets)
        model, opt = state.model, state.optimizer
        model.train()
        # a capture's backward then writes fresh gradients into its pool
        opt.zero_grad()
        scores = model(q, ocr, od)
        if debug_nans:
            _check_scores(scores)
        loss = loss_fn(scores, targets)
        if debug_nans:
            _check_finite(torch.isfinite(loss),
                          "NaN/Inf loss (SDNetTrainer.py:352-359 sentinel)")
        (loss / size if size > 1 else loss).backward()
        opt.update()
        row_pinner()
        return loss.detach()

    def train_step(state: TrainState, q, ocr, od, targets):
        if train_step.state is not state:
            train_step.state, train_step.graphs = state, None
            device = next(state.model.parameters()).device
            if eager_reason(device, mesh, debug_nans, graphs) is None:
                train_step.graphs = SignatureGraphs(
                    functools.partial(device_step, state), device,
                    generators=(state.generator,))
        state.optimizer.advance()
        if train_step.graphs is None:
            loss = device_step(state, q, ocr, od, targets)
        else:  # the graph's loss is overwritten by its next replay
            loss = train_step.graphs(q, ocr, od, targets).clone()
        state.step += 1
        return state, dp_mean(loss, mesh)

    train_step.state = train_step.graphs = None
    return train_step


def dp_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the dp ranks of ``mesh`` (``x`` itself on
    one rank)."""
    if mesh is None or mesh.dp_group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.dp_group)
    return x / mesh.dp


def dp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The dp ranks' row blocks of ``x`` concatenated in dp order."""
    if mesh is None or mesh.dp_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.dp_group)
    return torch.cat(parts)


def eager_reason(device: torch.device, mesh=None, debug_nans: bool = False,
                 graphs: bool = True) -> Optional[str]:
    """Why :func:`make_eval_step` or :func:`make_train_step` keeps its step
    eager, or None when it replays CUDA graphs. Each reason is a condition
    the caller sets: ``graphs=False`` (the port's ``jax.disable_jit``), a
    model on the CPU, a ``mesh`` (its collectives run on gloo, which a
    graph cannot capture; NCCL capture needs a host with several cards to
    be tried), and ``debug_nans`` (its check reads each step's scores on
    the host, which a capture cannot do; the eager step checks every call
    and stops at the first NaN)."""
    if not graphs:
        return "graphs=False"
    if device.type != "cuda":
        return f"device {device.type}"
    if mesh is not None:
        return "mesh"
    if debug_nans:
        return "debug_nans"
    return None


def make_eval_step(model: RUArtModel, loss_fn: Optional[Callable] = None,
                   mesh=None, debug_nans: bool = False, graphs: bool = True):
    """Returns ``step(q, ocr, od, targets) -> (scores, loss)`` in eval mode
    without an autograd graph; the loss is 0 without ``loss_fn`` or
    targets. On a ``mesh`` the batch is this rank's slice: the scores of
    the global batch are gathered over dp, the loss is its mean over dp.

    On a card the step is a :class:`~ruart_tpu_torch.utils.graphs.
    SignatureGraphs`: one CUDA graph per batch signature, captured at the
    signature's first call and replayed after; its outputs are overwritten
    by the next call of the same signature, so the caller copies them out
    first (``data.pipeline.fetch_async``). It stays eager where
    :func:`eager_reason` gives a reason, and for each call made while
    ``models.fusion.introspect.record_intermediates`` records the model."""

    def eval_step(q, ocr, od, targets):
        model.eval()
        with torch.no_grad():
            scores = model(q, ocr, od)
            if debug_nans:
                _check_scores(scores)
            if loss_fn is not None and targets is not None:
                loss = loss_fn(scores, targets)
            else:
                loss = torch.zeros((), device=scores.device)
        return dp_gather(scores, mesh), dp_mean(loss, mesh)

    device = next(model.parameters()).device
    if eager_reason(device, mesh, debug_nans, graphs) is not None:
        return eval_step
    return SignatureGraphs(eval_step, device,
                           eager_when=lambda: is_recording(model))
