"""Warmup learning-rate schedules + BertAdam-style optimizer — port of
``ruart_tpu/train/schedules.py``.

The reference vendors a BERT Adam variant with decoupled weight decay and
warmup schedules (`Models/Bert/optimization.py:32-161`); it is never wired
into the trainer (`SDNetTrainer.py:307-317` uses Adamax) but belongs to the
library surface. The JAX package expresses them as optax schedules and an
optax chain; here a schedule is a function of the step that gives optax's
value (computed in float32, as optax computes it), and :class:`BertAdam`
is a ``torch.optim.Optimizer`` that applies the same chain.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from ruart_tpu_torch.train.optim import bias_correction

Schedule = Callable[[int], float]
_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule(init, end, steps)``."""
    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))
    return schedule


def _cosine(init: float, steps: int) -> Schedule:
    """``optax.cosine_decay_schedule(init, steps)`` (alpha 0, exponent 1)."""
    def schedule(count: int) -> float:
        c = _F32(min(count, steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(steps)))
        return float(_F32(init) * decay)
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules([first, second], [boundary])``."""
    return lambda step: first(step) if step < boundary else second(step - boundary)


def warmup_constant(lr: float, warmup: float, total_steps: int) -> Schedule:
    """lr * min(1, frac/warmup) (`optimization.py:37-40`)."""
    warmup_steps = max(int(warmup * total_steps), 1)
    return _join(_linear(0.0, lr, warmup_steps), lambda step: float(_F32(lr)),
                 warmup_steps)


def warmup_linear(lr: float, warmup: float, total_steps: int) -> Schedule:
    """Linear warmup then linear decay to 0 (`optimization.py:32-35`)."""
    warmup_steps = max(int(warmup * total_steps), 1)
    return _join(
        _linear(0.0, lr, warmup_steps),
        _linear(lr, 0.0, max(total_steps - warmup_steps, 1)),
        warmup_steps,
    )


def warmup_cosine(lr: float, warmup: float, total_steps: int) -> Schedule:
    warmup_steps = max(int(warmup * total_steps), 1)
    return _join(
        _linear(0.0, lr, warmup_steps),
        _cosine(lr, max(total_steps - warmup_steps, 1)),
        warmup_steps,
    )


SCHEDULES = {
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
}


class BertAdam(torch.optim.Optimizer):
    """Adam + decoupled weight decay + warmup + per-call grad clipping, as
    the JAX package's ``bert_adam`` chain computes it: clip the gradients
    of every parameter to a global norm of ``max_grad_norm`` (optax's
    ``clip_by_global_norm``: g * max / norm when norm >= max), Adam moments
    WITH bias correction (``optax.scale_by_adam``; the reference's BertAdam
    omits it, and the JAX package keeps optax's standard moments), add
    ``weight_decay * param``, then scale by ``-schedule(step)`` with step
    counting from 0. All parameter groups share one step count, one clip
    norm and the hyper-parameters given here."""

    def __init__(self, params: Iterable, lr: float = 5e-5, warmup: float = -1,
                 total_steps: int = -1, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        super().__init__(params, dict(lr=lr))
        if warmup >= 0 and total_steps > 0:
            self.schedule = SCHEDULES[schedule](lr, warmup, total_steps)
        else:
            self.schedule = lambda step: lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        if not params:
            return loss
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_grad_norm,
                                torch.ones_like(norm), self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - self.b2)
        update = torch._foreach_div(mus, bias_correction(self.b1, t))
        denom = torch._foreach_sqrt(
            torch._foreach_div(nus, bias_correction(self.b2, t)))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        return loss


def bert_adam(params: Iterable, lr: float = 5e-5, warmup: float = -1,
              total_steps: int = -1, schedule: str = "warmup_linear",
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
              weight_decay: float = 0.01, max_grad_norm: float = 1.0
              ) -> BertAdam:
    """:class:`BertAdam` over ``params``: the JAX package's ``bert_adam``
    (`optimization.py:44-161`)."""
    return BertAdam(params, lr=lr, warmup=warmup, total_steps=total_steps,
                    schedule=schedule, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay, max_grad_norm=max_grad_norm)
