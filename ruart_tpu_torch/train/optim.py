"""Optimizer and parameter-freezing policy — port of
``ruart_tpu/train/optim.py``.

The JAX package builds its optimizer from optax; this module computes the
same updates in PyTorch, written out as optax computes them
(`SDNetTrainer.setup_model:305-317` semantics):

* optimizer '#' (shipped) -> optax ``adamax`` (lr from conf, default 2e-3):
  ``mu = (1 - b1) g + b1 mu``, ``nu = max(|g| + eps, b2 nu)``,
  ``update = -lr (mu / (1 - b1^t)) / nu``, the rule of the installed
  optax. (``torch.optim.Adamax`` folds the learning rate into the bias
  correction before the division; the port does not use it.)
* 'ADAM' -> ``add_decayed_weights(0.5)`` then adamax(1e-3); 'ADAM2' ->
  optax ``adam``; 'SGD' -> optax ``sgd``.
* ``clip_by_global_norm(grad_clip)`` over the TRAINABLE parameters only
  (the clip sits inside the trainable branch of ``multi_transform``): the
  gradient is replaced by ``g / norm * max_norm`` when ``norm >=
  max_norm`` and kept otherwise (no ``+ 1e-6``, unlike
  ``clip_grad_norm_``).
* frozen roots get no state and no update: the BERT encoder under
  LOCK_BERT (`SDNet.py:91-94`), and the glove/fast/phoc embeddings unless
  TUNE_PARTIAL (`SDNet.py:76-86`).
* TUNE_PARTIAL row pinning (:func:`make_row_pinner`): rows >= tune_partial
  and row 1 are restored after every update (`SDNetTrainer.py:369-373`);
  their gradients still count in the global norm and their moments still
  update, as in the JAX package.

A gradient that autograd left as ``None`` (a parameter the loss does not
reach) counts as zeros, as JAX's dense gradients do.

On a (dp, tp) mesh (``mesh``) every rank backpropagates its share of the
global loss (``train_step``), and :meth:`Optimizer.step` first sums each
gradient over the copies of its parameter — over dp for a tp shard
(``param.tp_dim``), over the whole mesh for a replicated parameter — so
every rank holds the gradient of the global-batch loss for what it holds.
The clip's global norm is that of the FULL gradient: the squares of the
shards are summed over tp, those of replicated parameters counted once.
The row pinner maps the global rows it pins onto a vocab-sharded table.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.parallel.layers import tp_dim

OPTIMIZERS = ("#", "ADAM", "ADAM2", "SGD")
B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_correction(decay: float, t: int) -> float:
    """optax's ``1 - decay ** t``, computed in float32 as optax computes it:
    at b2 0.999 and t 1 it is 0.0009999871, not 0.001 (float32(0.999) is
    above 0.999), which moves Adam's first steps by 1.3e-5 relative."""
    return float(np.float32(1) - np.float32(decay) ** t)


def frozen_roots(spec: ModelSpec, tune_partial: bool) -> frozenset:
    """Top-level module names whose parameters never update."""
    roots = set()
    if spec.lock_bert:
        roots.add("Bert")
    if not tune_partial:
        roots.update({"glove_embed", "fast_embed", "phoc_embed"})
    return frozenset(roots)


class Optimizer:
    """The JAX package's optax chain for one model, updating its
    parameters in place. A step is :meth:`advance` on the host (the step
    count, and the bias corrections of that count written into two 0-d
    device tensors) then :meth:`update` on the device (it reads
    ``param.grad``, the moments and those tensors, and nothing of the
    host): a train step's CUDA graph captures :meth:`update` and replays it
    after each :meth:`advance`. :meth:`step` is the two in one. No step
    needs a host synchronisation. Every tensor of the state keeps its
    storage for the optimizer's life (:meth:`load_state_dict` copies into
    it), so a captured update reads and writes the live state."""

    def __init__(
        self,
        opt_name: str,
        lr: Optional[float],
        grad_clip: float,
        model: nn.Module,
        spec: ModelSpec,
        tune_partial: bool,
        mesh=None,
    ):
        if opt_name not in OPTIMIZERS:
            raise ValueError(f"optimizer is wrong: {opt_name!r}")
        if opt_name == "SGD" and lr is None:
            raise ValueError("optimizer SGD needs lr")
        self.name = opt_name
        default_lr = {"#": 2e-3, "ADAM2": 1e-3}.get(opt_name)
        # 'ADAM' is adamax at a fixed 1e-3 whatever the conf says
        self.lr = 1e-3 if opt_name == "ADAM" else (lr if lr is not None else default_lr)
        self.grad_clip = float(grad_clip)
        self.mesh = mesh
        frozen = frozen_roots(spec, tune_partial)
        # a frozen parameter (requires_grad False: the Moonlight encoder's
        # weights) never enters the optimizer, whatever the conf
        self.params: Dict[str, nn.Parameter] = {
            name: p for name, p in model.named_parameters()
            if name.split(".")[0] not in frozen and p.requires_grad
        }
        self.count = 0
        device = next(iter(self.params.values())).device if self.params else None
        # 1 - b1^t and 1 - b2^t of the step in flight (advance writes them)
        self.bias_corrections = tuple(torch.ones((), device=device)
                                      for _ in range(2))
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        if opt_name != "SGD":
            self.state = {
                name: {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
                for name, p in self.params.items()
            }

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def _sharded(self) -> List[bool]:
        return [tp_dim(p) is not None for p in self.params.values()]

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum every gradient over the copies of its parameter on the mesh:
        tp shards over the dp group, replicated parameters over the mesh
        (one flat all-reduce per group)."""
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return grads
        out = list(grads)
        for shard, group in ((True, mesh.dp_group), (False, mesh.group)):
            idx = [i for i, s in enumerate(self._sharded()) if s == shard]
            if group is None or not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            torch.distributed.all_reduce(flat, group=group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def _clipped_grads(self) -> List[torch.Tensor]:
        grads = self._reduce_grads([
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in self.params.values()
        ])
        if not grads:
            return grads
        norms = torch.stack(torch._foreach_norm(grads))
        if self.mesh is not None and self.mesh.tp_group is not None:
            # the shards' squares summed over tp; replicated ones once
            sharded = torch.tensor(self._sharded(), device=norms.device)
            sq = norms.square()
            part = torch.where(sharded, sq, torch.zeros_like(sq)).sum()
            torch.distributed.all_reduce(part, group=self.mesh.tp_group)
            norm = (part + torch.where(sharded, torch.zeros_like(sq),
                                       sq).sum()).sqrt()
        else:
            norm = torch.linalg.vector_norm(norms)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        return torch._foreach_mul(grads, scale)

    def step(self):
        """One update of every trainable parameter: :meth:`advance` then
        :meth:`update`."""
        self.advance()
        self.update()

    @torch.no_grad()
    def advance(self):
        """The host's part of a step: count it and write its bias
        corrections (float32, as optax rounds them) into the device
        tensors that :meth:`update` divides by."""
        self.count += 1
        for value, decay in zip(self.bias_corrections, (B1, B2)):
            value.fill_(bias_correction(decay, self.count))

    @torch.no_grad()
    def update(self):
        """The device's part of a step, for the count :meth:`advance` set.
        The arithmetic runs as ``torch._foreach_*`` calls over all
        parameters at once (a few kernel launches per operation instead of
        one per parameter); the moments update in place. It divides by
        the bias corrections as tensors: a true division on every device,
        where CUDA would multiply by the reciprocal of a Python scalar."""
        params = list(self.params.values())
        if not params:
            return
        grads = self._clipped_grads()
        bc1, bc2 = self.bias_corrections
        if self.name == "SGD":
            torch._foreach_add_(params, grads, alpha=-self.lr)
            return
        if self.name == "ADAM":
            grads = torch._foreach_add(grads, params, alpha=0.5)
        mus = [self.state[n]["mu"] for n in self.params]
        nus = [self.state[n]["nu"] for n in self.params]
        torch._foreach_mul_(mus, B1)
        torch._foreach_add_(mus, grads, alpha=1 - B1)
        update = torch._foreach_div(mus, bc1)
        if self.name == "ADAM2":
            torch._foreach_mul_(nus, B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - B2)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, EPS)
        else:
            absg = torch._foreach_abs(grads)
            torch._foreach_add_(absg, EPS)
            torch._foreach_mul_(nus, B2)
            torch._foreach_maximum_(nus, absg)
            denom = nus
        torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-self.lr)

    # -- checkpoint state (the port's own keys; see train/checkpoint.py) ---
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"count": np.asarray(self.count, np.int64)}
        for name, st in self.state.items():
            for slot, value in st.items():
                out[f"{slot}/{name}"] = value.detach().cpu().numpy()
        return out

    def load_state_dict(self, arrays: Dict[str, np.ndarray]):
        """Copies ``arrays`` into the moments in place (a captured update
        goes on reading the same tensors). Raises ValueError when
        ``arrays`` was written for another set of parameters, shapes or
        optimizer."""
        want = set(self.state_dict())
        if set(arrays) != want:
            missing = sorted(want - set(arrays))[:3]
            extra = sorted(set(arrays) - want)[:3]
            raise ValueError(f"optimizer state keys differ (missing {missing}, "
                             f"unexpected {extra})")
        for name, st in self.state.items():
            for slot in st:
                shape = np.shape(arrays[f"{slot}/{name}"])
                if shape != tuple(st[slot].shape):
                    raise ValueError(f"optimizer state {slot}/{name}: shape "
                                     f"{shape} vs {tuple(st[slot].shape)}")
        for name, st in self.state.items():
            for slot, value in st.items():
                value.copy_(torch.as_tensor(np.asarray(arrays[f"{slot}/{name}"])))
        self.count = int(arrays["count"])


def make_row_pinner(
    model: nn.Module, spec: ModelSpec, tune_partial_rows: Optional[int]
) -> Callable[[], None]:
    """Returns f() that restores the fixed embedding rows of ``model`` in
    place after an update: rows >= ``tune_partial_rows`` and row 1 (<UNK>,
    the reference's Embedding padding_idx), captured from the parameters as
    they are now (the reference keeps them as buffers, `SDNet.py:78-81`).
    A vocab-sharded table (``vocab_start``) holds global rows
    [vocab_start, vocab_start + its rows): the pinned rows map onto it."""
    if tune_partial_rows is None:
        return lambda: None
    tp = int(tune_partial_rows)
    fixed = {}
    with torch.no_grad():
        for name in ("glove_embed", "fast_embed"):
            if hasattr(model, name):
                emb = getattr(model, name)
                weight = emb.weight
                start = getattr(emb, "vocab_start", 0)
                tail = min(max(tp - start, 0), weight.shape[0])
                row1 = 1 - start if 0 <= 1 - start < weight.shape[0] else None
                fixed[name] = (weight, tail, weight[tail:].clone(), row1,
                               None if row1 is None else weight[row1].clone())

    @torch.no_grad()
    def pin():
        for weight, tail, tail_rows, row1, row1_value in fixed.values():
            weight[tail:] = tail_rows
            if row1 is not None:
                weight[row1] = row1_value

    return pin
