"""Checkpoints — port of ``ruart_tpu/train/checkpoint.py``, in its format.

One ``.npz`` (no pickle) holding the flax variables dict under the JAX
package's keys (``params/params/<module>/.../<leaf>``, layouts as flax
keeps them, through ``convert.to_jax_params``) and a json sidecar
``__meta__``. So a
checkpoint of either package loads into the other:

* full save (:func:`save_checkpoint`): parameters + optimizer state + json
  meta (update count, loss meter, config, epoch);
* :func:`save_for_predict`: parameters only, without the ``Bert`` subtree
  (reloadable from the pretrained release, `save_for_predict:492-509`);
* :func:`load_checkpoint`: key-intersection patching — stored keys the
  model does not have, or of another shape, are dropped with a log line;
  the model's other parameters keep their values (`load_model:453-466`).

The optimizer state is the port's own (``optim.Optimizer.state_dict``),
stored under ``torch_opt/...`` keys: it resumes only in the port. The JAX
package's optimizer leaves (``opt/<index>``) mean nothing to the port, and
the JAX package ignores the port's keys. :func:`restore_optimizer` keeps
the JAX package's rule: a checkpoint without optimizer state
(``save_for_predict``) restarts the moments silently; one whose optimizer
state does not fit (another optimizer, other parameters, or the JAX
package's leaves) raises unless ``strict=False`` (the
``LENIENT_OPT_RESUME`` conf flag), which warns and restarts them.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
from torch import nn

from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.train.optim import Optimizer

log = logging.getLogger(__name__)

_SEP = "/"
PARAMS = "params"
JAX_OPT = "opt"
PORT_OPT = "torch_opt"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _write(path: str, arrays: Dict[str, np.ndarray], meta: Optional[dict]):
    arrays = dict(arrays)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        log.info("model saved to %s", path)
    except OSError:
        # reference behavior: saving failures are non-fatal
        # (`SDNetTrainer.py:484-490`)
        log.warning("[ WARN: Saving failed... continuing anyway. ]")


def save_checkpoint(path: str, model: nn.Module,
                    optimizer=None,
                    meta: Optional[Dict[str, Any]] = None):
    """Write the parameters (+ the optimizer state + json meta).
    ``optimizer``: an :class:`Optimizer`, or its ``state_dict()`` (a mesh
    save hands over the state gathered from the tp shards)."""
    arrays = {
        f"{PARAMS}{_SEP}{k}": v for k, v in flatten_tree(to_jax_params(model)).items()
    }
    if optimizer is not None:
        if isinstance(optimizer, Optimizer):
            optimizer = optimizer.state_dict()
        for k, v in optimizer.items():
            arrays[f"{PORT_OPT}{_SEP}{k}"] = v
    _write(path, arrays, meta)


def save_for_predict(path: str, model: nn.Module, meta=None):
    """Parameters without the BERT subtree, like `save_for_predict:492-509`."""
    inner = to_jax_params(model)["params"]
    tree = {"params": {k: v for k, v in inner.items() if k != "Bert"}}
    arrays = {f"{PARAMS}{_SEP}{k}": v for k, v in flatten_tree(tree).items()}
    _write(path, arrays, meta)


def load_checkpoint(
    path: str, model: nn.Module
) -> Tuple[Optional[Dict[str, np.ndarray]], bool, Dict[str, Any]]:
    """Key-intersection load into ``model`` (in place). Returns (the port's
    optimizer arrays or None, whether the file holds the JAX package's
    optimizer leaves, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
        stored = {
            k[len(PARAMS) + 1:]: z[k] for k in z.files
            if k.startswith(PARAMS + _SEP)
        }
        port_opt = {
            k[len(PORT_OPT) + 1:]: z[k] for k in z.files
            if k.startswith(PORT_OPT + _SEP)
        }
        jax_opt = any(k.startswith(JAX_OPT + _SEP) for k in z.files)

    current = flatten_tree(to_jax_params(model))
    merged = {}
    dropped = 0
    for k, v in stored.items():
        if k in current and current[k].shape == v.shape:
            merged[k] = v
        else:
            if k in current:
                log.warning("shape mismatch for %s: %s vs %s", k,
                            current[k].shape, v.shape)
            dropped += 1
    log.info("checkpoint %s: loaded %d tensors, dropped %d", path,
             len(merged), dropped)
    state = from_jax_params(unflatten_tree(merged))
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise RuntimeError(f"checkpoint keys map to no parameter: {unexpected}")
    return (port_opt or None), jax_opt, meta


def restore_optimizer(optimizer: Optimizer,
                      arrays: Optional[Dict[str, np.ndarray]],
                      jax_opt: bool, strict: bool = True):
    """Load the stored optimizer state into ``optimizer`` (see the module
    doc for the rule)."""
    def mismatch(why: str):
        if strict:
            raise ValueError(
                f"optimizer state in checkpoint does not match the current "
                f"optimizer ({why}); refusing to silently restart momentum. "
                f"Set LENIENT_OPT_RESUME to reinitialize instead."
            )
        log.warning("optimizer state mismatch (%s); reinitializing", why)

    if arrays is None:
        if jax_opt:
            mismatch("the checkpoint holds the JAX package's optimizer state")
        return
    try:
        optimizer.load_state_dict(arrays)
    except ValueError as e:
        mismatch(str(e))
