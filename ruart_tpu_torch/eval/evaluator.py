"""Batched evaluation loop + submission writer — port of
``ruart_tpu/eval/evaluator.py``.

Equivalent of `SDNetTrainer.evaluate:128-176`: full-dataset batched
inference (the sampler wraps the tail so every device batch is full: the
whole-tensor layer norm spans the batch), host decode, ANLS/ACC
aggregation, pad-tail trimming and ``submission.json`` writing for test
mode (`SDNetTrainer.py:148-161`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.pipeline import (
    batch_iterator,
    device_put_batch,
    fetch_async,
    host_batch,
    prefetch,
)
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.eval.decoder import decode_batch
from ruart_tpu_torch.models.fusion.spec import ModelSpec

log = logging.getLogger(__name__)


def evaluate(
    eval_step: Callable,
    dataset: VQADataset,
    cfg: Config,
    spec: ModelSpec,
    device: torch.device,
    collator: Optional[Collator] = None,
    batch_size: Optional[int] = None,
    fixed_answers: Optional[Sequence[str]] = None,
    num_workers: Optional[int] = None,
    device_put: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Returns {'loss', 'ANLS', 'ACC', 'res', 'save_res', 'n'} with metrics
    normalized by dataset size (`SDNetTrainer.py:145-147`). ``eval_step``
    is ``train_step.make_eval_step(model, loss_fn)``. ``device_put`` maps
    a host batch to the device batch the step takes (default: the whole
    batch on ``device``); mesh callers pass ``eval.sharded``'s, which
    keeps this rank's slice, and an eval step that gathers the [B, C]
    scores of the global batch."""
    collator = collator or Collator(cfg)
    batch_size = batch_size or cfg.batch_size
    if num_workers is None:
        num_workers = int(cfg.opt.get("num_worker", 0))
    sampler = VQASampler(len(dataset), batch_size, train=False)
    yesno = "label_yesno" in cfg.opt
    label_no_answer = "label_no_answer" in cfg.opt
    slim = bool(int(cfg.opt.get("h2d_slim", 1)))
    pin = device.type == "cuda"

    loss_sum = 0.0
    anls_sum = acc_sum = 0.0
    res: list = []
    save_res: list = []
    n_batches = 0

    def drain(pending):
        nonlocal anls_sum, acc_sum, loss_sum, n_batches
        fetch, num, extra = pending
        scores, loss = fetch()
        _res, _save, _anls, _acc = decode_batch(
            scores.numpy(), extra, num.numpy(),
            fixed_answers, yesno, label_no_answer,
        )
        res.extend(_res)
        save_res.extend(_save)
        anls_sum += _anls
        acc_sum += _acc
        loss_sum += float(loss)
        n_batches += 1

    # software pipeline: enqueue batch N+1 BEFORE fetching/decoding batch
    # N, so the device does not idle through the fetch + decode; the fetch
    # of N waits for N alone (fetch_async)
    it = batch_iterator(dataset, sampler, collator, num_workers=num_workers)
    pending = None
    for host in prefetch(it, size=2,
                         host_put=lambda b: host_batch(b, spec, slim, pin)):
        q, ocr, od, gt, extra = (device_put or (
            lambda b: device_put_batch(b, device)))(host)
        fetch = fetch_async(*eval_step(q, ocr, od, gt))
        if pending is not None:
            drain(pending)
        pending = (fetch, host[1]["num"], extra)
    if pending is not None:
        drain(pending)

    n = len(dataset)
    return {
        "loss": loss_sum / max(n_batches, 1),
        "ANLS": anls_sum / max(n, 1),
        "ACC": acc_sum / max(n, 1),
        "res": res,
        "save_res": save_res,
        "n": n,
    }


def trim_pad_tail(res: list, n: int, batch_size: int) -> list:
    """Drop wrap-around rows from the final batch (`SDNetTrainer.py:150-153`)."""
    end = n % batch_size
    if end != 0:
        res = res[: -(batch_size - end)]
    return res


def write_submission(res: list, save_folder: str, n: int, batch_size: int) -> str:
    res = trim_pad_tail(res, n, batch_size)
    path = os.path.join(save_folder, "submission.json")
    os.makedirs(save_folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    log.info("submission is saved in %s (%d predictions)", path, len(res))
    return path
