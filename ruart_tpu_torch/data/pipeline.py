"""Host data pipeline: dataset -> sampler -> collate -> prefetch -> device.

Port of ``ruart_tpu/data/pipeline.py``:

* :func:`batch_iterator` — collated numpy batches, one per sampler index
  batch, built serially. The JAX package's ``num_worker`` fork pool is not
  ported: ``num_workers > 0`` raises NotImplementedError.
* :func:`prefetch` — a producer thread fills a bounded queue; an error in
  the producer is raised again in the consumer.
* :func:`host_batch` / :func:`device_put_batch` — the port's put, in two
  halves. ``host_batch`` runs on the producer thread: it slims each block
  (``collate.slim_block``), checks every index on the host
  (:func:`check_indices`: an out-of-range gather on the card is a
  device-side assert that ends the process) and turns each array into a
  CPU tensor, pinned when the batch is bound for a card; an array aliased
  under several keys becomes one tensor. ``device_put_batch`` runs on the
  consumer thread and copies with ``non_blocking=True`` on the consumer's
  current stream, so the compute that follows is ordered after the copy
  without any event; each aliased tensor moves once. PyTorch's pinned-host
  allocator keeps a pinned buffer alive until its copy has finished.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from ruart_tpu_torch.data.collate import Collator, slim_block
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.models.fusion.spec import ModelSpec


def batch_iterator(
    dataset: VQADataset,
    sampler: VQASampler,
    collator: Collator,
    num_workers: int = 0,
):
    """Yield collated numpy batches for each sampler index batch."""
    if num_workers and num_workers > 0:
        raise NotImplementedError(
            f"num_worker {num_workers}: the item-building worker pool is not "
            "ported; use num_worker 0"
        )
    for idx_batch in sampler:
        yield collator([dataset[i] for i in idx_batch])


def prefetch(
    iterator: Iterable,
    size: int = 2,
    host_put: Optional[Callable[[Any], Any]] = None,
) -> Iterator:
    """Background-thread prefetch with a bounded queue; ``host_put`` (e.g.
    :func:`host_batch`) runs on the producer thread for each element."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                if host_put is not None:
                    item = host_put(item)
                q.put(item)
        except BaseException as e:  # surfaced in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def check_indices(block: Mapping[str, np.ndarray], spec: ModelSpec) -> None:
    """Raise ValueError when an id or gather index of a collated host
    block falls outside the table it indexes. On the card an out-of-range
    gather is a device-side assert that ends the process, so every index
    source is checked here, on the host, before the transfer."""
    bert = spec.bert
    bounds = {
        "glove": spec.vocab_size, "fasttext": spec.vocab_size,
        "phoc": spec.vocab_size, "pos": spec.pos_vocab, "ent": spec.ent_vocab,
        "bert": bert.vocab_size, "bert_unique": bert.vocab_size,
        "bert_packed": bert.vocab_size,
        "bert_packed_pos": bert.max_position_embeddings,
    }
    table = next((block[k] for k in ("bert_unique_offsets", "bert_unpack",
                                     "bert_unique") if k in block), None)
    if table is not None:
        bounds["bert_inverse"] = table.shape[0]
    if "bert_packed" in block:
        bounds["bert_unpack"] = block["bert_packed"].size
    grid = next((block[k] for k in ("fasttext", "glove") if k in block), None)
    if grid is not None and grid.ndim == 3:
        bounds["cand_sel"] = grid.shape[0] * grid.shape[1] + 1  # + sentinel
        bounds["len"] = grid.shape[2] + 1
    for key, v in block.items():
        if v.dtype.kind not in "iu" or v.size == 0:
            continue
        hi = bounds.get(key)
        if v.min() < 0 or (hi is not None and v.max() >= hi):
            raise ValueError(
                f"batch key {key!r}: values in [{v.min()}, {v.max()}] fall "
                f"outside [0, {hi})"
            )


def host_block(block: Mapping[str, np.ndarray], spec: ModelSpec,
               slim: bool = True, pin: bool = False) -> Dict[str, torch.Tensor]:
    """Slim, check and wrap one collated block as CPU tensors (pinned when
    ``pin``); an array under several keys becomes one tensor."""
    if slim:
        block = slim_block(block)
    check_indices(block, spec)
    made: Dict[int, torch.Tensor] = {}
    out = {}
    for k, v in block.items():
        t = made.get(id(v))
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            made[id(v)] = t
        out[k] = t
    return out


def host_batch(batch, spec: ModelSpec, slim: bool = True, pin: bool = False):
    """(q, ocr, od, gt, extra) numpy batch -> the same with CPU tensors;
    ``extra`` (python metadata) stays as it is."""
    q, ocr, od, gt, extra = batch
    blocks = [host_block(b, spec, slim, pin) for b in (q, ocr, od)]
    if gt is not None:
        gt = torch.from_numpy(np.ascontiguousarray(gt))
        if pin:
            gt = gt.pin_memory()
    return (*blocks, gt, extra)


def put_block(block: Mapping[str, torch.Tensor],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Copy one block of CPU tensors to ``device`` (non-blocking from pinned
    memory); a tensor under several keys moves once."""
    moved: Dict[int, torch.Tensor] = {}
    out = {}
    for k, t in block.items():
        d = moved.get(id(t))
        if d is None:
            d = t.to(device, non_blocking=True)
            moved[id(t)] = d
        out[k] = d
    return out


def device_put_batch(batch, device: torch.device):
    """A :func:`host_batch` result -> (q, ocr, od, gt, extra) on ``device``."""
    q, ocr, od, gt, extra = batch
    blocks = [put_block(b, device) for b in (q, ocr, od)]
    if gt is not None:
        gt = gt.to(device, non_blocking=True)
    return (*blocks, gt, extra)
