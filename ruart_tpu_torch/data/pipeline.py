"""Host data pipeline: dataset -> sampler -> collate -> prefetch -> device.

Port of ``ruart_tpu/data/pipeline.py``:

* :func:`batch_iterator` — collated numpy batches, one per sampler index
  batch; ``num_workers > 0`` (the ``num_worker`` conf key) builds the
  items in a fork pool with one batch of lookahead (a thread pool where
  fork is missing).
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

import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from ruart_tpu_torch.data.collate import Collator, slim_block
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.models.fusion.spec import ModelSpec


# fork-inherited dataset for the `num_worker` process pool: set in the
# parent immediately before Pool() forks, so workers get the dataset by
# copy-on-write page sharing instead of a pickled copy each (the reference's
# torch DataLoader workers do the same, `SDNetTrainer.py:100-106`). Workers
# run only python/numpy item building: a forked child must never call a
# torch op (torch's intra-op thread pool and CUDA do not survive a fork).
_FORK_DATASET: Optional[VQADataset] = None


def _fork_build_items(idx_chunk):
    ds = _FORK_DATASET
    return [ds[i] for i in idx_chunk]


def _chunk(seq, n: int):
    """Split ``seq`` into <= n contiguous chunks of near-equal size."""
    seq = list(seq)
    n = max(1, min(n, len(seq)))
    step = -(-len(seq) // n)
    return [seq[i: i + step] for i in range(0, len(seq), step)]


def batch_iterator(
    dataset: VQADataset,
    sampler: VQASampler,
    collator: Collator,
    num_workers: int = 0,
):
    """Yield collated numpy batches for each sampler index batch.

    ``num_workers > 0`` builds items in a fork-based PROCESS pool with
    one-batch lookahead — batch k+1's items build in the workers while the
    parent collates batch k and the device runs. Item building is pure
    python/numpy over preprocessed data, so worker-built items are exactly
    the serial ones. Falls back to an in-process thread pool when fork is
    unavailable."""
    if not num_workers or num_workers <= 0:
        for idx_batch in sampler:
            yield collator([dataset[i] for i in idx_batch])
        return

    if "fork" not in multiprocessing.get_all_start_methods():
        pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            for idx_batch in sampler:
                items = list(pool.map(dataset.__getitem__, idx_batch))
                yield collator(items)
        finally:
            pool.shutdown(wait=False)
        return

    global _FORK_DATASET
    ctx = multiprocessing.get_context("fork")
    # bound for the pool's whole life, not just the first fork: the pool
    # forks a replacement whenever a worker dies
    prev, _FORK_DATASET = _FORK_DATASET, dataset
    pool = ctx.Pool(processes=num_workers)
    try:
        it = iter(sampler)
        nxt = next(it, None)
        pending = (
            pool.map_async(_fork_build_items, _chunk(nxt, num_workers))
            if nxt is not None else None
        )
        while pending is not None:
            chunks = pending.get()
            nxt = next(it, None)
            pending = (
                pool.map_async(_fork_build_items, _chunk(nxt, num_workers))
                if nxt is not None else None
            )
            yield collator([item for part in chunks for item in part])
    finally:
        pool.terminate()
        pool.join()
        _FORK_DATASET = prev


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
    bounds = {
        "glove": spec.vocab_size, "fasttext": spec.vocab_size,
        "phoc": spec.vocab_size, "pos": spec.pos_vocab, "ent": spec.ent_vocab,
    }
    bert = spec.bert
    if bert is not None:
        bounds.update({
            "bert": bert.vocab_size, "bert_unique": bert.vocab_size,
            "bert_packed": bert.vocab_size,
            "bert_packed_pos": bert.max_position_embeddings,
        })
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


def fetch_async(*tensors: torch.Tensor) -> Callable[[], tuple]:
    """Start copying ``tensors`` to the host right behind the work that
    makes them; returns a function that waits for those copies alone and
    gives the host tensors. A one-batch-behind drain needs this on a card:
    a blocking ``.cpu()`` of batch N, issued after batch N+1 is enqueued,
    queues on the same stream behind N+1's forward and waits for it too.
    CUDA tensors go to pinned memory on the current stream, then an event;
    CPU tensors come back as they are."""
    if tensors[0].device.type != "cuda":
        return lambda: tensors
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host

    return wait


def device_put_batch(batch, device: torch.device):
    """A :func:`host_batch` result -> (q, ocr, od, gt, extra) on ``device``."""
    q, ocr, od, gt, extra = batch
    blocks = [put_block(b, device) for b in (q, ocr, od)]
    if gt is not None:
        gt = gt.to(device, non_blocking=True)
    return (*blocks, gt, extra)
