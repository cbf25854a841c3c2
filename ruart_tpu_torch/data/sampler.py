"""Infinite-permutation batch sampler (`Utils/VQA_Sampler.py`). Exact copy of
``ruart_tpu/data/sampler.py``: both packages see the same batches.

Training: reshuffles with seed 1333+epoch each pass, yields fixed-size
index batches until ``max_batch_number`` (= data*epochs/batch for train);
``batch_st`` skips already-consumed batches for exact resume
(`VQA_Sampler.py:21-24,52` + `SDNetTrainer.py:92`). Eval: sequential with a
final wrap-around batch so every batch is full (the trainer drops the
wrapped tail rows before writing submissions, `SDNetTrainer.py:148-153`).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class VQASampler:
    def __init__(
        self,
        data_count: int,
        batch_size: int,
        train: bool,
        max_batch_number: Optional[int] = None,
        batch_st: int = 0,
        epoch: Optional[float] = None,
        seed: int = 1333,
    ):
        self.data_count = data_count
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        if train:
            if epoch is not None:
                self.max_batch_number = int(data_count * epoch / batch_size)
            else:
                assert max_batch_number is not None
                self.max_batch_number = max_batch_number
        else:
            assert epoch is None
            self.max_batch_number = -(-data_count // batch_size)
        self.batch_st = batch_st or 0

    def __len__(self) -> int:
        return self.max_batch_number

    def __iter__(self) -> Iterator[List[int]]:
        batch_cnt = 0
        epoch_cnt = 0
        indices = list(range(self.data_count))
        pool: List[int] = []
        while batch_cnt < self.max_batch_number:
            while len(pool) < self.batch_size:
                if self.train:
                    rng = np.random.RandomState(epoch_cnt + self.seed)
                    pool += rng.permutation(indices).tolist()
                else:
                    pool += indices
                epoch_cnt += 1
            batch, pool = pool[: self.batch_size], pool[self.batch_size:]
            if batch_cnt >= self.batch_st:
                yield batch
            batch_cnt += 1
