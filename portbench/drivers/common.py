"""What the drivers share: the program's conf, host spans and counters
recorded from the benchmark's side of each call, and the K1 call shapes
per batch signature."""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Any, Dict, List

from portbench import build, counts


def data_keys(run) -> Dict[str, Any]:
    """Conf keys of the run's batch and data folders. The data is made and
    featurized in memory: nothing is written there (they name a folder
    under ``TMPDIR`` that is never made)."""
    root = os.path.join(tempfile.gettempdir(), "portbench-data")
    return {"batch_size": run.traffic["batch_size"], "datadir": root,
            "FEATURE_FOLDER": os.path.join(root, "features")}


def program_conf(run, extra: Dict[str, Any]):
    from ruart_tpu_torch.core.config import Config, read_conf_lines

    return Config(read_conf_lines(build.conf_lines(run.config, extra)))


def bert_config(run, tokenizer):
    import dataclasses

    from ruart_tpu_torch.models.bert.config import BertConfig

    c = BertConfig(**run.config["bert"])
    if c.vocab_size < len(tokenizer.vocab):
        c = dataclasses.replace(c, vocab_size=len(tokenizer.vocab))
    return c


def featurize(pre, raw):
    """The program's featurization of ``raw``, with the vocabulary built
    from it (``BuildTestVocabulary``)."""
    data = pre._process_data(list(raw))
    pre.train_vocab = pre._build_vocab(data)
    pre.train_char_vocab = pre._build_char_vocab(pre.train_vocab)
    pre._assign_ids(data)
    pre.cfg.opt["vocab_size"] = len(pre.train_vocab)
    return data


class Phases:
    """Seconds of each part of set-up, for the run's notes."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 3)
        self.t = now


class HostWatch:
    """The host inside a block, for the run's notes: the interpreter's
    generation-2 collections and their seconds, and the process's CPU
    seconds."""

    def __init__(self):
        self.count, self.seconds, self._t0 = 0, 0.0, None

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        self._cpu = time.process_time()
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        self._cpu = time.process_time() - self._cpu
        return False

    def notes(self) -> Dict[str, Any]:
        return {"gc2_in_window": self.count,
                "gc2_seconds": round(self.seconds, 3),
                "process_cpu_s": round(self._cpu, 3)}


class Spans:
    """Host durations by name, recorded while ``on``."""

    def __init__(self):
        self.on = False
        self.seconds: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float):
        if self.on:
            self.seconds.setdefault(name, []).append(seconds)


class TimedCollator:
    """The collator, with each call's host time recorded as ``collate``."""

    def __init__(self, collator, spans: Spans):
        self.collator = collator
        self.spans = spans

    def __getattr__(self, name):
        return getattr(self.collator, name)

    def __call__(self, batch):
        t0 = time.perf_counter()
        from portbench.trace import span

        with span("collate"):
            out = self.collator(batch)
        self.spans.add("collate", time.perf_counter() - t0)
        return out


class RecordingSampler:
    """The sampler, with every index batch it gives recorded in order."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.batches: List[List[int]] = []

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        for idx in self.sampler:
            self.batches.append(list(idx))
            yield idx


class K1Calls:
    """The shapes of K1's calls, per batch signature: recorded from a
    wrapper around ``ops.attention.attention_rows`` (the dispatcher that
    launches K1 on CUDA tensors) during the first call of each signature
    (its eager run, then its capture, which calls the same Python code
    again: the first half is the step's)."""

    def __init__(self):
        import ruart_tpu_torch.ops.attention as att

        self.att = att
        self.calls: List[tuple] = []
        self.by_signature: Dict[Any, List[tuple]] = {}
        self._orig = att.attention_rows

        def recorded(q, k, v, bias, heads):
            if q.device.type == "cuda":
                self.calls.append((q.shape[0], q.shape[1], q.shape[2],
                                   q.element_size(), bias.dim()))
            return self._orig(q, k, v, bias, heads)

        att.attention_rows = recorded

    def close(self):
        self.att.attention_rows = self._orig

    def first_call(self, key, fn):
        """Run ``fn`` (a step of signature ``key``), recording its K1
        calls if the signature is new."""
        if key in self.by_signature:
            return fn()
        self.calls = []
        out = fn()
        self.by_signature[key] = self.calls[:len(self.calls) // 2] if (
            len(self.calls) % 2 == 0) else list(self.calls)
        return out

    def totals(self, keys) -> Dict[str, float]:
        flops = nbytes = 0.0
        elt = 4
        for key in keys:
            for rows, length, width, elt, bias_dim in self.by_signature.get(key, []):
                f, b = counts.k1_call(rows, length, width, elt, bias_dim)
                flops, nbytes = flops + f, nbytes + b
        return {"flops": flops, "bytes": nbytes,
                "dtype": "bfloat16" if elt == 2 else "float32"}


def free_memory() -> None:
    """Give the device memory of the program's dropped state back (its
    graphs released by their owners first)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(seed: int, population: int, k: int, stream: int) -> List[int]:
    from portbench.corpus import rng_for

    rng = rng_for(seed, stream)
    return sorted(rng.choice(population, size=min(k, population),
                             replace=False).tolist())
