"""The port's serving stack against the JAX package's ``ruart_tpu/serve.py``
(device="cpu", TINY_OVERRIDES, batch 2, weights from flax init through
``convert.from_jax_params``):

* the pipelined ``predict`` (prefetch thread, one-batch-behind drain)
  equals the port's serial path exactly and the JAX ``predict`` within
  1e-5 on the scores, with equal answers and idx, padded tail included;
* ``prepare`` -> ``dispatch`` -> ``decode_pending`` equals ``predict``;
* ``BatchingServer`` answers equal a direct ``predict``, its ``stats()``
  keys equal the JAX server's and p99 >= p50 > 0; an error planted in
  ``prepare`` reaches the request's future; ``submit`` after ``close``
  raises;
* the ``num_worker`` fork pools (the engine's and ``batch_iterator``'s)
  give collated arrays byte-equal to the serial ones and equal answers.
  They fork, so they run in a fresh child Python that imports only torch
  and the port — never by forking a test worker that holds JAX's threads;
  where fork is missing, ``batch_iterator`` uses a thread pool;
* ``tune_gc`` and ``NO_GC_TUNE`` behave as the JAX package's.
"""

import gc
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ruart_tpu.serve import BatchingServer as JaxBatchingServer
from ruart_tpu_torch import serve
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data import pipeline
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.utils.gctune import tune_gc
from test_torch_port_slice import (  # noqa: F401
    VOCAB_SIZE,
    _jax_engine,
    _opt,
    _port_engine,
    _requests,
    _synthetic,
    _vocab,
    flax_params,
)

torch.set_num_threads(2)
TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def engines(flax_params):
    """One JAX engine (its eval program compiles once for the file) and
    one port engine on the same weights."""
    opt = _opt({})
    return (_jax_engine(opt, {}, flax_params),
            _port_engine(opt, {}, from_jax_params(flax_params)))


def _serial_predict(engine, samples):
    """The port's serial path: each batch collated, moved, run, fetched and
    decoded before the next one starts."""
    out = []
    for _, n_real, (q, ocr, od, _gt, extra) in engine._collated_batches(samples):
        scores = engine._forward([engine.to_device(b) for b in (q, ocr, od)])
        out += engine._decode(scores, ocr["num"], extra, n_real)
    return out


def _assert_same_answers(got, want, tol=TOL):
    assert len(got) == len(want)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["idx"] for r in got] == [r["idx"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["synthetic", "requests"])
def test_pipelined_predict_matches_serial_and_jax(kind, engines):
    jax_engine, engine = engines
    reqs = _synthetic(5) if kind == "synthetic" else _requests(3)
    got = engine.predict(reqs)  # odd count: the tail batch is padded
    assert got == _serial_predict(engine, reqs)
    _assert_same_answers(got, jax_engine.predict(reqs))


def test_staged_api_matches_predict(engines):
    _, engine = engines
    reqs = _synthetic(5)
    want = engine.predict(reqs)
    got = []
    for start in range(0, len(reqs), engine.batch_size):
        prepared = engine.prepare(reqs[start: start + engine.batch_size])
        got += engine.decode_pending(engine.dispatch(prepared))
    assert got == want


def test_batching_server_matches_predict(engines):
    jax_engine, engine = engines
    reqs = _synthetic(5)
    direct = engine.predict(reqs)
    # the layer norm spans the batch, so a request's score depends on its
    # wave: a wait far longer than the burst takes to submit makes the waves
    # those of predict (full ones close at once, the tail after the wait)
    wait_ms = 1000.0
    with serve.BatchingServer(engine, max_wait_ms=wait_ms) as server:
        futs = [server.submit(r) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
        lone = server.predict_one(reqs[0], timeout=60)
        stats = server.stats()
    # a wave of fewer than batch_size requests is padded like predict's tail
    assert got == direct and lone == engine.predict(reqs[:1])[0]
    with JaxBatchingServer(jax_engine, max_wait_ms=wait_ms) as jax_server:
        jax_got = [f.result(timeout=120) for f in
                   [jax_server.submit(r) for r in reqs[:2]]]
        jax_stats = jax_server.stats()
    _assert_same_answers(got[:2], jax_got)
    assert sorted(stats) == sorted(jax_stats)
    assert stats["requests"] == len(reqs) + 1
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"] > 0
    assert 0 < stats["mean_batch_fill"] <= 1
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(reqs[0])


def test_batching_server_delivers_errors(engines, monkeypatch):
    _, engine = engines

    def boom(samples):
        raise ValueError("planted failure")

    monkeypatch.setattr(engine, "prepare", boom)
    with serve.BatchingServer(engine, max_wait_ms=5.0) as server:
        fut = server.submit(_requests(1)[0])
        with pytest.raises(ValueError, match="planted failure"):
            fut.result(timeout=60)
        monkeypatch.undo()  # the server keeps serving after a failed wave
        assert server.predict_one(_requests(1)[0], timeout=60)["answer"]


def test_engine_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(_opt({}))
    spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE))
    sd = RUArtModel(spec).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.InferenceEngine(cfg, spec, sd, _vocab(spec.vocab_size),
                              WordPieceTokenizer(build_demo_vocab()))


CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from ruart_tpu_torch import serve
    from ruart_tpu_torch.core.presets import tiny_config
    from ruart_tpu_torch.data.pipeline import batch_iterator
    from ruart_tpu_torch.data.sampler import VQASampler
    from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
    from ruart_tpu_torch.models.bert.config import BertConfig
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab

    def engine(**extra):
        cfg = tiny_config(batch_size=2, preprocess_ocr_name="ocr_PMTD_ASTER,ES_ocr",
                          preprocess_od_name="OD_bottom-up", **extra)
        spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=len(build_demo_vocab())))
        sd = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0)).state_dict()
        vocab = ["<PAD>", "<UNK>", "<Q>", "<OCR>", "<OD>", "stop", "exit", "sign"]
        vocab += [f"w{i}" for i in range(len(vocab), spec.vocab_size)]
        return serve.InferenceEngine(cfg, spec, sd, vocab,
                                     WordPieceTokenizer(build_demo_vocab()), device="cpu")

    def equal_blocks(a, b):
        for x, y in zip(a[:3], b[:3]):
            assert list(x) == list(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k
        assert a[4] == b[4]  # extra

    raw = make_synthetic_raw_dataset(5, seed=3, n_ocr_range=(3, 9), n_es=6,
                                     with_answers=False)["data"]
    reqs = [{"question": d["question"], "image_width": d["image_width"],
             "image_height": d["image_height"], "ocr": d["ocr_PMTD_ASTER"],
             "od": d["OD_bottom-up"], "es": d["ES_ocr"]} for d in raw]
    serial = engine()
    with engine(num_worker=2) as pooled:
        assert pooled._pool is not None and serve._FORK_ENGINE is pooled
        got_s = list(serial._collated_batches(reqs))
        got_p = list(pooled._collated_batches(reqs))
        assert [(s, n) for s, n, _ in got_p] == [(s, n) for s, n, _ in got_s]
        for (_, _, a), (_, _, b) in zip(got_s, got_p):
            equal_blocks(a, b)
        assert pooled.predict(reqs) == serial.predict(reqs)
    assert pooled._pool is None and serve._FORK_ENGINE is None
    # batch_iterator's pool over a featurized dataset, one batch of lookahead
    ds = serial.featurize(reqs)
    sampler = VQASampler(len(ds), 2, train=False)
    want = list(batch_iterator(ds, sampler, serial.collator, num_workers=0))
    got = list(batch_iterator(ds, sampler, serial.collator, num_workers=2))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        equal_blocks(a, b)
    print(json.dumps({"ok": True, "batches": len(got_p)}))
""")


def test_worker_pools_in_a_child_process():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "ok": True, "batches": 3}


def test_batch_iterator_uses_threads_without_fork(engines, monkeypatch):
    _, engine = engines
    ds = engine.featurize(_synthetic(5))
    sampler = VQASampler(len(ds), 2, train=False)
    collator = Collator(engine.cfg)
    want = list(pipeline.batch_iterator(ds, sampler, collator))
    monkeypatch.setattr(pipeline.multiprocessing, "get_all_start_methods",
                        lambda: ["spawn"])
    got = list(pipeline.batch_iterator(ds, sampler, collator, num_workers=2))
    for a, b in zip(want, got):
        for x, y in zip(a[:3], b[:3]):
            assert all(x[k].tobytes() == y[k].tobytes() for k in x)
    # the engine stays serial without fork
    monkeypatch.setattr(serve.multiprocessing, "get_all_start_methods",
                        lambda: ["spawn"])
    pooled = _port_engine(_opt({"num_worker": 2}), {})
    assert pooled._pool is None and pooled.num_workers == 0


def test_gc_tuning_opt_out_and_apply():
    saved = gc.get_threshold()
    try:
        assert tune_gc({"NO_GC_TUNE": True}) is False
        assert gc.get_threshold() == saved
        assert tune_gc({}) is True
        assert gc.get_threshold()[0] >= 100_000
        gc.set_threshold(*saved)
        _port_engine(_opt({"NO_GC_TUNE": True}), {})
        assert gc.get_threshold() == saved
        _port_engine(_opt({}), {})
        assert gc.get_threshold()[0] >= 100_000
    finally:
        gc.set_threshold(*saved)
