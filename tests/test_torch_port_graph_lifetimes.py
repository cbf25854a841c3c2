"""When the port's CUDA graphs are freed (``utils/graphs.py``, Lifetime), on
the CPU with a stand-in for ``torch.cuda``'s graph API that makes each
step a ``SignatureGraphs`` and counts each graph's replays and resets.

* With the cyclic collector off, a dropped train step, ``InferenceEngine``
  and ``Trainer`` (each after a call that captured a graph) are freed by
  reference counting alone: their weak references, and their graphs',
  are dead right after ``del``. A step that referred to itself (the
  train step's closure did) lived until a collection, which can start at
  any later allocation, also inside a profiler session.
* ``SignatureGraphs.release`` synchronizes, resets each graph and drops
  the graphs and the pool; a call after it captures anew and never
  replays a released graph.
* The owners release where they stop using their graphs: a train step
  called with another state, ``Trainer._apply_int8_eval`` replacing the
  eval step, ``InferenceEngine.close`` and ``quantize``.
* The owners the crash tool's ``--form release`` frees between two
  profiler sessions free their graphs at the API call, with the
  collector off, and a kept train step and engine then replay their
  graphs, none captured anew or reset.
"""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

import ruart_tpu_torch.train.train_step as train_step_mod
from ruart_tpu_torch.core.presets import tiny_config
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.serve import InferenceEngine
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer
from ruart_tpu_torch.utils.graphs import SignatureGraphs

torch.set_num_threads(2)
VOCAB = build_demo_vocab()
REQUESTS = [{"question": f"what does sign {i} say", "image_width": 640,
             "image_height": 480,
             "ocr": [{"word": "stop", "pos": [10, 10, 60, 10, 60, 30, 10, 30]}],
             "od": [{"object": "sign", "pos": [320, 240, 100, 60]}]}
            for i in range(3)]


class _Graph:
    """A graph that records its replays and resets; ``made`` keeps a weak
    reference to each one."""

    made = []

    def __init__(self):
        self.replays = self.resets = 0
        _Graph.made.append(weakref.ref(self))

    def register_generator_state(self, generator):
        pass

    def replay(self):
        assert not self.resets, "a released graph was replayed"
        self.replays += 1

    def reset(self):
        self.resets += 1


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def graph_api(monkeypatch):
    """Every step of the port a ``SignatureGraphs``, on the stand-in API;
    yields the synchronize calls."""
    syncs = []
    _Graph.made = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(
        torch.cuda, "graph",
        lambda graph, pool=None, stream=None, capture_error_mode=None:
        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    monkeypatch.setattr(train_step_mod, "eager_reason", lambda *args: None)
    yield syncs


@contextlib.contextmanager
def _collector_off():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _trainer():
    cfg = tiny_config(batch_size=2, datadir=".", FEATURE_FOLDER=".")
    trainer = Trainer(cfg, bert_config=BertConfig.tiny(vocab_size=len(VOCAB)),
                      device="cpu")
    trainer.setup_model({})
    batch = make_synthetic_batch(trainer.spec, cfg, 2, seed=3)
    q, ocr, od, gt = (
        {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        if isinstance(b, dict) else torch.from_numpy(np.asarray(b))
        for b in batch)
    return trainer, (q, ocr, od, gt)


def _engine(trainer):
    return InferenceEngine(trainer.cfg, trainer.spec,
                           trainer.model.state_dict(), list(VOCAB),
                           WordPieceTokenizer(VOCAB), device="cpu")


def _dropped_train_step():
    trainer, batch = _trainer()
    step, state = trainer.train_step, trainer.state
    del trainer
    step(state, *batch)
    return [step, state.model]


def _dropped_engine():
    trainer, _ = _trainer()
    engine = _engine(trainer)
    del trainer
    engine.predict(REQUESTS)
    return [engine, engine.model]


def _dropped_trainer():
    trainer, batch = _trainer()
    trainer.state, _ = trainer.train_step(trainer.state, *batch)
    trainer.eval_step(*batch)
    return [trainer, trainer.model]


@pytest.mark.parametrize("make", [_dropped_train_step, _dropped_engine,
                                  _dropped_trainer],
                         ids=["train_step", "engine", "trainer"])
def test_dropped_owners_free_by_reference_counting(graph_api, make):
    with _collector_off():
        owners = make()
        assert _Graph.made and all(g() is not None for g in _Graph.made)
        refs = [weakref.ref(o) for o in owners] + _Graph.made
        del owners
        alive = [r() is not None for r in refs]
    assert not any(alive), f"alive after del (owner, model, graphs): {alive}"


def test_released_graphs_are_never_replayed(graph_api):
    def fn(x):
        return x * 2

    step = SignatureGraphs(fn, torch.device("cpu"))
    x = torch.ones(3)
    step(x)            # the capture
    step(x)            # a replay
    (first,) = step.graphs.values()
    graph = first.graph
    step.release()
    assert graph_api == [torch.device("cpu")]
    assert graph.replays == 1 and graph.resets == 1
    assert len(step) == 0 and step.pool is None and step._stream is None
    assert torch.equal(step(x), fn(x))   # captured anew, run eagerly once
    (again,) = step.graphs.values()
    assert again.graph is not graph and step.pool is not None
    step(x)
    assert again.graph.replays == 1 and graph.replays == 1
    step.release()
    step.release()     # nothing left: no second synchronize
    assert len(graph_api) == 2


def test_owners_release_where_they_stop_using_graphs(graph_api):
    trainer, batch = _trainer()
    step = trainer.train_step
    step(trainer.state, *batch)
    (old,) = step.graphs.graphs.values()
    other = trainer.state.__class__(trainer.model, trainer.optimizer,
                                    trainer.state.generator)
    step(other, *batch)                    # another state
    assert old.graph.resets == 1 and len(step.graphs) == 1
    step.release()
    assert len(step.graphs) == 0

    trainer.eval_step(*batch)
    (old,) = trainer.eval_step.graphs.values()
    trainer._apply_int8_eval()             # the eval step replaced
    assert old.graph.resets == 1

    engine = _engine(trainer)
    engine.predict(REQUESTS)
    (old,) = engine.eval_step.graphs.values()
    engine.quantize()                      # the model and its step rebuilt
    assert old.graph.resets == 1 and engine.graph_count == 0
    engine.predict(REQUESTS)
    (old,) = engine.eval_step.graphs.values()
    with engine:
        pass                               # close()
    assert old.graph.resets == 1 and engine.graph_count == 0


def test_release_form_owners_free_at_their_call(graph_api):
    """The owners of ``tools/torch_train_graph_crash.py --form release``,
    with the collector off: each frees its graphs at the API call
    (``quantize()``, ``close()`` and the drop, a new state, ``del``), and
    the kept train step and engine then replay what they captured."""
    with _collector_off():
        trainer, batch = _trainer()
        kept = trainer.train_step
        kept(trainer.state, *batch)
        engine = _engine(trainer)
        engine.predict(REQUESTS)
        survivors = [e.graph for e in list(kept.graphs.graphs.values())
                     + list(engine.eval_step.graphs.values())]
        quantized, closed = _engine(trainer), _engine(trainer)
        quantized.predict(REQUESTS)
        closed.predict(REQUESTS)
        (new_state, new_batch), (dropped, dropped_batch) = (
            _trainer() for _ in range(2))
        new_state.train_step(new_state.state, *new_batch)
        dropped.train_step(dropped.state, *dropped_batch)

        def refs(graphs):
            return [weakref.ref(e.graph) for e in graphs.graphs.values()]

        released = [(refs(quantized.eval_step), quantized.quantize),
                    (refs(closed.eval_step), closed.close),
                    (refs(new_state.train_step.graphs),
                     lambda: new_state.train_step(
                         new_state.state.__class__(
                             new_state.model, new_state.optimizer,
                             new_state.state.generator), *new_batch))]
        for graphs, release in released:
            release()
            assert graphs and not any(r() for r in graphs)
        graphs = refs(dropped.train_step.graphs)
        del closed, dropped
        assert graphs and not any(r() for r in graphs)
        before = [g.replays for g in survivors]
        kept(trainer.state, *batch)
        engine.predict(REQUESTS)        # two batches of one signature
    assert [(g.replays - n, g.resets) for g, n in zip(survivors, before)] \
        == [(1, 0), (2, 0)]
