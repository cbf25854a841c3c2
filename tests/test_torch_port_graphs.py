"""The port's counterpart of ``jax.jit`` for the eval step
(``ruart_tpu_torch/utils/graphs.py``: one CUDA graph per batch signature)
on the CPU, where no graph can be captured:

* the signature key is the jit cache's: key sets, shapes, dtypes and
  whether targets are passed each give another key, equal inputs one;
* static inputs give every dict key its own tensor, also where one tensor
  stands under several keys (``put_block`` moves an aliased grid once), so
  a later call that aliases its keys otherwise still fills each key;
* a stand-in for ``torch.cuda``'s graph API runs the capture and replay
  logic on the CPU: a capture takes its launches back, each replay adds
  them, so the launch counts of a replayed run equal an eager run's (the
  first call of a signature is its eager run), and a replay's outputs are
  the static ones, overwritten with each call's values;
* ``make_eval_step`` and ``InferenceEngine`` on the CPU stay eager, and
  the eval step matches the JAX package's jitted ``make_eval_step``
  within 1e-5 (scores and loss); the engine's forward equals the step;
* the conditions that keep the step eager (``graphs=False``, the CPU, a
  mesh, ``debug_nans``) and, call by call, ``record_intermediates``; a
  capture that fails raises RuntimeError naming the signature.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from ruart_tpu.train.train_step import make_eval_step as jax_make_eval_step
from ruart_tpu_torch.convert import to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.pipeline import host_block, put_block
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.introspect import is_recording, record_intermediates
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops import attention as att
from ruart_tpu_torch.parallel.mesh import Mesh
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.train_step import eager_reason, make_eval_step
from ruart_tpu_torch.utils import graphs
from ruart_tpu_torch.utils.graphs import SignatureGraphs, signature, static_inputs
from test_torch_port_slice import VOCAB_SIZE, _opt, _port_engine

torch.set_num_threads(2)
TOL = 1e-5


def _blocks(seed=0):
    q = {"ids": torch.arange(6).reshape(2, 3), "mask": torch.ones(2, 3)}
    ocr = {"ids": torch.full((2, 4), seed), "pos": torch.zeros(2, 4, 8)}
    return q, ocr


def test_signature_is_the_jit_cache_key():
    q, ocr = _blocks()
    base = signature((q, ocr, None))
    assert signature(_blocks(seed=7) + (None,)) == base  # values do not count
    assert signature((dict(reversed(list(q.items()))), ocr, None)) == base
    variants = [
        (dict(q, extra=torch.zeros(1)), ocr, None),             # key set
        ({**q, "ids": torch.arange(8).reshape(2, 4)}, ocr, None),   # shape
        ({**q, "ids": q["ids"].int()}, ocr, None),                 # dtype
        (q, ocr, torch.zeros(2, 5)),                               # targets
    ]
    keys = [signature(v) for v in variants]
    assert base not in keys and len(set(keys)) == len(keys)


def test_static_inputs_give_every_key_its_own_tensor():
    """An aliased host grid becomes one device tensor under two keys
    (``put_block``); the static inputs copy each key apart, so a later call
    whose two keys differ fills both."""
    grid = np.arange(12, dtype=np.int32).reshape(3, 4)
    block = put_block(host_block({"bert": grid, "bert_unique": grid},
                                 _spec(), slim=False), torch.device("cpu"))
    assert block["bert"] is block["bert_unique"]
    (static,) = static_inputs((block,), torch.device("cpu"))
    assert static["bert"].data_ptr() != static["bert_unique"].data_ptr()
    other = {"bert": block["bert"] + 1, "bert_unique": block["bert"] * 2}
    graphs.copy_into((static,), (other,))
    for k in other:
        assert torch.equal(static[k], other[k])


def _spec():
    return ModelSpec.from_config(Config(_opt({})),
                                 BertConfig.tiny(vocab_size=VOCAB_SIZE))


class _FakeGraph:
    """A captured step: replay runs it again on the static inputs, into the
    static outputs, with the launch counters held still (a replay calls no
    Python wrapper)."""

    capturing = None

    def replay(self):
        fn, inputs, outputs = self.body
        counts = att.launch_counts()
        for out, new in zip(outputs, fn(*inputs)):
            out.copy_(new)
        att.add_launches(tuple(a - b for a, b in
                               zip(counts, att.launch_counts())))


class _FakeStream:
    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None, capture_error_mode=None):
    assert capture_error_mode == "thread_local" and pool is not None
    _FakeGraph.capturing = graph
    yield
    _FakeGraph.capturing = None


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)


def test_replays_count_as_eager_launches(monkeypatch):
    _fake_cuda(monkeypatch)

    def step(q, ocr, targets):
        att.attention_rows_cuda.launches += 3   # as 3 wrapper calls would
        out = (q["ids"].float().sum(-1) + ocr["ids"].float().sum(-1),
               q["mask"].sum())
        graph = _FakeGraph.capturing
        if graph is not None:  # the capture records the step and its outputs
            graph.body = (step, (q, ocr, targets), out)
        return out

    before = att.launch_counts()
    graphed = SignatureGraphs(step, torch.device("cpu"))
    runs = [_blocks(seed) for seed in (0, 1, 2)]
    got = [graphed(q, ocr, None) for q, ocr in runs]
    # one graph; the first call is its eager run, the replays return the
    # same static outputs
    assert len(graphed) == 1 and got[1][0] is got[2][0]
    assert got[0][0] is not got[1][0]
    # the first call's eager run + 2 replays, none at capture
    assert att.attention_rows_cuda.launches - before[0] == 3 * 3
    last = tuple(t.clone() for t in got[-1])
    want = step(*runs[-1], None)
    assert all(torch.equal(a, b) for a, b in zip(last, want))
    assert torch.equal(got[0][0], step(*runs[0], None)[0])
    (entry,) = graphed.graphs.values()
    assert entry.launches == (3, 0, 0, 0)
    graphed(*_blocks()[:1], {"ids": torch.zeros(2, 5, dtype=torch.long)},
            None)  # another signature, another graph
    assert len(graphed) == 2


@pytest.fixture(scope="module")
def batch():
    opt = _opt({})
    cfg = Config(opt)
    spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE))
    return opt, spec, make_synthetic_batch(spec, cfg, 2, seed=0)


def test_eval_step_on_cpu_is_eager_and_matches_jax(batch):
    """The port's seeded weights, as the flax tree in the JAX step."""
    opt, spec, (q, ocr, od, gt) = batch
    model = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    jax_spec = JaxModelSpec.from_config(
        JaxConfig(opt), JaxBertConfig.tiny(vocab_size=VOCAB_SIZE))
    jax_step = jax_make_eval_step(JaxRUArtModel(jax_spec),
                                  jax_make_loss_fn("BCE_D1"))
    want = jax_step(jax.tree.map(jnp.asarray, to_jax_params(model)),
                    *(jax.tree.map(jnp.asarray, t) for t in (q, ocr, od, gt)))
    step = make_eval_step(model, make_loss_fn("BCE_D1"))
    assert not isinstance(step, SignatureGraphs)
    blocks = [{k: torch.from_numpy(v) for k, v in t.items()}
              for t in (q, ocr, od)]
    scores, loss = step(*blocks, torch.from_numpy(gt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[0]), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(float(loss), float(want[1]), rtol=TOL)
    # the engine serves through the same eager step on the CPU
    engine = _port_engine(opt, {}, model.state_dict())
    assert engine.graph_count == 0
    assert not isinstance(engine.eval_step, SignatureGraphs)
    assert torch.equal(engine._forward(blocks), step(*blocks, None)[0])


CUDA = torch.device("cuda")


@pytest.mark.parametrize("kwargs,reason", [
    ({}, None),
    ({"graphs": False}, "graphs=False"),
    ({"device": torch.device("cpu")}, "device cpu"),
    ({"mesh": Mesh.local(1, 2)}, "mesh"),
    ({"debug_nans": True}, "debug_nans"),
], ids=["graphs", "graphs=False", "cpu", "mesh", "debug_nans"])
def test_conditions_that_keep_the_step_eager(kwargs, reason):
    kwargs = dict(kwargs)
    assert eager_reason(kwargs.pop("device", CUDA), **kwargs) == reason


def test_record_intermediates_runs_eagerly_and_capture_failure_names_signature(
        batch):
    """While the model records, each call runs eagerly (a replay cannot
    fill the record's lists); outside, the step captures, and on a build
    without CUDA the capture fails, naming the signature."""
    _, spec, (q, ocr, od, _) = batch
    model = RUArtModel(spec).eval()
    step = make_eval_step(model, graphs=False)
    graphed = SignatureGraphs(step, CUDA, eager_when=lambda: is_recording(model))
    blocks = [{k: torch.from_numpy(v) for k, v in t.items()}
              for t in (q, ocr, od)]
    with record_intermediates(model) as record:
        scores, _ = graphed(*blocks, None)
    assert record["cand_emb"] and len(graphed) == 0
    assert torch.equal(scores, step(*blocks, None)[0])
    with pytest.raises(RuntimeError, match="capture failed for signature"):
        graphed(*blocks, None)
