"""The train step's CUDA graph path (``train_step.make_train_step`` over
``utils.graphs.SignatureGraphs``) on the CPU, where no graph can be
captured: a stand-in for ``torch.cuda``'s graph API runs the capture and
replay logic.

The stand-in is as strict as a real graph about what the host does: its
capture runs the step's Python (as a real capture must) but undoes what
that did to the parameters, the moments and the dropout generator (a real
capture executes nothing), and its replay runs the step again with every
Python value the capture read frozen — the optimizer's count and the
moment tensors it held — so a value baked into the capture shows as a
difference from the eager step at the next replay. A dropout generator
that was not registered with the graph fails its capture, as on a card.

* Three steps of the shipped train conf at TINY_OVERRIDES with dropout on,
  graph path against ``graphs=False``: losses and parameters byte-equal.
  The first call of the signature is one optimizer step (its eager run),
  the losses of the replays are tensors of their own with each step's
  value, and the graph registered the state's generator. A body that still
  divides by the Python-float bias correction fails this from step 2 on.
* Two graph steps against the JAX package's jitted
  ``make_train_step`` with dropout off, with
  ``test_torch_port_train_step.py``'s tolerances.
* ``Optimizer.load_state_dict`` after a capture: the next replay uses the
  loaded moments.
* ``eager_reason`` keeps the train step eager for ``graphs=False``, the
  CPU, a mesh and ``debug_nans``; a capture that fails raises
  RuntimeError naming the signature.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import ruart_tpu_torch.train.train_step as train_step_mod
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops import attention as att
from ruart_tpu_torch.parallel.mesh import Mesh
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import (
    B1,
    B2,
    Optimizer,
    bias_correction,
    make_row_pinner,
)
from ruart_tpu_torch.train.train_step import init_train_state, make_train_step
from ruart_tpu_torch.utils.graphs import SignatureGraphs
from test_torch_port_train_step import (
    LOSS_RTOL,
    LR,
    PARAM_ATOL,
    TUNE_ROWS,
    VOCAB_SIZE,
    jax_reference,
    shared_batch,
    shared_flax_params,
    train_batch,
)
from test_torch_port_train_step import _opt as _opt_without_dropout

torch.set_num_threads(2)
N_STEPS = 3


class _StandInGraph:
    """A captured train step: ``replay`` runs its body again on the static
    inputs with the optimizer's count and moment tensors as the capture
    saw them, writes the static output and holds the launch counters
    still (a replay calls no Python wrapper)."""

    def __init__(self):
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        fn, inputs, output = self.body
        opt = fn.args[0].optimizer
        live = opt.count, opt.state
        opt.count, opt.state = self.frozen
        counts = att.launch_counts()
        try:
            output.copy_(fn(*inputs))
        finally:
            opt.count, opt.state = live
        att.add_launches(tuple(a - b for a, b in
                               zip(counts, att.launch_counts())))


class _StandInGraphs(SignatureGraphs):
    """Gives each captured graph its body, inputs and output to replay."""

    def _capture(self, key, args):
        entry, result = super()._capture(key, args)
        entry.graph.body = (self.fn, entry.inputs, entry.outputs)
        return entry, result


class _UnregisteredGenerators(_StandInGraphs):
    """Drops the generators it is asked to register."""

    def __init__(self, fn, device, generators=()):
        super().__init__(fn, device)


class _FakeStream:
    def wait_stream(self, other):
        pass


def _snapshot(state):
    tensors = [p.data for p in state.model.parameters()]
    tensors += [t for st in state.optimizer.state.values() for t in st.values()]
    return tensors, [t.clone() for t in tensors], state.generator.get_state()


@contextlib.contextmanager
def _stand_in_capture(graph, pool=None, stream=None, capture_error_mode=None):
    """Runs the body's Python and undoes its effects; freezes the Python
    values a replay must reuse. Fails for an unregistered generator."""
    assert capture_error_mode == "thread_local" and pool is not None
    state = _stand_in_capture.state
    if state.generator not in graph.generators:
        raise RuntimeError("Attempt to increase offset for a CUDA generator "
                           "not in capture mode.")
    opt = state.optimizer
    graph.frozen = opt.count, {n: dict(st) for n, st in opt.state.items()}
    tensors, values, rng = _snapshot(state)
    yield
    for t, v in zip(tensors, values):
        t.copy_(v)
    state.generator.set_state(rng)


def _stand_in_cuda(monkeypatch, state=None):
    """Graph API stand-ins, and the train step's graph path on the CPU."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(_stand_in_capture, "state", state, raising=False)
    monkeypatch.setattr(train_step_mod, "SignatureGraphs", _StandInGraphs)
    on_a_card = functools.partial(train_step_mod.eager_reason,
                                  torch.device("cuda"))
    monkeypatch.setattr(train_step_mod, "eager_reason",
                        lambda device, *args: on_a_card(*args))


class _HostBiasOptimizer(Optimizer):
    """The update dividing by the Python-float bias corrections of the
    count, as before they became device tensors."""

    def update(self):
        tensors = self.bias_corrections
        self.bias_corrections = (bias_correction(B1, self.count),
                                 bias_correction(B2, self.count))
        try:
            super().update()
        finally:
            self.bias_corrections = tensors


def _opt(dropout: bool):
    opt = _opt_without_dropout(True)
    if dropout:  # the shipped conf's dropout, which the helper removes
        shipped = read_conf_lines(STVQA_CONF.splitlines())
        opt.update({k: shipped[k] for k in ("DROPOUT", "dropout_emb")})
    return opt


@pytest.fixture(scope="module")
def setup():
    """The shipped train conf with dropout, its model's seeded weights and
    one collated batch."""
    opt = _opt(True)
    spec = ModelSpec.from_config(Config(opt),
                                 BertConfig.tiny(vocab_size=VOCAB_SIZE))
    weights = RUArtModel(spec).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    batch = train_batch(opt)
    return opt, spec, weights, batch


def _state(spec, weights, optimizer=Optimizer):
    model = RUArtModel(spec)
    model.load_state_dict(weights)
    tx = optimizer("#", LR, 10.0, model, spec, True)
    return init_train_state(model, tx, seed=7)


def _step(spec, state, graphs=True, **kwargs):
    return make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(state.model, spec, TUNE_ROWS),
                           graphs=graphs, **kwargs)


def _tensors(batch):
    q, ocr, od = ({k: torch.from_numpy(v) for k, v in b.items()}
                  for b in batch[:3])
    return q, ocr, od, torch.from_numpy(batch[3])


def _run(step, state, batch, n=N_STEPS):
    losses, params = [], []
    for _ in range(n):
        state, loss = step(state, *_tensors(batch))
        losses.append(loss)
        params.append({k: v.clone() for k, v in state.model.state_dict().items()})
    return losses, params


@pytest.mark.parametrize("optimizer,baked", [(Optimizer, False),
                                             (_HostBiasOptimizer, True)],
                         ids=["device_bias_correction", "python_float_bias"])
def test_graph_steps_match_eager_steps(monkeypatch, setup, optimizer, baked):
    """Three steps on one batch signature (a capture, two replays) against
    ``graphs=False``, dropout on: byte-equal, unless the update reads a
    host value that the capture froze."""
    _, spec, weights, batch = setup
    eager = _state(spec, weights, optimizer)
    want_losses, want_params = _run(_step(spec, eager, graphs=False), eager,
                                    batch)
    state = _state(spec, weights, optimizer)
    _stand_in_cuda(monkeypatch, state)
    step = _step(spec, state)
    # the first call of the signature is one optimizer step
    got_losses, got_params = _run(step, state, batch, n=1)
    assert state.optimizer.count == state.step == 1 and len(step.graphs) == 1
    more_losses, more_params = _run(step, state, batch, n=N_STEPS - 1)
    got_losses += more_losses
    got_params += more_params
    (entry,) = step.graphs.graphs.values()
    assert entry.graph.generators == [state.generator]
    # each step's loss is a tensor of its own
    assert len({id(x) for x in got_losses}) == N_STEPS
    assert len({x.data_ptr() for x in got_losses}) == N_STEPS
    equal = [torch.equal(a, b) and all(torch.equal(g[k], w[k]) for k in w)
             for a, b, g, w in zip(got_losses, want_losses, got_params,
                                   want_params)]
    # the eager losses differ from step to step (new masks, new weights)
    assert len({float(x) for x in want_losses}) == N_STEPS
    assert equal == ([True] + [False] * (N_STEPS - 1) if baked
                     else [True] * N_STEPS)


def test_graph_steps_match_jax_jitted_train_step(monkeypatch):
    """Two steps on the graph path against the JAX package's jitted
    ``make_train_step`` (the run ``test_torch_port_train_step.py`` holds
    the eager step to), dropout off: the loss within 1e-5 relative, the
    parameters within 0.05 * lr where the gradient is not ~0 (there Adamax
    moves an element by lr in a direction rounding decides), and at most
    lr per step from the start elsewhere."""
    opt = _opt(False)
    spec = ModelSpec.from_config(Config(opt),
                                 BertConfig.tiny(vocab_size=VOCAB_SIZE))
    weights = from_jax_params(shared_flax_params())
    batch = shared_batch()
    want_losses, want_params = jax_reference(True)
    # the gradient the parameters follow, from one eager step
    probe = _state(spec, weights)
    _step(spec, probe, graphs=False)(probe, *_tensors(batch))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in probe.model.named_parameters()}

    state = _state(spec, weights)
    _stand_in_cuda(monkeypatch, state)
    got_losses, got_params = _run(_step(spec, state), state, batch, n=2)
    np.testing.assert_allclose([float(x) for x in got_losses], want_losses,
                               rtol=LOSS_RTOL)
    for i in range(2):
        for name, want in want_params[i].items():
            got = got_params[i][name].numpy()
            zero = (grads[name].abs() < 1e-7).numpy() if name in grads else (
                np.zeros(got.shape, bool))
            np.testing.assert_allclose(got[~zero], want.numpy()[~zero],
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"step {i}: {name}")
            moved = np.abs(got - weights[name].numpy())[zero]
            assert (moved <= (i + 1) * LR * (1 + 1e-4)).all(), name


def test_loaded_optimizer_state_reaches_the_replay(monkeypatch, setup):
    """A state loaded after the capture (a resume) is what the next replay
    updates: the graph arm's third step equals the eager arm's after the
    same load."""
    _, spec, weights, batch = setup
    donor = _state(spec, weights)  # one step: moments unlike two steps'
    _run(_step(spec, donor, graphs=False), donor, batch, n=1)
    arrays = donor.optimizer.state_dict()

    eager = _state(spec, weights)
    eager_step = _step(spec, eager, graphs=False)
    _run(eager_step, eager, batch, n=2)
    eager.optimizer.load_state_dict(arrays)
    want = _run(eager_step, eager, batch, n=1)

    state = _state(spec, weights)
    _stand_in_cuda(monkeypatch, state)
    step = _step(spec, state)
    _run(step, state, batch, n=2)  # the capture, then a replay
    mu = {n: st["mu"].clone() for n, st in state.optimizer.state.items()}
    state.optimizer.load_state_dict(arrays)
    assert any(not torch.equal(st["mu"], mu[n])
               for n, st in state.optimizer.state.items())
    got = _run(step, state, batch, n=1)
    assert len(step.graphs) == 1 and state.optimizer.count == 2
    assert torch.equal(got[0][0], want[0][0])
    for name, value in want[1][0].items():
        assert torch.equal(got[1][0][name], value), name


@pytest.mark.parametrize("kwargs", [{"graphs": False}, {"debug_nans": True},
                                    {"mesh": Mesh.local(1, 1)}, {}],
                         ids=["graphs=False", "debug_nans", "mesh", "cpu"])
def test_conditions_that_keep_the_train_step_eager(monkeypatch, setup, kwargs):
    _, spec, weights, batch = setup
    state = _state(spec, weights)
    if kwargs:  # as on a card, where only the condition keeps it eager
        _stand_in_cuda(monkeypatch, state)
    step = _step(spec, state, **kwargs)
    _run(step, state, batch, n=1)
    assert step.graphs is None and step.state is state


@pytest.mark.parametrize("failure", ["no_cuda", "unregistered_generator"])
def test_capture_failure_names_the_signature(monkeypatch, setup, failure):
    """Without CUDA the first call's set-up fails; with the graph API
    present, a capture whose dropout generator was not registered fails.
    Either raises RuntimeError naming the signature: nothing runs the step
    eagerly instead."""
    _, spec, weights, batch = setup
    state = _state(spec, weights)
    if failure == "no_cuda":
        monkeypatch.setattr(train_step_mod, "eager_reason",
                            lambda *args: None)
        step = _step(spec, state)
    else:
        _stand_in_cuda(monkeypatch, state)
        monkeypatch.setattr(train_step_mod, "SignatureGraphs",
                            _UnregisteredGenerators)
        step = _step(spec, state)
    with pytest.raises(RuntimeError, match="capture failed for signature"):
        step(state, *_tensors(batch))
