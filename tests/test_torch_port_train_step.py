"""Two train steps of the port against ``ruart_tpu.train.train_step.
make_train_step``: the same flax init (mapped through
``convert.from_jax_params``), the same collated batch (default layouts:
packed, compacted, fused encoder call), TINY_OVERRIDES, the shipped
optimizer ('#' Adamax, lr 1e-3, grad_clipping 10, TUNE_PARTIAL with
tune_partial 20 so rows 20.. of the 50-row tables are pinned), with
``DROPOUT`` and ``dropout_emb`` removed so both packages compute the same
function. Once under the shipped LOCK_BERT and once with BERT unlocked
(which runs the attention's autograd backward).

The JAX gradients come from one ``jax.grad`` of the unlocked model:
LOCK_BERT only cuts the encoder's gradients (the forward is the same), so
under LOCK_BERT the port's gradients must match them outside the encoder
and be absent inside it.

Tolerances: the loss within 1e-5 relative; the step-1 gradients within
1e-5 abs; the parameters after each step within 0.05 * lr abs. Adamax moves
every element by about lr whatever the size of its gradient, so an element
whose true gradient is 0 (the bias in front of a softmax over the
sequence) moves by lr * noise / (|noise| + eps) in either package, in a
direction rounding decides: such elements (|JAX gradient| < 1e-7) are held
only to Adamax's own bound, at most lr per step from where they started.
"""

import functools

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
from ruart_tpu.train.optim import make_optimizer as jax_make_optimizer
from ruart_tpu.train.optim import make_row_pinner as jax_make_row_pinner
from ruart_tpu.train.train_step import init_train_state as jax_init_state
from ruart_tpu.train.train_step import make_train_step as jax_make_train_step
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
from ruart_tpu_torch.train.train_step import init_train_state, make_train_step

torch.set_num_threads(2)
LR = 1e-3
TUNE_ROWS = 20
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
PARAM_ATOL = 0.05 * LR
VOCAB_SIZE = len(build_demo_vocab())


def _opt(lock_bert: bool):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 2, "tune_partial": TUNE_ROWS,
                "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "datadir": ".",
                "FEATURE_FOLDER": "."})
    for key in ("DROPOUT", "dropout_emb") + (() if lock_bert else ("LOCK_BERT",)):
        opt.pop(key)
    return opt


def train_batch(opt):
    """One collated training batch (numpy) from synthetic raw data."""
    cfg = Config(opt)
    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(2, seed=5, n_ocr_range=(3, 9), n_es=6)
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="train",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    return Collator(cfg)([ds[i] for i in range(len(ds))])


@functools.lru_cache(maxsize=None)
def shared_batch():
    return train_batch(_opt(True))


@functools.lru_cache(maxsize=None)
def shared_flax_params():
    """Random weights as a flax tree (the port's seeded init through
    ``convert.to_jax_params``; the checkpoint tests hold that tree to a
    flax init's structure)."""
    spec = ModelSpec.from_config(Config(_opt(True)),
                                 BertConfig.tiny(vocab_size=VOCAB_SIZE))
    model = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    return to_jax_params(model)


@functools.lru_cache(maxsize=None)
def jax_reference(lock_bert: bool):
    """:func:`jax_two_steps` from the shared weights and batch, run once
    per process (``test_torch_port_train_graphs.py`` holds the graph path
    to the same run); callers only read it."""
    return jax_two_steps(_opt(lock_bert), shared_flax_params(), shared_batch())


@pytest.fixture(scope="module")
def batch():
    return shared_batch()


@pytest.fixture(scope="module")
def flax_params():
    return shared_flax_params()


def _jax_model(opt):
    cfg = JaxConfig(opt)
    spec = JaxModelSpec.from_config(cfg, JaxBertConfig.tiny(vocab_size=VOCAB_SIZE))
    return cfg, spec, JaxRUArtModel(spec)


@pytest.fixture(scope="module")
def jax_grads(flax_params, batch):
    """Step-1 gradients of the unlocked JAX model, as port state-dict names."""
    _, _, model = _jax_model(_opt(False))
    loss_fn = jax_make_loss_fn("BCE_D1")
    q, ocr, od, gt = (jax.tree.map(jnp.asarray, t) for t in batch[:4])
    grads = jax.jit(jax.grad(
        lambda p: loss_fn(model.apply(p, q, ocr, od, deterministic=True), gt)
    ))(jax.tree.map(jnp.asarray, flax_params))
    return from_jax_params(jax.tree.map(np.asarray, grads))


def jax_two_steps(opt, params, batch):
    """(losses, params after step 1 and 2) of the JAX package."""
    cfg, spec, model = _jax_model(opt)
    loss_fn = jax_make_loss_fn("BCE_D1")
    q, ocr, od, gt = (jax.tree.map(jnp.asarray, t) for t in batch[:4])
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_make_optimizer("#", LR, 10.0, params, spec, True)
    step = jax_make_train_step(
        model, tx, loss_fn, jax_make_row_pinner(params, spec, TUNE_ROWS),
        donate=False,
    )
    state = jax_init_state(params, tx, cfg.seed)
    losses, after = [], []
    for _ in range(2):
        state, loss = step(state, q, ocr, od, gt)
        losses.append(float(loss))
        after.append(from_jax_params(jax.tree.map(np.asarray, state.params)))
    return losses, after


def port_two_steps(opt, params, batch):
    cfg = Config(opt)
    spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE))
    model = RUArtModel(spec)
    model.load_state_dict(from_jax_params(params))
    tx = Optimizer("#", LR, 10.0, model, spec, True)
    step = make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(model, spec, TUNE_ROWS))
    state = init_train_state(model, tx, cfg.seed)
    q, ocr, od = ({k: torch.from_numpy(v) for k, v in b.items()}
                  for b in batch[:3])
    gt = torch.from_numpy(batch[3])
    losses, grads, after = [], None, []
    for i in range(2):
        state, loss = step(state, q, ocr, od, gt)
        losses.append(float(loss))
        if i == 0:
            grads = {n: (None if p.grad is None else p.grad.clone())
                     for n, p in model.named_parameters()}
        after.append({n: p.detach().clone() for n, p in model.state_dict().items()})
    return losses, grads, after


@pytest.mark.parametrize("lock_bert", [True, False], ids=["lock_bert", "bert_unlocked"])
def test_two_train_steps_match_jax(lock_bert, batch, flax_params, jax_grads):
    opt = _opt(lock_bert)
    want_loss, want_params = jax_reference(lock_bert)
    got_loss, got_grads, got_params = port_two_steps(opt, flax_params, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)

    assert set(got_grads) == set(jax_grads)
    for name, want in jax_grads.items():
        got = got_grads[name]
        if lock_bert and name.startswith("Bert."):
            assert got is None, f"{name} got a gradient under LOCK_BERT"
            continue
        got = torch.zeros_like(want) if got is None else got
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)

    start = from_jax_params(flax_params)
    for step in range(2):
        for name, want in want_params[step].items():
            got = got_params[step][name].numpy()
            zero_grad = np.abs(jax_grads[name].numpy()) < 1e-7
            np.testing.assert_allclose(
                got[~zero_grad], want.numpy()[~zero_grad], atol=PARAM_ATOL,
                rtol=0, err_msg=f"step {step}: {name}")
            moved = np.abs(got - start[name].numpy())[zero_grad]
            assert (moved <= (step + 1) * LR * (1 + 1e-4)).all(), name
    bert_moved = any(
        not np.array_equal(got_params[1][n].numpy(), start[n].numpy())
        for n in start if n.startswith("Bert.")
    )
    # the shipped LOCK_BERT freezes the encoder; unlocked it trains, and the
    # alpha-combine weights train either way
    assert bert_moved == (not lock_bert)
    assert not np.array_equal(got_params[1]["alphaBERT"].numpy(),
                              start["alphaBERT"].numpy())
