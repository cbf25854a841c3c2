"""The port's losses and optimizer (ruart_tpu_torch/train/{loss,optim}.py)
against the JAX package's (optax): the same gradients, made with numpy,
go through ``ruart_tpu.train.optim.make_optimizer`` + ``make_row_pinner``
and through the port's ``Optimizer`` + ``make_row_pinner`` on a toy model
with the roots the policy names (``Bert``, ``glove_embed``,
``fast_embed``) and one trainable head.

Tolerances: losses 1e-6 relative (fp32, the same formula); parameters
1e-6 relative + 1e-7 abs after each of three steps: the updates are about
lr = 1e-3 and round differently in the last fp32 bits (sqrt, divisions);
the gradients are drawn away from 0, where Adamax would amplify rounding.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ruart_tpu.train import loss as jax_loss
from ruart_tpu.train.optim import make_optimizer, make_row_pinner
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.train import loss as port_loss
from ruart_tpu_torch.train.optim import Optimizer
from ruart_tpu_torch.train.optim import make_row_pinner as port_row_pinner

torch.set_num_threads(2)
VOCAB, TUNE_ROWS, CLIP = 30, 12, 10.0
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    scores = rng.rand(4, 9).astype(np.float32)
    labels = (rng.rand(4, 9) > 0.7).astype(np.float32)
    labels[np.arange(4), rng.randint(0, 9, 4)] = 1.0
    for name in ("BCE", "BCE_D1", "CE"):
        want = jax_loss.make_loss_fn(name)(jnp.asarray(scores), jnp.asarray(labels))
        got = port_loss.make_loss_fn(name)(torch.from_numpy(scores),
                                           torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.Bert = nn.Linear(3, 2)
        self.glove_embed = nn.Embedding(VOCAB, 4)
        self.fast_embed = nn.Embedding(VOCAB, 4)
        self.head = nn.Linear(4, 2)


def _grads(rng, params, scale):
    """Gradients away from 0 with global norm ``scale`` (flax tree)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    gs = [(rng.rand(*np.shape(x)) + 0.5) * rng.choice([-1, 1], np.shape(x))
          for x in leaves]
    norm = np.sqrt(sum((g ** 2).sum() for g in gs))
    return jax.tree_util.tree_unflatten(
        treedef, [(g * scale / norm).astype(np.float32) for g in gs])


def _run_both(opt_name, lr, lock_bert, tune_partial, scales, none_grad=None):
    """Three steps in both packages; returns [(jax params, port params)]
    as port state dicts after each step, and the port optimizer."""
    spec = types.SimpleNamespace(lock_bert=lock_bert)
    torch.manual_seed(0)
    toy = Toy()
    torch.nn.init.normal_(toy.Bert.weight, generator=torch.Generator().manual_seed(1))
    params = jax.tree.map(jnp.asarray, to_jax_params(toy))
    tx = make_optimizer(opt_name, lr, CLIP, params, spec, tune_partial)
    pin = make_row_pinner(params, spec, TUNE_ROWS if tune_partial else None)
    state = tx.init(params)
    port_opt = Optimizer(opt_name, lr, CLIP, toy, spec, tune_partial)
    port_pin = port_row_pinner(toy, spec, TUNE_ROWS if tune_partial else None)
    rng = np.random.RandomState(3)
    out = []
    for scale in scales:
        grads = _grads(rng, params, scale)
        if none_grad is not None:
            grads["params"][none_grad] = jax.tree.map(np.zeros_like,
                                                      grads["params"][none_grad])
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = pin(optax.apply_updates(params, updates))
        for name, g in from_jax_params(grads).items():
            p = toy.get_parameter(name)
            p.grad = None if name.split(".")[0] == none_grad else g.clone()
        port_opt.step()
        port_pin()
        out.append((from_jax_params(jax.tree.map(np.asarray, params)),
                    {n: p.detach().clone() for n, p in toy.named_parameters()}))
    return out, port_opt, state


@pytest.mark.parametrize("opt_name,lr", [("#", 1e-3), ("ADAM", None),
                                         ("ADAM2", 2e-3), ("SGD", 0.1)])
@pytest.mark.parametrize("lock_bert,tune_partial", [(True, True), (False, False)],
                         ids=["lock-tune", "unlocked-frozen-words"])
def test_updates_match_optax(opt_name, lr, lock_bert, tune_partial):
    # norms 30 and 12 clip, 3 does not
    out, _, _ = _run_both(opt_name, lr, lock_bert, tune_partial, (30.0, 3.0, 12.0))
    for step, (want, got) in enumerate(out):
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"step {step}: {name}")


def test_clip_threshold_matches_optax():
    """SGD at lr 1 returns the clipped gradient itself: kept below the
    max norm, scaled by max_norm / norm above it. (At a norm of exactly
    max_norm the side is decided by the rounding of the norm, which the
    two packages sum in different orders.)"""
    for scale in (CLIP * (1 - 1e-4), CLIP * (1 + 1e-4), 50.0):
        out, _, _ = _run_both("SGD", 1.0, False, True, (scale,))
        want, got = out[0]
        for name in want:
            # at lr 1 the update is O(1): a few fp32 steps of 1.2e-7
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"norm {scale}: {name}")


def test_frozen_roots_pinned_rows_and_missing_grads():
    out, port_opt, jax_state = _run_both("#", 1e-3, True, True, (30.0, 3.0, 12.0),
                                         none_grad="head")
    want, got = out[-1]
    first = out[0][1]
    for name in want:  # a None gradient counts as zeros, as in JAX
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
    # LOCK_BERT: no state and no update for the encoder
    assert not any(n.startswith("Bert.") for n in port_opt.params)
    torch.testing.assert_close(got["Bert.weight"], first["Bert.weight"])
    # TUNE_PARTIAL: rows >= tune_partial and row 1 never move, but their
    # moments update like the others (optax's mu tree shows the same)
    w0, w = out[0][1]["glove_embed.weight"], got["glove_embed.weight"]
    torch.testing.assert_close(w[TUNE_ROWS:], w0[TUNE_ROWS:], rtol=0, atol=0)
    torch.testing.assert_close(w[1], w0[1], rtol=0, atol=0)
    assert not torch.equal(w[2:TUNE_ROWS], w0[2:TUNE_ROWS])
    mu = port_opt.state["glove_embed.weight"]["mu"]
    jax_mu = optax.tree_utils.tree_get(jax_state, "mu")["params"]["glove_embed"]
    np.testing.assert_allclose(mu.numpy(), np.asarray(jax_mu["embedding"]),
                               rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert (mu[TUNE_ROWS:] != 0).all()


def test_frozen_word_tables_without_tune_partial():
    out, port_opt, _ = _run_both("#", 1e-3, False, False, (30.0,))
    assert set(port_opt.params) == {"Bert.weight", "Bert.bias", "head.weight",
                                    "head.bias"}


@pytest.mark.parametrize("opt_name", ["#", "ADAM2"])
def test_bias_correction_rounds_as_optax(opt_name):
    """optax computes Adam's ``1 - b ** t`` in float32: at b2 0.999 and
    t 1 that is 0.0009999871, 1.3e-5 from 0.001. At lr 1, where an update
    is O(1), the port's first steps must follow it to 1e-6 abs (the
    float64 formula misses by ~6e-6 in ADAM2)."""
    out, _, _ = _run_both(opt_name, 1.0, False, True, (3.0, 2.0))
    for step, (want, got) in enumerate(out):
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {step}: {name}")
