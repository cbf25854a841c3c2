"""The port's attention maps (``models/fusion/introspect.py``) and the
BERT entry points off the model's path (``encode_chunked``,
``BertWordEncoder``) against the JAX package, on the CPU, at
TINY_OVERRIDES with a tiny BERT and weights carried by the weight bridge.

``forward_with_attention`` gives the JAX package's key set (its module
paths) and each alpha within 1e-5 abs; recording leaves no trace on later
forwards. ``encode_chunked`` over rows longer than ``max_chunk`` and
``BertWordEncoder`` (with and without the α/γ combine) within 1e-5 abs.
Inputs are made with numpy from seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.models.bert import model as jax_bert
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.introspect import (
    forward_with_attention as jax_forward_with_attention,
)
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.bert import model as bert
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.introspect import (
    forward_with_attention,
    record_intermediates,
)
from ruart_tpu_torch.models.fusion.layers import Attention
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = 64


def _batch_and_models(extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update(extra)
    two = dict(vocab_size=VOCAB, num_hidden_layers=2)
    jspec = JaxModelSpec.from_config(
        JaxConfig(opt), dataclasses.replace(JaxBertConfig.tiny(), **two))
    spec = ModelSpec.from_config(
        Config(opt), dataclasses.replace(BertConfig.tiny(), **two))
    q, ocr, od, _ = make_synthetic_batch(jspec, JaxConfig(opt), 2, seed=0)
    port = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, to_jax_params(port))
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    jb = [jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)]
    tb = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
          for b in (q, ocr, od)]
    return JaxRUArtModel(jspec), params, jb, port.eval(), tb


@pytest.mark.parametrize("extra", [{}, {"PRE_ALIGN_after_rnn": True,
                                        "position_mod": "cat"}],
                         ids=["shipped", "prealign-twice+position-cat"])
def test_attention_maps_match_jax(extra):
    jmodel, params, jb, port, tb = _batch_and_models(extra)
    want_scores, want = jax.jit(
        lambda p, *b: jax_forward_with_attention(jmodel, p, *b))(params, *jb)
    with torch.no_grad():
        scores, alphas = forward_with_attention(port, *tb)
    assert sorted(alphas) == sorted(want)
    assert len(alphas) >= 6
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=TOL, rtol=0)
    for path, a in alphas.items():
        w = np.asarray(want[path])
        assert tuple(a.shape) == w.shape, path
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, rtol=0,
                                   err_msg=path)
        np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-5)
    # recording is off again: no module keeps a list, the forward is as
    # before
    assert all(m.sown is None for m in port.modules() if isinstance(m, Attention))
    assert port.sown_cand_emb is None
    with torch.no_grad():
        again = port(*tb)
    np.testing.assert_array_equal(again.numpy(), scores.numpy())


def test_record_intermediates_holds_cand_emb():
    """The candidate embedding before multi2one (the JAX ``cand_emb``
    sow), one per candidate block, and the lists are dropped after an
    error in the forward too."""
    jmodel, params, jb, port, tb = _batch_and_models({})
    _, state = jax.jit(lambda p, *b: jmodel.apply(
        p, *b, mutable=["intermediates"]))(params, *jb)
    want = state["intermediates"]["cand_emb"]
    with torch.no_grad(), record_intermediates(port) as record:
        port(*tb)
    got = record["cand_emb"]
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    with pytest.raises(KeyError):
        with record_intermediates(port):
            port(tb[0], {}, tb[2])
    assert port.sown_cand_emb is None


@pytest.fixture(scope="module")
def tiny_bert():
    cfg = dict(vocab_size=VOCAB, max_position_embeddings=8)
    jm = jax_bert.BertModel(JaxBertConfig.tiny(**cfg))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))
    tm = bert.BertModel(BertConfig.tiny(**cfg))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("L", [8, 13, 24])
def test_encode_chunked_matches_jax(tiny_bert, L):
    """Rows of L over chunks of 8 (positions restart in each chunk), with
    a key mask; L 8 is one chunk."""
    jm, params, tm = tiny_bert
    rng = np.random.RandomState(L)
    lens = rng.randint(1, L + 1, size=3)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(5, VOCAB, size=(3, L)) * mask).astype(np.int32)
    want = np.asarray(jax_bert.encode_chunked(jm, params, jnp.asarray(ids),
                                              jnp.asarray(mask), max_chunk=8))
    with torch.no_grad():
        got = bert.encode_chunked(tm, torch.from_numpy(ids),
                                  torch.from_numpy(mask), max_chunk=8).numpy()
    assert got.shape == want.shape == (3, 3, L, 32)
    valid = mask.astype(bool)  # padded queries are never read
    np.testing.assert_allclose(got[:, valid], want[:, valid], atol=TOL, rtol=0)


@pytest.mark.parametrize("combine", [True, False])
def test_bert_word_encoder_matches_jax(combine):
    rng = np.random.RandomState(5)
    B, Lb, W = 3, 10, 4
    lens = rng.randint(4, Lb + 1, size=B)
    mask = (np.arange(Lb)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(5, VOCAB, size=(B, Lb)) * mask).astype(np.int32)
    st = np.sort(rng.randint(0, 4, size=(B, W)), axis=1)
    offsets = np.stack([st, st + rng.randint(0, 3, size=(B, W))], -1)
    wmask = (rng.rand(B, W) > 0.2).astype(np.int32)
    jm = jax_bert.BertWordEncoder(JaxBertConfig.tiny(vocab_size=VOCAB),
                                  linear_combine=combine)
    args = [jnp.asarray(a) for a in (ids, mask, offsets.astype(np.int32), wmask)]
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    if combine:  # away from the uniform init
        inner = dict(params["params"])
        inner["alphaBERT"] = jnp.asarray(rng.randn(3).astype(np.float32))
        inner["gammaBERT"] = jnp.asarray([[1.7]], jnp.float32)
        params = {"params": inner}
    want = np.asarray(jax.jit(jm.apply)(params, *args))
    tm = bert.BertWordEncoder(BertConfig.tiny(vocab_size=VOCAB),
                              linear_combine=combine)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(np.asarray(a)) for a in (
            ids, mask, offsets, wmask))).numpy()
    assert got.shape == want.shape == (B, W, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
