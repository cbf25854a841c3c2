"""Every conf branch of ``RUArtModel`` in the port against the JAX package,
in fp32 on the CPU, at TINY_OVERRIDES with a two-layer tiny BERT and the
synthetic batch of ``make_synthetic_batch`` (numpy, seed 0, batch 2).

Each case sets several branches that do not interact, to keep the JAX
compiles few. Per case: the port's seeded init, carried to flax by
``convert.to_jax_params``, has exactly the leaves and shapes of the JAX
init (the port builds a module only where the JAX ``setup`` does), and the
two forwards on those weights agree within 1e-5 abs.

The ``fixed_answers`` case is built as ``tests/test_fusion_model.py``
builds it (with ``label_yesno``, as its yes/no test), ``ES_using_way
post_process`` as there, the ``img_feature`` cases as
``tests/test_image_features.py`` does. Three confs that the JAX forward
cannot run either are refused by the port at construction.
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
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel, unported_conf_keys
from ruart_tpu_torch.models.fusion.spec import ModelSpec

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = 64
IMG = {"img_feature": True, "img_fea_num": 6, "img_fea_dim": 32,
       "img_spa_dim": 8}
NO_BERT = {"BERT": None, "LOCK_BERT": None, "BERT_LINEAR_COMBINE": None,
           "q_embedding": "glove,pos,ent", "ocr_embedding": "fasttext,pos,ent"}

# case -> conf changes (None removes the key)
BRANCHES = {
    "prealign_after_rnn+no_context_self_attention+position_cat": {
        "PRE_ALIGN_befor_rnn": None, "PRE_ALIGN_after_rnn": True,
        "no_Context_Self_Attention": True, "position_mod": "cat"},
    "no_prealign+no_deep_attention+merge_atted": {
        "PRE_ALIGN": None, "PRE_ALIGN_befor_rnn": None,
        "no_DeepAttention": True, "pos_att_merge_mod": "atted"},
    "position_unset+merge_original+glove_only+img_final_att": dict(
        IMG, img_fea_way="final_att", position_dim=None, position_mod=None,
        pos_att_merge_mod="original", FastText=None,
        ocr_embedding="glove,pos,ent,bert", ocr_emb_initial="glove"),
    "no_bert+prealign_before_and_after_rnn": dict(
        NO_BERT, PRE_ALIGN_after_rnn=True),
    "no_linear_combine_unlocked+bert_only": {
        "BERT_LINEAR_COMBINE": None, "LOCK_BERT": None,
        "q_embedding": "glove,pos,ent,bert_only",
        "ocr_embedding": "fasttext,pos,ent,bert_only"},
    "fixed_answers+label_yesno+es_post_process": {
        "fixed_answers": True, "fixed_answers_len": 7, "label_yesno": True,
        "ES_using_way": "post_process"},
    "img_replace_od+no_linear_combine": dict(
        IMG, img_fea_way="replace_od", BERT_LINEAR_COMBINE=None),
}
# confs whose JAX forward fails (KeyError 'word_emb', UnboundLocalError)
NOT_RUNNABLE = {
    "no_glove_no_fasttext": {"GLOVE": None, "FastText": None,
                             "q_embedding": "pos,ent,bert",
                             "ocr_embedding": "pos,ent,bert"},
    "merge_cat_without_position": {"position_dim": None, "position_mod": None},
    "after_rnn_without_prealign": {"PRE_ALIGN": None,
                                   "PRE_ALIGN_befor_rnn": None,
                                   "PRE_ALIGN_after_rnn": True},
}


def _opt(changes):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    for key, value in changes.items():
        if value is None:
            opt.pop(key, None)
        else:
            opt[key] = value
    return opt


def _specs(changes):
    opt = _opt(changes)
    two_layers = dict(vocab_size=VOCAB, num_hidden_layers=2)
    jspec = JaxModelSpec.from_config(
        JaxConfig(opt), dataclasses.replace(JaxBertConfig.tiny(), **two_layers))
    spec = ModelSpec.from_config(
        Config(opt), dataclasses.replace(BertConfig.tiny(), **two_layers))
    return JaxConfig(opt), jspec, spec


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), tuple(value.shape)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_matches_jax(branch):
    cfg, jspec, spec = _specs(BRANCHES[branch])
    q, ocr, od, _ = make_synthetic_batch(jspec, cfg, 2, seed=0)
    model = JaxRUArtModel(jspec)
    jb = [jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)]
    port = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    params = to_jax_params(port)
    flax_init = jax.eval_shape(model.init, jax.random.PRNGKey(0), *jb)
    assert sorted(_leaves(params["params"])) == sorted(
        _leaves(flax_init["params"]))
    want = np.asarray(jax.jit(model.apply)(
        jax.tree.map(jnp.asarray, params), *jb))
    port.load_state_dict(from_jax_params(params))  # strict: every leaf
    with torch.no_grad():
        got = port.eval()(*({k: torch.from_numpy(np.asarray(v))
                             for k, v in b.items()} for b in (q, ocr, od)))
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_no_conf_branch_is_left_unported():
    """Every branch above, the shipped conf and PHOC build in the port;
    none is refused (PHOC's forward: tests/test_torch_port_phoc.py)."""
    for changes in [{}] + list(BRANCHES.values()):
        spec = _specs(changes)[2]
        assert unported_conf_keys(spec) == []
    spec = _specs({"PHOC": True})[2]
    assert unported_conf_keys(spec) == []
    assert RUArtModel(spec).phoc_embed.weight.shape == (spec.vocab_size, 604)


@pytest.mark.parametrize("conf", sorted(NOT_RUNNABLE))
def test_confs_jax_cannot_run_are_refused(conf):
    cfg, jspec, spec = _specs(NOT_RUNNABLE[conf])
    q, ocr, od, _ = make_synthetic_batch(jspec, cfg, 2, seed=0)
    with pytest.raises((KeyError, UnboundLocalError)):
        jax.eval_shape(
            JaxRUArtModel(jspec).init, jax.random.PRNGKey(0),
            *(jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)),
        )
    with pytest.raises(ValueError):
        RUArtModel(spec)


@pytest.mark.parametrize("way", ["replace_od", "final_att", "fixed_answers"])
def test_engine_with_raw_requests(way):
    """``img_feature``: a raw request carries no image features (the
    engine's featurizer has no provider, in either package): under
    ``replace_od`` both engines fail on the missing ``img_features`` batch
    key; under ``final_att``, which zeroes the OD stream and reads no
    features, both answer alike. ``fixed_answers``: both engines decode
    with the same answer list and answer alike."""
    from ruart_tpu.serve import InferenceEngine as JaxEngine
    from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
    from ruart_tpu.text.wordpiece import build_demo_vocab
    from ruart_tpu_torch import serve
    from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer
    from tests.test_torch_port_slice import _opt as slice_opt
    from tests.test_torch_port_slice import _requests, _vocab

    fixed = [f"fixed {i}" for i in range(7)] if way == "fixed_answers" else None
    opt = slice_opt(dict(fixed_answers=True, fixed_answers_len=7) if fixed
                    else dict(IMG, img_fea_way=way))
    vocab = len(build_demo_vocab())
    jspec = JaxModelSpec.from_config(JaxConfig(opt),
                                     JaxBertConfig.tiny(vocab_size=vocab))
    spec = ModelSpec.from_config(Config(opt), BertConfig.tiny(vocab_size=vocab))
    port = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    jax_engine = JaxEngine(
        JaxConfig(opt), jspec, jax.tree.map(jnp.asarray, to_jax_params(port)),
        _vocab(spec.vocab_size), JaxTokenizer(build_demo_vocab()), fixed)
    engine = serve.InferenceEngine(
        Config(opt), spec, port.state_dict(), _vocab(spec.vocab_size),
        WordPieceTokenizer(build_demo_vocab()), fixed, device="cpu")
    reqs = _requests(3)
    if way == "replace_od":
        for eng in (jax_engine, engine):
            with pytest.raises(KeyError, match="img_features"):
                eng.predict(reqs)
        return
    want, got = jax_engine.predict(reqs), engine.predict(reqs)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["idx"] for r in got] == [r["idx"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=TOL, rtol=0)
