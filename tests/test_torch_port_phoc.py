"""PHOC in the port against the JAX package, on the CPU: the native host
encoder (``text/phoc.py`` over ``native/phoc.cc``), the tensor op
(``ops/phoc.py``), the preprocessor's ``phoc_embedding`` meta, the
trainer's ``fixed_answers_phoc`` and the ``PHOC`` conf branch of the model
and the serving engine.

Words are drawn with numpy from a seed over letters of both cases,
digits, punctuation, spaces and non-ASCII letters, with empty words and
words that filter to nothing; the 3-letter words are the knife-edge ones
(1/6 overlaps that round just under 0.5 in float32). Vectors, tables and
meta files are compared byte for byte; forwards within 1e-5 abs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.model import install_embeddings as jax_install
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.ops import phoc as jax_ops_phoc
from ruart_tpu.serve import InferenceEngine as JaxEngine
from ruart_tpu.text import phoc as jax_phoc
from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from ruart_tpu.text.wordpiece import build_demo_vocab
from ruart_tpu.train.trainer import Trainer as JaxTrainer
from ruart_tpu_torch import serve
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import (
    RUArtModel,
    install_embeddings,
    unported_conf_keys,
)
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.native import build
from ruart_tpu_torch.ops import phoc as ops_phoc
from ruart_tpu_torch.text import phoc
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer
from ruart_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = 64
PHOC_CONF = {"PHOC": True, "ocr_embedding": "phoc,fasttext,pos,ent,bert"}
POOL = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
            "-'.,!? éßü")


def _words(n=400, seed=0):
    rng = np.random.RandomState(seed)
    words = ["".join(rng.choice(POOL, rng.randint(0, 14))) for _ in range(n)]
    three = ["".join(rng.choice(POOL[:36], 3)) for _ in range(60)]
    return words + three + ["", "   ", "?!", "the", "The", "é", "thé",
                            "x" * 40, "<PAD>", "<UNK>", "<OCR>"]


def test_native_build_is_atomic_and_kept(monkeypatch, tmp_path):
    """The library is built into _build/ at first use, kept while it is
    newer than its source, and rebuilt with force through a temporary
    file renamed into place (in a build folder of its own here, so no
    other test process builds beside it: only the library is left)."""
    assert build.PHOC_LIBRARY.parent == build.BUILD_DIR
    assert build.BUILD_DIR.name == "_build"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "PHOC_LIBRARY",
                        tmp_path / "_build" / build.PHOC_LIBRARY.name)
    path = build.ensure_built()
    assert path == str(build.PHOC_LIBRARY) and os.path.isfile(path)
    mtime = os.stat(path).st_mtime_ns
    assert build.ensure_built() == path
    assert os.stat(path).st_mtime_ns == mtime
    build.ensure_built(force=True)
    assert os.stat(path).st_mtime_ns != mtime
    assert os.listdir(tmp_path / "_build") == [build.PHOC_LIBRARY.name]


def test_phoc_vectors_byte_equal():
    words = _words()
    got = phoc.build_phoc_batch(words)
    assert got.shape == (len(words), 604) and got.dtype == np.float32
    want = jax_phoc.build_phoc_batch(words)
    assert got.tobytes() == want.tobytes()
    oracle = np.stack([phoc.build_phoc_py(w) for w in words])
    assert got.tobytes() == oracle.tobytes()
    assert oracle.tobytes() == np.stack(
        [jax_phoc.build_phoc_py(w) for w in words]).tobytes()
    for w in words[:50] + words[-11:]:
        assert phoc.build_phoc(w).tobytes() == jax_phoc.build_phoc(w).tobytes()
    assert phoc.build_phoc_embedding(words[:7]).tobytes() == \
        jax_phoc.build_phoc_embedding(words[:7]).tobytes()
    assert phoc.build_phoc_batch([]).shape == (0, 604)
    assert not got[len(words) - 9].any()  # "?!" filters to nothing


@pytest.mark.parametrize("max_len", [5, 16])
def test_phoc_op_byte_equal(max_len):
    """The tensor op on the CPU, JAX's op, and the native encoder of the
    truncated words give the same bytes; batch axes are kept."""
    words = _words(seed=1)
    ids, lengths = ops_phoc.encode_char_ids(words, max_len)
    j_ids, j_lengths = jax_ops_phoc.encode_char_ids(words, max_len)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(lengths, j_lengths)
    got = ops_phoc.phoc_from_char_ids(torch.from_numpy(ids),
                                      torch.from_numpy(lengths)).numpy()
    want = np.asarray(jax_ops_phoc.phoc_batch_jit(jnp.asarray(ids),
                                                  jnp.asarray(lengths)))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    native = phoc.build_phoc_batch([phoc.filter_token(w)[:max_len]
                                    for w in words])
    assert got.tobytes() == native.tobytes()
    n = 2 * (len(words) // 2)
    grid = ops_phoc.phoc_from_char_ids(
        torch.from_numpy(ids[:n].reshape(2, -1, max_len)),
        torch.from_numpy(lengths[:n].reshape(2, -1)))
    assert grid.shape == (2, n // 2, 604)
    assert grid.reshape(n, 604).numpy().tobytes() == got[:n].tobytes()


def _opt(**extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update(PHOC_CONF)
    opt.update(extra)
    return opt


def test_preprocess_meta_byte_equal(tmp_path):
    raw = make_synthetic_raw_dataset(6, seed=2, n_ocr_range=(3, 9), n_es=6)
    files = {}
    for pkg, cfg_cls, pre_cls in (("jax", JaxConfig, JaxPreprocessor),
                                  ("torch", Config, Preprocessor)):
        folder = tmp_path / pkg
        folder.mkdir()
        pre = pre_cls(cfg_cls(_opt(datadir=str(tmp_path),
                                   FEATURE_FOLDER=str(folder))))
        pre._build_and_save_meta(pre._process_data(raw["data"]))
        files[pkg] = (folder / "train_meta.msgpack").read_bytes()
    assert files["torch"] == files["jax"]
    meta = msgpack.unpackb(files["torch"], raw=False)
    table = np.asarray(meta["phoc_embedding"], np.float32)
    assert table.shape == (len(meta["vocab"]), 604) and table.any()


def test_trainer_fixed_answers_phoc(tmp_path):
    answers = _words(40, seed=3)
    answers = [a.strip().lower() for a in answers if a.strip()]
    (tmp_path / "fixed_answers_4000.txt").write_text("\n".join(answers) + "\n")
    opt = _opt(fixed_answers=True, fixed_answers_folder=str(tmp_path),
               datadir=str(tmp_path), FEATURE_FOLDER=str(tmp_path))
    want = JaxTrainer(JaxConfig(dict(opt)),
                      bert_config=JaxBertConfig.tiny(vocab_size=VOCAB))
    got = Trainer(Config(dict(opt)), BertConfig.tiny(vocab_size=VOCAB),
                  device="cpu")
    a = got.fixed_answers_entry["fixed_answers_phoc"]
    b = want.fixed_answers_entry["fixed_answers_phoc"]
    assert a.shape == (len(got.fixed_answers), 604)
    assert a.tobytes() == b.tobytes()
    without = dict(opt, ocr_embedding="fasttext,pos,ent,bert")
    assert Trainer(Config(without), BertConfig.tiny(vocab_size=VOCAB),
                   device="cpu").fixed_answers_entry["fixed_answers_phoc"] is None


def _specs(opt):
    two = dict(vocab_size=VOCAB, num_hidden_layers=2)
    jspec = JaxModelSpec.from_config(
        JaxConfig(opt), dataclasses.replace(JaxBertConfig.tiny(), **two))
    spec = ModelSpec.from_config(
        Config(opt), dataclasses.replace(BertConfig.tiny(), **two))
    return jspec, spec


def test_phoc_forward_matches_jax():
    """The PHOC branch: a [vocab, 604] table from the native encoder, the
    candidates' ``phoc`` grid the word ids (as the dataset makes it)."""
    opt = _opt()
    jspec, spec = _specs(opt)
    assert spec.use_phoc and unported_conf_keys(spec) == []
    q, ocr, od, _ = make_synthetic_batch(jspec, JaxConfig(opt), 2, seed=0)
    for block in (ocr, od):  # the candidate blocks read ocr_embedding
        block["phoc"] = block["glove"]
    table = phoc.build_phoc_embedding([f"w{i}" for i in range(spec.vocab_size)])
    port = install_embeddings(
        RUArtModel(spec).init_weights(torch.Generator().manual_seed(0)),
        phoc=table)
    assert port.phoc_embed.weight.shape == (spec.vocab_size, 604)
    params = jax.tree.map(jnp.asarray, to_jax_params(port))
    jb = [jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)]
    want = np.asarray(jax.jit(JaxRUArtModel(jspec).apply)(params, *jb))
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port.eval()(*({k: torch.from_numpy(np.asarray(v))
                             for k, v in b.items()} for b in (q, ocr, od)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jax_params = jax_install(params, phoc=table)
    assert np.asarray(jax_params["params"]["phoc_embed"]["embedding"]).tobytes() \
        == port.phoc_embed.weight.detach().numpy().tobytes()


def test_phoc_engine_matches_jax():
    """Raw requests through both serving engines under PHOC (the dataset
    adds the ``phoc`` grid, the collator aliases it to the word ids)."""
    from tests.test_torch_port_slice import _opt as slice_opt
    from tests.test_torch_port_slice import _requests, _vocab

    opt = slice_opt(PHOC_CONF)
    vocab = len(build_demo_vocab())
    jspec = JaxModelSpec.from_config(JaxConfig(opt),
                                     JaxBertConfig.tiny(vocab_size=vocab))
    spec = ModelSpec.from_config(Config(opt), BertConfig.tiny(vocab_size=vocab))
    words = _vocab(spec.vocab_size)
    port = install_embeddings(
        RUArtModel(spec).init_weights(torch.Generator().manual_seed(1)),
        phoc=phoc.build_phoc_embedding(words))
    jax_engine = JaxEngine(
        JaxConfig(opt), jspec, jax.tree.map(jnp.asarray, to_jax_params(port)),
        words, JaxTokenizer(build_demo_vocab()))
    engine = serve.InferenceEngine(
        Config(opt), spec, port.state_dict(), words,
        WordPieceTokenizer(build_demo_vocab()), device="cpu")
    reqs = _requests(3)
    want, got = jax_engine.predict(reqs), engine.predict(reqs)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=TOL, rtol=0)


def test_phoc_table_splits_over_tp():
    """Under tp the PHOC table is split by rows like the glove/fast tables
    (the JAX rule ``(glove|fast|phoc)_embed/embedding -> P('tp', None)``):
    a tp-2 rank holds its half of the rows, the shard of the full table."""
    from ruart_tpu.parallel.mesh import param_pspec as jax_param_pspec
    from ruart_tpu_torch.parallel.mesh import Mesh, shard_params

    _, spec = _specs(_opt())
    full = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    assert tuple(jax_param_pspec("phoc_embed/embedding")) == ("tp", None)
    mesh = Mesh.local(1, 2, tp_rank=1)
    rank = RUArtModel(spec, mesh)
    assert rank.phoc_embed.weight.shape == (spec.vocab_size // 2, 604)
    assert rank.phoc_embed.vocab_start == spec.vocab_size // 2
    local = shard_params(full.state_dict(), mesh,
                         heads=spec.bert.num_attention_heads)
    rank.load_state_dict(local)
    torch.testing.assert_close(rank.phoc_embed.weight,
                               full.phoc_embed.weight[spec.vocab_size // 2:],
                               rtol=0, atol=0)
