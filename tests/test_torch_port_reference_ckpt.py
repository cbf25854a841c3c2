"""The reference's SDNet ``.pt`` checkpoint in the port
(``ruart_tpu_torch.models.fusion.convert``, ``models.bert.convert``)
against the JAX package's loaders, and the trainer's ``fixed_answers`` and
``img_feature`` inputs against the JAX trainer's.

The checkpoint is written here from seeded weights in the reference's
naming: the fusion stack through the JAX package's
``params_to_torch_state``, the BERT encoder under ``Bert.bert_model.*``
with the 2018 names (LayerNorm gamma/beta), the dead GRU pointer cell and
a ``do_similarity`` diagonal beside them, saved as ``{'state_dict':
{'network': ...}}`` with ``torch.save``. Conf: the shipped one at
TINY_OVERRIDES with ``fixed_answers`` and ``ES_using_way post_process``
(so ``fixed_ocr_alpha``, ``fixed_ans_classifier``, ``ES_linear`` and
``ES_ocr_att`` are in the file) and a two-layer tiny BERT. Forwards of the
two packages from the loaded weights agree within 1e-5 abs.
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
from ruart_tpu.data.collate import Collator as JaxCollator
from ruart_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion import convert as jax_convert
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from ruart_tpu.text.wordpiece import build_demo_vocab as jax_demo_vocab
from ruart_tpu.train.checkpoint import flatten_tree
from ruart_tpu.train.trainer import Trainer as JaxTrainer
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.bert.convert import load_bert_params
from ruart_tpu_torch.models.fusion import convert
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = 64
EXTRA = {"fixed_answers": True, "fixed_answers_len": 7,
         "ES_using_way": "post_process"}
MISSING = "ques_merger.linear.weight"
RESHAPED = "get_answer.attn.linear.weight"


def _opt(**extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update(EXTRA)
    opt.update(extra)
    return opt


def _specs():
    two_layers = dict(vocab_size=VOCAB, num_hidden_layers=2)
    opt = _opt()
    return (JaxConfig(opt),
            JaxModelSpec.from_config(JaxConfig(opt), dataclasses.replace(
                JaxBertConfig.tiny(), **two_layers)),
            ModelSpec.from_config(Config(opt), dataclasses.replace(
                BertConfig.tiny(), **two_layers)))


def _bert_reference_names(tree):
    """A flax ``Bert`` subtree under the reference's torch names."""
    out = {}

    def dense(torch_name, node):
        out[torch_name + ".weight"] = node["kernel"].T
        out[torch_name + ".bias"] = node["bias"]

    def norm(torch_name, node):
        out[torch_name + ".gamma"] = node["scale"]
        out[torch_name + ".beta"] = node["bias"]

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embeddings.{name}.weight"] = tree["embeddings"][name]["embedding"]
    norm("embeddings.LayerNorm", tree["embeddings"]["LayerNorm"])
    dense("pooler.dense", tree["pooler_dense"])
    layers = sorted(k for k in tree if k.startswith("layer_"))
    for i in range(len(layers)):
        node, p = tree[f"layer_{i}"], f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            dense(p + "attention.self." + name, node["attention_self"][name])
        dense(p + "attention.output.dense", node["attention_output_dense"])
        norm(p + "attention.output.LayerNorm",
             node["attention_output_LayerNorm"])
        dense(p + "intermediate.dense", node["intermediate_dense"])
        dense(p + "output.dense", node["output_dense"])
        norm(p + "output.LayerNorm", node["output_LayerNorm"])
    return {"Bert.bert_model." + k: v for k, v in out.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(seeded flax params, batch, checkpoint path)."""
    cfg, jspec, _ = _specs()
    batch = make_synthetic_batch(jspec, cfg, 2, seed=0)[:3]
    shapes = jax.eval_shape(
        JaxRUArtModel(jspec).init, jax.random.PRNGKey(0),
        *(jax.tree.map(jnp.asarray, t) for t in batch))
    rng = np.random.RandomState(7)
    params = jax.tree.map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
    network = dict(jax_convert.params_to_torch_state(params))
    network.update(_bert_reference_names(params["params"]["Bert"]))
    network["get_answer.rnn.weight_ih"] = np.zeros((3, 3), np.float32)
    network["pre_align.scoring.diagonal"] = np.full((1, 1, 1), 0.25, np.float32)
    path = tmp_path_factory.mktemp("ref") / "best_model.pt"
    torch.save({"state_dict": {"network": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in network.items()
    }}}, path)
    return params, batch, path, network


def _jax_load(path, init):
    return jax_convert.load_sdnet_checkpoint(str(path), init)


def _jax_scores(params, batch):
    jspec = _specs()[1]
    return np.asarray(jax.jit(JaxRUArtModel(jspec).apply)(
        jax.tree.map(jnp.asarray, params),
        *(jax.tree.map(jnp.asarray, t) for t in batch)))


def _port_init(seed=1):
    return RUArtModel(_specs()[2]).init_weights(torch.Generator().manual_seed(seed))


def _port_scores(model, batch):
    with torch.no_grad():
        return model.eval()(*({k: torch.from_numpy(np.asarray(v))
                               for k, v in b.items()} for b in batch)).numpy()


def test_checkpoint_loads_into_both_packages(case):
    params, batch, path, _ = case
    # the JAX loader over a zero tree: every leaf must come from the file
    zeros = jax.tree.map(np.zeros_like, params)
    loaded = _jax_load(path, zeros)
    for key, value in flatten_tree(params["params"]).items():
        np.testing.assert_array_equal(
            flatten_tree(loaded["params"])[key], value, err_msg=key)
    model = convert.load_sdnet_checkpoint(str(path), _port_init())
    want = from_jax_params(params)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    np.testing.assert_allclose(_port_scores(model, batch),
                               _jax_scores(loaded, batch), atol=TOL, rtol=0)


def test_export_gives_the_reference_names(case):
    params, _, path, network = case
    model = convert.load_sdnet_checkpoint(str(path), _port_init())
    got = convert.params_to_torch_state(model)
    want = jax_convert.params_to_torch_state(params)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # the converter drops the dead GRU cell and the frozen diagonal
    converted = convert.convert_sdnet_state_dict(network)
    assert not any(k.startswith("get_answer.rnn") for k in converted)
    assert "pre_align.scoring.diagonal" not in converted


def test_missing_and_misshapen_keys_keep_their_initial_values(case, tmp_path):
    params, _, path, network = case
    network = dict(network)
    del network[MISSING]
    network[RESHAPED] = np.zeros((3, 5), np.float32)
    bad = tmp_path / "bad.pt"
    torch.save({"state_dict": {"network": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in network.items()
    }}}, bad)
    init = _port_init()
    before = {k: v.clone() for k, v in init.state_dict().items()}
    model = convert.load_sdnet_checkpoint(str(bad), init)
    want = from_jax_params(params)
    jax_init = jax.tree.map(lambda x: np.full_like(x, 0.5), params)
    loaded = flatten_tree(_jax_load(bad, jax_init)["params"])
    for key in (MISSING, RESHAPED):
        assert torch.equal(model.state_dict()[key], before[key]), key
        flax_key = key.replace(".", "/").replace("/weight", "/kernel")
        assert (loaded[flax_key] == 0.5).all(), flax_key
    other = "get_answer.attn.linear.bias"
    assert torch.equal(model.state_dict()[other], want[other])


def test_load_bert_params(case, tmp_path):
    """A BERT directory (bert_config.json + pytorch_model.bin, 2018 names)
    -> the config and the ``Bert.*`` entries, as the trainer loads it."""
    params = case[0]["params"]
    names = _bert_reference_names(params["Bert"])
    torch.save({k[len("Bert.bert_model."):]: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in names.items()},
        tmp_path / "pytorch_model.bin")
    (tmp_path / "bert_config.json").write_text(
        '{"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2, '
        '"num_attention_heads": 4, "intermediate_size": 64}')
    config, state = load_bert_params(str(tmp_path))
    assert (config.num_hidden_layers, config.hidden_size) == (2, 32)
    want = {k: v for k, v in from_jax_params({"Bert": params["Bert"]}).items()}
    assert sorted(state) == sorted(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key


def _write_inputs(root):
    """Answer list, labels and per-image npy features under ``root``, and
    the preprocessed items they go with (one image file per item)."""
    fixed = root / "fixed"
    fixed.mkdir()
    answers = [f"answer {i}" for i in range(6)]
    (fixed / "fixed_answers_4000.txt").write_text("\n".join(answers) + "\n")
    with open(fixed / "TRAIN_VAL_fixed_answers_label.msgpack", "wb") as f:
        msgpack.pack({"labels": [0.0, 1.0, 0.0, 0.5, 0.0, 0.0]}, f)
    feats = root / "feats" / "train"
    feats.mkdir(parents=True)
    rng = np.random.RandomState(11)
    raw = make_synthetic_raw_dataset(3, seed=4, n_ocr_range=(3, 6), n_es=4)
    opt = _opt(fixed_answers_folder=str(fixed),
               img_fea_folder=str(root / "feats"), img_feature=True,
               img_fea_way="replace_od", img_fea_num=4, img_fea_dim=8,
               datadir=str(root), FEATURE_FOLDER=str(root),
               preprocess_ocr_name="ocr_PMTD_ASTER,ES_ocr",
               preprocess_od_name="OD_bottom-up")
    opt.pop("fixed_answers_len")
    pre = JaxPreprocessor(JaxConfig(opt))
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    for i, datum in enumerate(data):
        datum["filename"] = f"img_{i}.jpg"
        np.save(feats / f"img_{i}.npy", rng.rand(4, 8).astype(np.float32))
        np.save(feats / f"img_{i}_info.npy", {
            "bbox": rng.rand(4, 4).astype(np.float32) * 100,
            "image_width": 200, "image_height": 100}, allow_pickle=True)
    return opt, {"data": data}


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), where)
    else:
        assert a == b, where


def test_trainer_builds_the_jax_items_and_labels(tmp_path):
    opt, split = _write_inputs(tmp_path)
    jax_trainer = JaxTrainer(JaxConfig(dict(opt)),
                             bert_config=JaxBertConfig.tiny(vocab_size=VOCAB))
    trainer = Trainer(Config(dict(opt)), BertConfig.tiny(vocab_size=VOCAB),
                      device="cpu")
    assert trainer.fixed_answers == jax_trainer.fixed_answers
    assert trainer.opt["fixed_answers_len"] == 6
    jax_trainer.tokenizer = JaxTokenizer(jax_demo_vocab())
    trainer.tokenizer = WordPieceTokenizer(build_demo_vocab())
    want = jax_trainer._dataset(split, "train")
    got = trainer._dataset(split, "train")
    items = [got[i] for i in range(len(got))]
    _same(items, [want[i] for i in range(len(want))])
    assert items[0]["q"]["img_features"].shape == (4, 8)
    assert items[0]["gt"]["values"][:6] == [0.0, 1.0, 0.0, 0.5, 0.0, 0.0]
    _same(Collator(trainer.cfg)(items)[:4],
          JaxCollator(jax_trainer.cfg)(items)[:4])
