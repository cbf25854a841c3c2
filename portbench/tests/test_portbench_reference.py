"""The frozen reference against the port, at a tiny size on the CPU: the
same weights from a seed, the same collated batches, the same scores, and
the same first train steps."""

import numpy as np
import pytest
import torch

from portbench import build, check, corpus
from portbench.tests import tiny


def port_side(config):
    from ruart_tpu_torch.core.config import Config, read_conf_lines
    from ruart_tpu_torch.data.collate import Collator
    from ruart_tpu_torch.data.dataset import VQADataset
    from ruart_tpu_torch.data.preprocess import Preprocessor
    from ruart_tpu_torch.models.bert.config import BertConfig
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab

    cfg = Config(read_conf_lines(build.conf_lines(config, {"batch_size": 4})))
    raw = corpus.make_items(8, 3, tiny.TINY_CORPUS, with_answers=True)
    pre = Preprocessor(cfg)
    data = pre._process_data(raw)
    pre.train_vocab = pre._build_vocab(data)
    pre.train_char_vocab = pre._build_char_vocab(pre.train_vocab)
    pre._assign_ids(data)
    cfg.opt["vocab_size"] = len(pre.train_vocab)
    tok = WordPieceTokenizer(build_demo_vocab())
    bert = BertConfig(**dict(config["bert"], vocab_size=max(
        config["bert"]["vocab_size"], len(tok.vocab))))
    spec = ModelSpec.from_config(cfg, bert)
    model = build.make_weights(RUArtModel(spec), 9)
    ds = VQADataset(data, cfg, mode="train", tokenizer=tok)
    batch = Collator(cfg)([ds[i] for i in range(4)])
    return raw, model, batch


def ref_side(config, raw):
    ref = check.Reference(config, {"batch_size": 4}, "cpu", 9)
    ds = ref.featurize(raw, raw, "train")
    ref.build_model()
    return ref, ref.collate([ds[i] for i in range(4)])


@pytest.mark.parametrize("name", ["stvqa-fp32"])
def test_reference_matches_the_port(name):
    config = tiny.config(name)
    raw, model, batch = port_side(config)
    ref, ref_batch = ref_side(config, raw)
    port_params = dict(model.named_parameters())
    ref_params = dict(ref.model.named_parameters())
    assert sorted(port_params) == sorted(ref_params)
    for n, p in port_params.items():
        assert torch.equal(p, ref_params[n]), n
    for a, b in zip(batch[:3], ref_batch[:3]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    with torch.no_grad():
        model.eval()
        port = model(*({k: torch.as_tensor(np.ascontiguousarray(v))
                        for k, v in blk.items()} for blk in batch[:3]))
    got = ref.scores(ref_batch)
    assert np.abs(port.numpy() - got).max() < 1e-6


def test_fill_rules_follow_the_ports_init():
    from portbench.build import _rules

    config = tiny.config("stvqa-fp32")
    _raw, model, _batch = port_side(config)
    model.init_weights(torch.Generator().manual_seed(0))
    for name, p, rule, scale in _rules(model):
        if rule == "fill":
            assert torch.all(p == scale), name
        elif rule == "uniform":
            assert p.abs().max() <= scale + 1e-7, name


def test_train_steps_match_the_port():
    from portbench import harness

    line, out = harness.local(
        "stvqa-fp32.train-b16", 21, 0.3, config=tiny.config("stvqa-fp32"),
        traffic=tiny.traffic("train-b16", **tiny.TRAIN))
    for name, (value, _limit) in out.compared.items():
        assert value < 1e-5, (name, value)
