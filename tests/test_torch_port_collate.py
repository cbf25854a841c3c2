"""The port's host copies (featurize -> dataset items -> collate, and the
answer decoder) emit exactly what the JAX package's emit: the same raw
requests give equal arrays key by key (dtype and grid aliasing included)
under each collator layout, and ``decode_batch`` gives equal output."""

import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data.collate import Collator as JaxCollator
from ruart_tpu.data.dataset import VQADataset as JaxDataset
from ruart_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from ruart_tpu.data.synthetic import make_synthetic_raw_dataset as jax_raw
from ruart_tpu.eval.decoder import decode_batch as jax_decode
from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from ruart_tpu.text.wordpiece import build_demo_vocab as jax_demo_vocab
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.eval.decoder import decode_batch
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab

torch.set_num_threads(2)

LAYOUTS = {
    "default": {},
    "dedup-pack": {"bert_dedup_frac": 1.0},
    "dedup-only": {"bert_dedup_frac": 1.0, "bert_pack": 0},
    "dense": {"bert_dedup_frac": 0, "cand_compact": 0, "h2d_narrow": 0},
}


def _opt(extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 4, "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "datadir": ".",
                "FEATURE_FOLDER": "."})
    opt.update(extra)
    return opt


def _collate(pkg, opt, raw):
    """Both packages' preprocess -> vocab -> ids -> dataset -> collate."""
    if pkg == "jax":
        cfg = JaxConfig(opt)
        pre, tok = JaxPreprocessor(cfg), JaxTokenizer(jax_demo_vocab())
        dataset, collator = JaxDataset, JaxCollator
    else:
        cfg = Config(opt)
        pre, tok = Preprocessor(cfg), WordPieceTokenizer(build_demo_vocab())
        dataset, collator = VQADataset, Collator
    data = pre._process_data(raw)
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = dataset(data, cfg, mode="test", tokenizer=tok)
    return pre.train_vocab, collator(cfg)([ds[i] for i in range(len(ds))])


def _raw(seed):
    data = jax_raw(4, seed=seed, n_ocr_range=(3, 9), n_es=6)["data"]
    assert data == make_synthetic_raw_dataset(
        4, seed=seed, n_ocr_range=(3, 9), n_es=6
    )["data"]
    return data


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collated_arrays_equal(layout):
    opt = _opt(LAYOUTS[layout])
    raw = _raw(1)
    j_vocab, (jq, jocr, jod, jgt, jextra) = _collate("jax", opt, raw)
    t_vocab, (tq, tocr, tod, tgt, textra) = _collate("torch", opt, raw)
    assert j_vocab == t_vocab
    for name, jb, tb in (("q", jq, tq), ("ocr", jocr, tocr), ("od", jod, tod)):
        assert sorted(jb) == sorted(tb), name
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, (name, k)
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{name}.{k}")
            for k2 in jb:  # aliased grids stay aliased
                assert (jb[k] is jb[k2]) == (tb[k] is tb[k2]), (name, k, k2)
    np.testing.assert_array_equal(tgt, jgt)
    assert textra == jextra
    if layout == "dedup-pack":
        assert "bert_packed" in tocr and "bert_packed" in tod


def test_decode_batch_equal():
    opt = _opt({})
    raw = _raw(2)
    _, (_, ocr, _, _, extra) = _collate("torch", opt, raw)
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.ones(TINY_OVERRIDES["max_ocr_num"] + 1), size=4)
    probs[1, -1] = 2.0           # the no-answer head wins
    probs[2, int(ocr["num"][2]) - 1] = 2.0   # the <OCR> sentinel is skipped
    for kw in ({"label_no_answer": True}, {"yesno": True}, {}):
        assert decode_batch(probs, extra, ocr["num"], **kw) == jax_decode(
            probs, extra, ocr["num"], **kw
        )
