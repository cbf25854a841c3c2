"""The serving slice end to end: ``InferenceEngine.predict`` of the JAX
package and of the port (device="cpu") on the same requests and the same
weights (flax init -> convert.from_jax_params), at TINY_OVERRIDES and
batch 2, so every request list leaves a padded tail batch. Scores agree
within 1e-5 abs; answers and idx are equal.

The collator layouts vary the model paths the batch takes: packed
question rows fused with dense candidate rows (default at this size),
packed candidate tables with compaction, dedup tables without packing,
dense grids without fusion or compaction, and dense candidate rows wider
than max_position_embeddings (the chunked encoder loop).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.serve import InferenceEngine as JaxEngine
from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from ruart_tpu.text.wordpiece import build_demo_vocab
from ruart_tpu_torch import serve
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer

torch.set_num_threads(2)
TOL = 1e-5

# layout -> (conf overrides, BertConfig overrides, request sets); this
# file runs the first two, test_torch_port_slice_paths.py the rest
LAYOUTS = {
    "default": ({}, {}, ("requests", "synthetic")),
    "packed-compact": ({"bert_dedup_frac": 1.0}, {}, ("requests",)),
    "dedup-only": ({"bert_dedup_frac": 1.0, "bert_pack": 0}, {},
                   ("synthetic",)),
    "dense-unfused": ({"bert_dedup_frac": 0, "cand_compact": 0,
                       "bert_fuse": 0}, {}, ("requests",)),
    "chunked": ({"bert_dedup_frac": 0, "max_ocr_bert_len": 20,
                 "bert_pack_len": 8}, {"max_position_embeddings": 16},
                ("synthetic",)),
}
WORDS = ["<PAD>", "<UNK>", "<Q>", "<OCR>", "<OD>", "stop", "exit", "sign",
         "what", "does", "the", "say"]


def _requests(n):
    """The request shape tests/test_serve.py uses."""
    return [
        {
            "question": f"what does the sign {i} say",
            "image_width": 640,
            "image_height": 480,
            "ocr": [
                {"word": "stop", "pos": [10, 10, 60, 10, 60, 30, 10, 30]},
                {"word": "exit", "pos": [100, 10, 150, 10, 150, 30, 100, 30]},
            ],
            "od": [{"object": "sign", "pos": [320, 240, 100, 60]}],
        }
        for i in range(n)
    ]


def _synthetic(n):
    raw = make_synthetic_raw_dataset(n, seed=3, n_ocr_range=(3, 9), n_es=6,
                                     with_answers=False)["data"]
    return [
        {"question": d["question"], "image_width": d["image_width"],
         "image_height": d["image_height"], "ocr": d["ocr_PMTD_ASTER"],
         "od": d["OD_bottom-up"], "es": d["ES_ocr"]}
        for d in raw
    ]


def _opt(extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 2, "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "datadir": ".",
                "FEATURE_FOLDER": "."})
    opt.update(extra)
    return opt


VOCAB_SIZE = len(build_demo_vocab())


@pytest.fixture(scope="module")
def flax_params():
    return shared_flax_params()


@functools.lru_cache(maxsize=None)
def shared_flax_params():
    """One flax init for every layout (the layouts change no parameter
    shape but the position table, which the chunked layout cuts), made
    once per process: every test file that takes the ``flax_params``
    fixture from here shares it, and only reads it."""
    cfg = JaxConfig(_opt({}))
    spec = JaxModelSpec.from_config(cfg, JaxBertConfig.tiny(vocab_size=VOCAB_SIZE))
    q, ocr, od, _ = make_synthetic_batch(spec, cfg, 2, seed=0)
    params = jax.jit(JaxRUArtModel(spec).init)(
        jax.random.PRNGKey(0),
        *(jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)),
    )
    return jax.tree.map(np.asarray, params)


def _vocab(n):
    return WORDS + [f"w{i}" for i in range(len(WORDS), n)]


def _jax_engine(opt, bert_extra, params):
    cfg = JaxConfig(opt)
    spec = JaxModelSpec.from_config(
        cfg, JaxBertConfig.tiny(vocab_size=VOCAB_SIZE, **bert_extra)
    )
    return JaxEngine(cfg, spec, jax.tree.map(jnp.asarray, params),
                     _vocab(spec.vocab_size), JaxTokenizer(build_demo_vocab()))


def _port_engine(opt, bert_extra, state_dict=None):
    cfg = Config(opt)
    spec = ModelSpec.from_config(
        cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE, **bert_extra)
    )
    if state_dict is None:
        state_dict = RUArtModel(spec).init_weights(
            torch.Generator().manual_seed(0)
        ).state_dict()
    return serve.InferenceEngine(
        cfg, spec, state_dict, _vocab(spec.vocab_size),
        WordPieceTokenizer(build_demo_vocab()), device="cpu",
    )


def check_predict_matches_jax(layout, flax_params):
    opt_extra, bert_extra, request_sets = LAYOUTS[layout]
    params = flax_params
    if "max_position_embeddings" in bert_extra:
        params = jax.tree.map(lambda x: x, params)  # copy the containers
        table = params["params"]["Bert"]["embeddings"]["position_embeddings"]
        table["embedding"] = table["embedding"][:bert_extra[
            "max_position_embeddings"]]
    opt = _opt(opt_extra)
    jax_engine = _jax_engine(opt, bert_extra, params)
    port_engine = _port_engine(opt, bert_extra, from_jax_params(params))
    for name in request_sets:
        reqs = _requests(3) if name == "requests" else _synthetic(5)
        want = jax_engine.predict(reqs)
        got = port_engine.predict(reqs)
        assert len(got) == len(reqs)
        assert [r["answer"] for r in got] == [r["answer"] for r in want]
        assert [r["idx"] for r in got] == [r["idx"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["default", "packed-compact"])
def test_predict_matches_jax(layout, flax_params):
    check_predict_matches_jax(layout, flax_params)


def test_layouts_reach_their_paths():
    """The layouts above take the model paths they are named for."""
    seen = {}
    for layout in ("packed-compact", "dedup-only", "chunked"):
        opt_extra, bert_extra, request_sets = LAYOUTS[layout]
        engine = _port_engine(_opt(opt_extra), bert_extra)
        reqs = _requests(2) if "requests" in request_sets else _synthetic(2)
        _, _, (q, ocr, od, _, _) = next(engine._collated_batches(reqs))
        seen[layout] = ocr
    assert {"bert_packed", "cand_sel"} <= set(seen["packed-compact"])
    assert "bert_unique" in seen["dedup-only"]
    assert "bert_packed" not in seen["dedup-only"]
    assert "bert_unique" not in seen["chunked"]
    assert seen["chunked"]["bert"].shape[-1] == 20  # > 16 positions


def test_tail_batch_repeats_its_last_item():
    engine = _port_engine(_opt({}), {})
    batches = list(engine._collated_batches(_requests(3)))
    assert [(start, n) for start, n, _ in batches] == [(0, 2), (2, 1)]
    q = batches[1][2][0]
    np.testing.assert_array_equal(q["glove"][0], q["glove"][1])


def test_no_card_and_no_device_raises(monkeypatch):
    """Without a card the engine runs only when the caller asks for the
    CPU: there is no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.resolve_device(None)
    assert serve.resolve_device("cpu") == torch.device("cpu")


def test_out_of_range_index_is_refused_on_the_host():
    engine = _port_engine(_opt({}), {})
    _, _, (q, ocr, od, _, _) = next(engine._collated_batches(_requests(2)))
    bad = dict(ocr)
    bad["glove"] = bad["glove"].copy()
    bad["glove"][0, 0, 0] = engine.spec.vocab_size
    with pytest.raises(ValueError, match="glove"):
        engine.to_device(bad)
