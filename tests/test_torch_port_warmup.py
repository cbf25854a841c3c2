"""Serving warmup of the port against the JAX package's.

The JAX engine compiles one XLA program per batch signature in
``warmup``/``warmup_calibrated``; the port runs the model once on each of
the same signatures. Here the JAX engine's ``eval_step`` is replaced by a
recorder of (key, shape, dtype) signatures, so nothing compiles, and the
port's ``_warm_step`` records the same and then runs the model (so every
warmed signature is also run through the port's forward). Both packages
must enumerate the same list in the same order and return the same
counts, for the full cross product, a truncated one and a calibrated
sample, under the default layouts, ``bucket_ocr_num 2`` and dedup tables
without packing. ``make_synthetic_batch``, which the signatures are built
from, must be byte-equal to the JAX function's.
"""

import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.data.synthetic import make_synthetic_batch as jax_make_synthetic_batch
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from test_torch_port_slice import (  # noqa: F401
    VOCAB_SIZE,
    _jax_engine,
    _opt,
    _port_engine,
    _synthetic,
    flax_params,
)

torch.set_num_threads(2)

LAYOUTS = {
    "default": {},
    "bucket_ocr_num": {"bucket_ocr_num": 2},
    "dedup-only": {"bert_dedup_frac": 1.0, "bert_pack": 0},
}


def _signature(blocks):
    return tuple(
        tuple((k, tuple(v.shape), str(np.asarray(v).dtype))
              for k, v in sorted(block.items()))
        for block in blocks
    )


def _recording_engines(layout, params):
    opt = _opt(LAYOUTS[layout])
    jax_engine = _jax_engine(opt, {}, params)
    port_engine = _port_engine(opt, {}, from_jax_params(params))
    jax_sigs, port_sigs = [], []

    def jax_step(params, q, ocr, od, targets):
        jax_sigs.append(_signature((q, ocr, od)))
        return None, None

    real_step = port_engine._warm_step

    def port_step(q, ocr, od):
        port_sigs.append(_signature((q, ocr, od)))
        real_step(q, ocr, od)

    jax_engine.eval_step = jax_step
    port_engine._warm_step = port_step
    return jax_engine, port_engine, jax_sigs, port_sigs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_warmup_signatures_match_jax(layout, flax_params):
    jax_engine, port_engine, jax_sigs, port_sigs = _recording_engines(
        layout, flax_params)
    runs = [
        ("warmup", lambda e: e.warmup()),
        ("warmup(max_programs=3)", lambda e: e.warmup(max_programs=3)),
        ("warmup_calibrated", lambda e: e.warmup_calibrated(_synthetic(5))),
    ]
    for name, run in runs:
        del jax_sigs[:], port_sigs[:]
        want, got = run(jax_engine), run(port_engine)
        assert got == want == len(jax_sigs), name
        assert port_sigs == jax_sigs, name
        if name == "warmup_calibrated":
            assert len(set(port_sigs)) == len(port_sigs)  # deduplicated
    assert want >= 2  # >= 1 observed signature + the dense panic signature


def test_warmup_then_predict(flax_params):
    """One real port warmup(max_programs=2) runs the model, and predict
    afterwards gives the answers and scores of a fresh engine."""
    opt = _opt({})
    reqs = _synthetic(5)
    want = _port_engine(opt, {}, from_jax_params(flax_params)).predict(reqs)
    engine = _port_engine(opt, {}, from_jax_params(flax_params))
    assert engine.warmup(max_programs=2) == 2
    assert engine.predict(reqs) == want


OVERRIDES = [
    {},
    {"seed": 5, "ocr_num": 4, "ocr_bert_len": 8},
    {"seed": 1, "q_bert_len": 8, "ocr_word_len": 3, "od_word_len": 2},
    {"seed": 2, "bert_vocab": 40, "ocr_num": 3},
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: str(sorted(o)))
def test_make_synthetic_batch_is_byte_equal(overrides):
    opt = _opt({})
    jax_cfg, cfg = JaxConfig(dict(opt)), Config(dict(opt))
    jax_spec = JaxModelSpec.from_config(jax_cfg, JaxBertConfig.tiny(vocab_size=VOCAB_SIZE))
    spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE))
    want = jax_make_synthetic_batch(jax_spec, jax_cfg, 3, **overrides)
    got = make_synthetic_batch(spec, cfg, 3, **overrides)
    for w, g in zip(want[:3], got[:3]):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    assert got[3].tobytes() == want[3].tobytes()
