"""INT8_BERT in the port against the JAX package (``ruart_tpu/ops/quant.py``):

* ``quantize_weight`` gives int8 weights and scales bit-equal to the JAX
  function's (flax kernels are [in, out], torch weights [out, in]; the
  scale is per output channel in both): seeded weights, an all-zero output
  channel (scale 1.0) and values at exact .5 ties (half-to-even in both);
* ``QuantLinear`` matches ``QuantDense`` within 1e-5;
* the port's ``quantize_bert_params`` of ``from_jax_params(fp32)`` equals
  ``from_jax_params`` of the JAX package's quantized tree bit for bit, and
  ``to_jax_params`` maps a quantized model back to the JAX tree;
* ``InferenceEngine.quantize()`` in both packages on the same requests:
  scores within 1e-5, answers and idx equal; a second quantize changes
  nothing;
* ``predict_for_test`` under INT8_BERT gives the JAX trainer's answers from
  one checkpoint written by the JAX package (tiny BERT, TINY_OVERRIDES).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from ruart_tpu.cli.main import build_config as jax_build_config
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.ops.quant import QuantDense
from ruart_tpu.ops.quant import quantize_bert_params as jax_quantize_bert_params
from ruart_tpu.ops.quant import quantize_weight as jax_quantize_weight
from ruart_tpu.train import checkpoint as jax_ckpt
from ruart_tpu.train.trainer import Trainer as JaxTrainer
from ruart_tpu_torch.cli import main as port_main
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops.quant import QuantLinear, quantize_bert_params, quantize_weight
from ruart_tpu_torch.text.wordpiece import build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer
from test_torch_port_slice import (  # noqa: F401
    _jax_engine,
    _opt,
    _port_engine,
    _requests,
    _synthetic,
    flax_params,
)

torch.set_num_threads(2)
TOL = 1e-5
N_TEST = 5


def _weight(case):
    rng = np.random.RandomState(0)
    w = rng.randn(24, 40).astype(np.float32) * 0.05  # flax [in, out]
    if case == "zero-channel":
        w[:, 7] = 0.0
    elif case == "ties":
        # amax 127 in every channel -> scale 1.0 exactly; w / scale lands on
        # x.5, which half-to-even sends to the even neighbour
        w = np.round(rng.uniform(-100, 100, (24, 40))).astype(np.float32) + 0.5
        w[0] = 127.0
    return w


@pytest.mark.parametrize("case", ["seeded", "zero-channel", "ties"])
def test_quantize_weight_is_bit_equal(case):
    w = _weight(case)
    want_q, want_scale = (np.asarray(a) for a in jax_quantize_weight(jnp.asarray(w)))
    got_q, got_scale = quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T, want_q)
    np.testing.assert_array_equal(got_scale.numpy(), want_scale)
    if case == "zero-channel":
        assert got_scale[7].item() == 1.0 and not got_q[7].any()
    if case == "ties":
        assert (np.abs(w.T / got_scale.numpy()[:, None]) % 1 == 0.5).sum() > 100


def test_quant_linear_matches_quant_dense():
    w = _weight("seeded")
    kq, scale = jax_quantize_weight(jnp.asarray(w))
    bias = np.random.RandomState(1).randn(40).astype(np.float32)
    x = np.random.RandomState(2).randn(3, 5, 24).astype(np.float32)
    params = {"params": {"kernel_q": kq, "scale": scale, "bias": jnp.asarray(bias)}}
    want = np.asarray(QuantDense(40).apply(params, jnp.asarray(x)))
    layer = QuantLinear(24, 40)
    layer.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_port_quantization_equals_the_jax_tree(flax_params):
    sd = quantize_bert_params(from_jax_params(flax_params))
    want = from_jax_params(jax.tree.map(np.asarray,
                                        jax_quantize_bert_params(flax_params)))
    assert sorted(sd) == sorted(want)
    n_quant = 0
    for key, value in want.items():
        assert sd[key].dtype == value.dtype, key
        assert torch.equal(sd[key], value), key
        n_quant += key.endswith(".weight_q")
    assert n_quant == 6 * 3  # six Linears in each of the tiny BERT's layers
    # the quantized model loads it, and to_jax_params gives the JAX tree back
    spec = ModelSpec.from_config(Config(_opt({"INT8_BERT": True})),
                                 BertConfig.tiny(vocab_size=len(build_demo_vocab())))
    model = RUArtModel(spec)
    model.load_state_dict(sd)
    back = to_jax_params(model)
    jq = jax.tree.map(np.asarray, jax_quantize_bert_params(flax_params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jq))
    assert set(flat_back) == set(flat_want)
    for path, value in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], value)


def test_engine_quantize_matches_jax(flax_params):
    opt = _opt({})
    jax_engine = _jax_engine(opt, {}, flax_params).quantize()
    port_engine = _port_engine(opt, {}, from_jax_params(flax_params)).quantize()
    assert port_engine.spec.bert.quant == "int8"
    reqs = _synthetic(3)
    want, got = jax_engine.predict(reqs), port_engine.predict(reqs)
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["idx"] for r in got] == [r["idx"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=TOL, rtol=0)
    model = port_engine.model
    assert port_engine.quantize() is port_engine and port_engine.model is model
    assert port_engine.predict(reqs) == got


def _write_conf(path, root, extra=()):
    lines = list(extra) + [
        "Task\ttrain,val,test", "train_FILE\ttrain.msgpack",
        "val_FILE\tval.msgpack", "test_FILE\ttest.msgpack",
        "preprocess_ocr_name\tocr_PMTD_ASTER,ES_ocr",
        "preprocess_od_name\tOD_bottom-up", "batch_size\t2", "epoch\t1",
        f"FEATURE_FOLDER\t{root}/features",
    ]
    lines += [f"{k}\t{v}" for k, v in TINY_OVERRIDES.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + STVQA_CONF)
    return str(path)


def test_predict_for_test_int8_matches_jax(tmp_path):
    for label, n, seed in (("train", 6, 0), ("val", 2, 1), ("test", N_TEST, 2)):
        raw = make_synthetic_raw_dataset(n, seed=seed, with_answers=label != "test")
        with open(tmp_path / f"{label}.msgpack", "wb") as f:
            msgpack.pack(raw, f)
    vocab = len(build_demo_vocab())
    # random weights with a tiny BERT, written by the JAX package's writer
    maker = Trainer(port_main.build_config(_write_conf(tmp_path / "conf_maker",
                                                       tmp_path)),
                    BertConfig.tiny(vocab_size=vocab), device="cpu")
    maker.preproc.ensure_preprocessed()
    maker.setup_model(maker.preproc.load_data()[2])
    full = str(tmp_path / "full.ckpt")
    jax_ckpt.save_checkpoint(full, to_jax_params(maker.model), None, {})
    results = {}
    for name in ("jax", "port"):
        os.makedirs(tmp_path / "ck" / name)
        shutil.copy(full, tmp_path / "ck" / name / "full.ckpt")
        conf = _write_conf(tmp_path / f"conf_{name}", tmp_path, (
            "INT8_BERT", "RESUME", f"MODEL_PATH\tck/{name}/full.ckpt"))
        if name == "jax":
            trainer = JaxTrainer(jax_build_config(conf),
                                 JaxBertConfig.tiny(vocab_size=vocab))
        else:
            trainer = Trainer(port_main.build_config(conf),
                              BertConfig.tiny(vocab_size=vocab), device="cpu")
        results[name] = trainer.predict_for_test()
        if name == "port":
            # the stateful model stays fp32; the eval model is int8
            assert trainer.spec.bert.quant == "none"
            assert not any(k.endswith("weight_q") for k in trainer.model.state_dict())
    want, got = results["jax"], results["port"]
    assert len(got["res"]) == N_TEST + 1  # the sampler wraps the tail
    assert [r["answer"] for r in got["res"]] == [r["answer"] for r in want["res"]]
    assert [r["idx"] for r in got["save_res"]] == [r["idx"] for r in want["save_res"]]
    np.testing.assert_allclose([r["score"] for r in got["save_res"]],
                               [r["score"] for r in want["save_res"]],
                               atol=TOL, rtol=0)
