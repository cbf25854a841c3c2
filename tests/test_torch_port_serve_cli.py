"""The port's serving CLI (``ruart_tpu_torch.cli.serve_main``) against the
JAX package's, on the CPU (``RUART_PLATFORM=cpu``), from one checkpoint
written by the JAX package's ``save_checkpoint`` (tiny BERT,
TINY_OVERRIDES fusion widths, batch 2):

* ``serve_stdio`` of the port's ``build_engine`` writes one JSON line per
  request, in input order; answers and idx equal the JAX
  ``InferenceEngine.from_trainer(...).predict`` of the JAX package's
  ``build_engine``, scores within 1e-5 abs; the same under ``INT8_BERT``;
* ``main`` with ``--warmup`` and ``--max_wait_ms`` serves stdin to stdout
  with the answers of a direct ``predict``;
* a missing ``MODEL_PATH`` raises FileNotFoundError; without a card and
  without ``RUART_PLATFORM=cpu`` the CLI raises.
"""

import io
import json

import msgpack
import numpy as np
import pytest
import torch

from ruart_tpu.cli.main import build_config as jax_build_config
from ruart_tpu.cli.serve_main import build_engine as jax_build_engine
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.train import checkpoint as jax_ckpt
from ruart_tpu_torch.cli import main as port_main
from ruart_tpu_torch.cli import serve_main
from ruart_tpu_torch.convert import to_jax_params
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.text.wordpiece import build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer
from test_torch_port_slice import _synthetic

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = len(build_demo_vocab())
CHECKPOINT = ("RESUME", "MODEL_PATH\tck/run/full.ckpt")


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


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Raw splits, their feature folder, and random tiny-BERT weights in
    the JAX package's checkpoint format."""
    root = tmp_path_factory.mktemp("serve_cli")
    for label, n, seed in (("train", 6, 0), ("val", 2, 1), ("test", 2, 2)):
        raw = make_synthetic_raw_dataset(n, seed=seed, with_answers=label != "test")
        with open(root / f"{label}.msgpack", "wb") as f:
            msgpack.pack(raw, f)
    maker = Trainer(port_main.build_config(_write_conf(root / "conf_maker", root)),
                    BertConfig.tiny(vocab_size=VOCAB), device="cpu")
    maker.preproc.ensure_preprocessed()
    maker.setup_model(maker.preproc.load_data()[2])
    (root / "ck" / "run").mkdir(parents=True)
    jax_ckpt.save_checkpoint(str(root / "ck" / "run" / "full.ckpt"),
                             to_jax_params(maker.model), None, {})
    return root


def _port_engine(conf, monkeypatch):
    monkeypatch.setenv("RUART_PLATFORM", "cpu")
    return serve_main.build_engine(port_main.build_config(conf),
                                   BertConfig.tiny(vocab_size=VOCAB))


def _lines(reqs):
    # a blank line between requests is skipped
    return io.StringIO("\n\n".join(json.dumps(r) for r in reqs) + "\n")


def _assert_same_answers(got, want):
    want = json.loads(json.dumps(want))  # as the CLI prints them
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["idx"] for r in got] == [r["idx"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["fp32", "INT8_BERT"])
def test_serve_stdio_matches_jax(root, mode, monkeypatch):
    extra = CHECKPOINT + (("INT8_BERT",) if mode == "INT8_BERT" else ())
    conf = _write_conf(root / f"conf_{mode}", root, extra)
    reqs = _synthetic(5)  # 3 waves at batch 2, the last padded
    want = jax_build_engine(jax_build_config(conf),
                            JaxBertConfig.tiny(vocab_size=VOCAB)).predict(reqs)
    engine = _port_engine(conf, monkeypatch)
    assert engine.spec.bert.quant == ("int8" if mode == "INT8_BERT" else "none")
    out = io.StringIO()
    n = serve_main.serve_stdio(engine, _lines(reqs), out, max_wait_ms=5.0)
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert n == len(got) == len(reqs)
    _assert_same_answers(got, want)


def test_main_serves_stdin_after_warmup(root, monkeypatch):
    conf = _write_conf(root / "conf_main", root, CHECKPOINT)
    reqs = _synthetic(3)
    with _port_engine(conf, monkeypatch) as engine:
        want = engine.predict(reqs)
    # main builds the conf's encoder (BERT-base): keep the checkpoint's
    build = serve_main.build_engine
    monkeypatch.setattr(serve_main, "build_engine", lambda cfg: build(
        cfg, BertConfig.tiny(vocab_size=VOCAB)))
    out = io.StringIO()
    monkeypatch.setattr("sys.stdin", _lines(reqs))
    monkeypatch.setattr("sys.stdout", out)
    n = serve_main.main(["--conf_file", conf, "--warmup", "2",
                         "--max_wait_ms", "5"])
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert n == len(got) == len(reqs)
    assert got == json.loads(json.dumps(want))


def test_missing_checkpoint_and_missing_card_raise(root, monkeypatch):
    missing = _write_conf(root / "conf_missing", root,
                          ("RESUME", "MODEL_PATH\tck/run/no_such.ckpt"))
    with pytest.raises(FileNotFoundError, match="RESUME checkpoint not found"):
        _port_engine(missing, monkeypatch)
    conf = _write_conf(root / "conf_card", root, CHECKPOINT)
    monkeypatch.delenv("RUART_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RUART_PLATFORM=cpu"):
        serve_main.build_engine(port_main.build_config(conf),
                                BertConfig.tiny(vocab_size=VOCAB))
