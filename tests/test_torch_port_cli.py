"""The port's command-line tools end to end on the CPU
(``RUART_PLATFORM=cpu``), on ``make_synthetic_raw_dataset`` data:

* ``python -m ruart_tpu_torch.cli.main`` trains 4 steps (batch 2, epoch 1
  over 8 items; BERT-base, TINY_OVERRIDES fusion widths) and writes the
  run folder, the conf copy, the best-ANLS and best-ACC checkpoints;
  ``ruart_tpu_torch.cli.main_test`` writes ``submission.json`` from the
  ANLS checkpoint, one entry per test item. Without the variable and
  without a card the tools refuse to run.
* The feature folder the port writes is byte-equal to the one the JAX
  package writes from the same raw files.
* From one full checkpoint written by the JAX package's
  ``save_checkpoint`` (BERT included), the port's ``predict_for_test``
  and the JAX package's give the same answers, with scores within 1e-5
  abs (fp32, sums in another order); both read the port's feature folder.
  This part runs a tiny BERT to keep the JAX compile short.
"""

import json
import os
import shutil

import msgpack
import numpy as np
import pytest
import torch

from ruart_tpu.cli.main import build_config as jax_build_config
from ruart_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.train import checkpoint as jax_ckpt
from ruart_tpu.train.trainer import Trainer as JaxTrainer
from ruart_tpu_torch.cli import main as port_main
from ruart_tpu_torch.cli import main_test as port_main_test
from ruart_tpu_torch.convert import to_jax_params
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.text.wordpiece import build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
SCORE_TOL = 1e-5
N_TEST = 5
FEATURE_FILES = ("train_meta.msgpack", "train-preprocessed.msgpack",
                 "val-preprocessed.msgpack", "test-preprocessed.msgpack")


def _write_conf(path, root, features, extra=()):
    lines = list(extra) + [
        "Task\ttrain,val,test", "train_FILE\ttrain.msgpack",
        "val_FILE\tval.msgpack", "test_FILE\ttest.msgpack",
        "preprocess_ocr_name\tocr_PMTD_ASTER,ES_ocr",
        "preprocess_od_name\tOD_bottom-up", "batch_size\t2", "epoch\t1",
        f"FEATURE_FOLDER\t{root}/{features}",
    ]
    lines += [f"{k}\t{v}" for k, v in TINY_OVERRIDES.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + STVQA_CONF)
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Train through the port CLI once; every test reads the result."""
    root = tmp_path_factory.mktemp("cli")
    for label, n, seed in (("train", 8, 0), ("val", 4, 1), ("test", N_TEST, 2)):
        raw = make_synthetic_raw_dataset(n, seed=seed, with_answers=label != "test")
        with open(root / f"{label}.msgpack", "wb") as f:
            msgpack.pack(raw, f)
    conf = _write_conf(root / "conf_tiny", root, "features")
    mp = pytest.MonkeyPatch()
    mp.setenv("RUART_PLATFORM", "cpu")
    try:
        trainer = port_main.main(["--conf_file", conf])
    finally:
        mp.undo()
    return root, conf, trainer


def test_cli_trains_and_writes_the_run_folder(run):
    root, _, trainer = run
    folder = root / "conf~" / "run_1"
    for name in ("conf_copy", "save_res_last.json", "ANLS_best_model.ckpt",
                 "ACC_best_model.ckpt"):
        assert (folder / name).is_file(), name
    assert trainer.updates == 4 and trainer.train_loss.count == 4
    assert np.isfinite(trainer.train_loss.avg)
    assert [e["mode"] for e in trainer.eval_history] == ["dev", "dev", "train"]
    with np.load(folder / "ANLS_best_model.ckpt") as z:
        assert not any(k.startswith("params/params/Bert/") for k in z.files)


def test_cli_predicts_from_the_best_checkpoint(run, monkeypatch):
    root, conf, _ = run
    predict = _write_conf(root / "conf_predict", root, "features", (
        "RESUME", "MODEL_PATH\tconf~/run_1/ANLS_best_model.ckpt"))
    monkeypatch.setenv("RUART_PLATFORM", "cpu")
    port_main_test.main(["--conf_file", predict])
    with open(root / "conf~" / "run_1" / "submission.json") as f:
        sub = json.load(f)
    assert len(sub) == N_TEST
    assert all(isinstance(r["answer"], str) for r in sub)
    missing = _write_conf(root / "conf_missing", root, "features", (
        "RESUME", "MODEL_PATH\tconf~/run_1/no_such.ckpt"))
    with pytest.raises(FileNotFoundError, match="RESUME checkpoint not found"):
        port_main_test.main(["--conf_file", missing])


def test_cli_needs_a_card_or_the_cpu_switch(run, monkeypatch):
    _, conf, _ = run
    monkeypatch.delenv("RUART_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="RUART_PLATFORM=cpu"):
        port_main.main(["--conf_file", conf])


def test_feature_folder_matches_the_jax_package(run):
    root, _, _ = run
    conf = _write_conf(root / "conf_jax_features", root, "features_jax")
    JaxPreprocessor(jax_build_config(conf)).ensure_preprocessed()
    for name in FEATURE_FILES:
        with open(root / "features" / name, "rb") as a, \
                open(root / "features_jax" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_predict_for_test_matches_jax_from_one_checkpoint(run):
    root, _, _ = run
    vocab = len(build_demo_vocab())
    # random weights with a tiny BERT, saved by the JAX package's writer
    maker = Trainer(port_main.build_config(
        _write_conf(root / "conf_maker", root, "features")),
        BertConfig.tiny(vocab_size=vocab), device="cpu")
    maker.preproc.ensure_preprocessed()
    maker.setup_model(maker.preproc.load_data()[2])
    full = str(root / "full.ckpt")
    jax_ckpt.save_checkpoint(full, to_jax_params(maker.model), None, {})
    results = {}
    for name in ("jax", "port"):
        os.makedirs(root / "ck" / name)
        shutil.copy(full, root / "ck" / name / "full.ckpt")
        conf = _write_conf(root / f"conf_{name}", root, "features", (
            "RESUME", f"MODEL_PATH\tck/{name}/full.ckpt"))
        if name == "jax":
            trainer = JaxTrainer(jax_build_config(conf),
                                 JaxBertConfig.tiny(vocab_size=vocab))
        else:
            trainer = Trainer(port_main.build_config(conf),
                              BertConfig.tiny(vocab_size=vocab), device="cpu")
        results[name] = trainer.predict_for_test()
    want, got = results["jax"], results["port"]
    assert [r["answer"] for r in got["res"]] == [r["answer"] for r in want["res"]]
    assert [r["idx"] for r in got["save_res"]] == [r["idx"] for r in want["save_res"]]
    np.testing.assert_allclose([r["score"] for r in got["save_res"]],
                               [r["score"] for r in want["save_res"]],
                               atol=SCORE_TOL, rtol=0)
    with open(root / "ck" / "jax" / "submission.json") as a, \
            open(root / "ck" / "port" / "submission.json") as b:
        assert json.load(a) == json.load(b)
