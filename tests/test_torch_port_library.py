"""The port's library surface against the JAX package, on the CPU: the
warmup schedules and ``bert_adam`` (against optax), ``CharCNN`` and the
masked pools, the CoQA scorers and the label/ANLS helpers, the
preprocessor's helpers, the HDF5 image-feature provider, the ``DEBUG``
data scan (``data/debug.py`` and the trainer's dry run) and
``utils/timing.py``.

Inputs are drawn with numpy from seeds. Schedules equal optax at every
step; ``bert_adam`` within 1e-6 over 5 steps; ``CharCNN`` and the pools
within 1e-6; scorers, helpers, features and scan files equal.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data import debug as jax_debug
from ruart_tpu.data import image_features as jax_features
from ruart_tpu.data import preprocess as jax_preprocess
from ruart_tpu.data.dataset import VQADataset as JaxDataset
from ruart_tpu.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu.eval import coqa as jax_coqa
from ruart_tpu.eval import metrics as jax_metrics
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion import conv as jax_conv
from ruart_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from ruart_tpu.text.wordpiece import build_demo_vocab as jax_demo_vocab
from ruart_tpu.train import schedules as jax_schedules
from ruart_tpu.train.trainer import Trainer as JaxTrainer
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data import debug, image_features, preprocess
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.eval import coqa, metrics
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion import conv
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train import schedules
from ruart_tpu_torch.train.trainer import Trainer
from ruart_tpu_torch.utils.timing import Timers, profiler_trace

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(schedules.SCHEDULES))
@pytest.mark.parametrize("lr,warmup,total", [(1.0, 0.1, 100), (5e-5, 0.3, 37),
                                             (2e-3, 0.0, 10)])
def test_schedules_equal_optax(name, lr, warmup, total):
    """Equal at every step, in float32 as optax computes them; the cosine
    within lr * 2**-23 (XLA's float32 cosine is not numpy's: they round
    one float32 step apart at some arguments, which ``lr * (1 + cos) / 2``
    carries over as up to lr * 2**-24)."""
    got = schedules.SCHEDULES[name](lr, warmup, total)
    want = jax_schedules.SCHEDULES[name](lr, warmup, total)
    steps = list(range(total + 5))
    got = np.array([got(s) for s in steps], np.float64)
    want = np.array([float(want(s)) for s in steps], np.float64)
    assert (got == got.astype(np.float32)).all()  # float32 values
    if name == "warmup_cosine":
        np.testing.assert_allclose(got, want, rtol=0, atol=lr * 2.0 ** -23)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, warmup=0.2, total_steps=10, max_grad_norm=1.0),
    dict(lr=1e-2, warmup=-1, schedule="warmup_cosine", weight_decay=0.0,
         max_grad_norm=0.0),
    dict(lr=1e-2, warmup=0.5, total_steps=6, schedule="warmup_constant",
         max_grad_norm=100.0),
])
def test_bert_adam_matches_optax(kw):
    """5 steps on two seeded tensors with seeded gradients: the port's
    optimizer against the JAX package's optax chain (clip, Adam moments
    with bias correction, decoupled decay, schedule)."""
    rng = np.random.RandomState(0)
    init = {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (3 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]
    tx = jax_schedules.bert_adam(**kw)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt = schedules.bert_adam(tensors.values(), **kw)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tensors.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), atol=1e-6, rtol=0)
    assert opt.count == 5


def test_char_cnn_and_pools_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 10, 6).astype(np.float32)
    model = jax_conv.CharCNN(window_size=5, output_size=8)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(params["params"]["cnn"]["kernel"])  # [W, In, Out]
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    port = conv.CharCNN(6, 5, 8)
    assert port.cnn.weight.shape == (8, 6, 5)
    with torch.no_grad():
        port.cnn.weight.copy_(torch.from_numpy(kernel.transpose(2, 1, 0).copy()))
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="odd"):
        conv.CharCNN(6, 4, 8)
    mask = (rng.rand(4, 10) > 0.4).astype(np.float32)
    mask[2] = 0  # an all-masked row pools to 0
    for name in ("max_pooling", "average_pooling"):
        got = getattr(conv, name)(torch.from_numpy(x), torch.from_numpy(mask))
        want = getattr(jax_conv, name)(jnp.asarray(x), jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    assert not got[2].any()


def _garble(rng, n):
    pool = list("abcdefghij STOPexit-.")
    return ["".join(rng.choice(pool, rng.randint(0, 9))) for _ in range(n)]


def test_scorers_and_helpers_equal():
    rng = np.random.RandomState(2)
    for _ in range(30):
        gts = _garble(rng, rng.randint(1, 5))
        words = _garble(rng, rng.randint(1, 8))
        pred = words[0]
        assert coqa.normalize_answer(pred) == jax_coqa.normalize_answer(pred)
        assert coqa.f1_score(pred, gts) == jax_coqa.f1_score(pred, gts)
        assert coqa.exact_match(pred, gts) == jax_coqa.exact_match(pred, gts)
        assert metrics.stvqa_label(gts, words) == jax_metrics.stvqa_label(gts, words)
        assert metrics.textvqa_label(gts, words) == \
            jax_metrics.textvqa_label(gts, words)
        anls = float(rng.rand())
        assert metrics.final_anls(anls) == jax_metrics.final_anls(anls)
        vocab = {w: i for i, w in enumerate(_garble(rng, 20))}
        assert preprocess.token2id_sent_substring_fallback(words, vocab) == \
            jax_preprocess.token2id_sent_substring_fallback(words, vocab)
    assert metrics.stvqa_label(["", ""], ["a"]) is None
    preds = {f"q{i}": w for i, w in enumerate(_garble(rng, 6))}
    answers = {k: _garble(rng, 3) for k in list(preds) + ["q_missing"]}
    assert coqa.score_predictions(preds, answers) == \
        jax_coqa.score_predictions(preds, answers)
    votes = [_garble(rng, 4) for _ in range(3)]
    confs = rng.rand(3, 4).tolist()
    for by_cnt in (False, True):
        assert coqa.ensemble_predict(votes, confs, vote_by_cnt=by_cnt) == \
            jax_coqa.ensemble_predict(votes, confs, vote_by_cnt=by_cnt)
    np.testing.assert_array_equal(coqa.gen_upper_triangle_mask(7, 3),
                                  jax_coqa.gen_upper_triangle_mask(7, 3))
    ctx, offsets = "the red stop sign", [(0, 3), (4, 7), (8, 12), (13, 17)]
    assert coqa.find_span_with_gt(ctx, offsets, "stop sign") == \
        jax_coqa.find_span_with_gt(ctx, offsets, "stop sign")
    # spaCy's en_core_web_sm is not installed: both fall back alike
    assert preprocess._try_spacy() is None and jax_preprocess._try_spacy() is None


def test_hdf5_image_features_match_jax(tmp_path):
    """Seeded bottom-up packs (train36/val36: features, spatial boxes,
    image-id -> row pickles) through both providers and both
    ``load_image_features`` routes."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(3)
    # load_image_features looks three levels above FEATURE_FOLDER
    folder = tmp_path / "a" / "image_features"
    folder.mkdir(parents=True)
    ids = {"train36": [11, 5, 42], "val36": [7, 99]}
    for split, keys in ids.items():
        with h5py.File(folder / f"{split}.hdf5", "w") as f:
            f["image_features"] = rng.rand(len(keys), 36, 16).astype(np.float32)
            f["spatial_features"] = (rng.rand(len(keys), 36, 6) * 100).astype(
                np.float32)
        with open(folder / f"{split}_imgid2idx.pkl", "wb") as f:
            pickle.dump({k: i for i, k in enumerate(keys)}, f)
    feature_folder = str(tmp_path / "a" / "b" / "c") + "/"
    opt = {"img_feature": True, "FEATURE_FOLDER": feature_folder}
    got = image_features.load_image_features(opt)
    want = jax_features.load_image_features(dict(opt))
    assert isinstance(got, image_features.HDF5ImageFeatures)
    assert got.id2idx == want.id2idx and len(got.id2idx) == 5
    for key in ids["train36"] + ids["val36"]:
        for a, b in zip(got.get(key), want.get(key)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.get(99)[1].shape == (36, 8)
    assert image_features.load_image_features({}) is None


def _write_split(root, label, n, seed):
    raw = make_synthetic_raw_dataset(n, seed=seed)
    with open(root / f"{label}.msgpack", "wb") as f:
        msgpack.pack(raw, f)


def _debug_opt(root, **extra):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"Task": "train,val", "datadir": str(root),
                "FEATURE_FOLDER": str(root / "features"),
                "train_FILE": "train.msgpack", "val_FILE": "val.msgpack",
                "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "batch_size": 4})
    opt.update(extra)
    return opt


def test_debug_scan_matches_jax(tmp_path):
    """``scan_dataset`` of both packages over the same preprocessed split,
    and the files ``dump_debug_scan`` writes."""
    _write_split(tmp_path, "train", 12, 0)
    opt = _debug_opt(tmp_path, Task="train")
    jax_preprocess.Preprocessor(JaxConfig(dict(opt))).ensure_preprocessed()
    with open(tmp_path / "features" / "train-preprocessed.msgpack", "rb") as f:
        data = msgpack.unpack(f, raw=False, strict_map_key=False)["data"]
    want = JaxDataset(data, JaxConfig(dict(opt)),
                      tokenizer=JaxTokenizer(jax_demo_vocab()))
    got = VQADataset(data, Config(dict(opt)),
                     tokenizer=WordPieceTokenizer(build_demo_vocab()))
    hists = debug.scan_dataset(got)
    assert hists == jax_debug.scan_dataset(want)
    assert sum(hists["q"]["glove_len"].values()) == len(got)
    for pkg, mod, ds in (("jax", jax_debug, want), ("torch", debug, got)):
        (tmp_path / pkg).mkdir()
        mod.dump_debug_scan(ds, "train", str(tmp_path / pkg))
    for name in ("q", "ocr", "od"):
        f = f"train_{name}_output.json"
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_trainer_debug_dry_run_matches_jax(tmp_path):
    """``DEBUG``: both trainers scan train and val without training and
    write the same six histogram files."""
    outs = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        root.mkdir()
        _write_split(root, "train", 8, 1)
        _write_split(root, "val", 4, 1)
        opt = _debug_opt(root, DEBUG=True)
        if pkg == "jax":
            trainer = JaxTrainer(JaxConfig(opt),
                                 bert_config=JaxBertConfig.tiny(vocab_size=64))
        else:
            trainer = Trainer(Config(opt), BertConfig.tiny(vocab_size=64),
                              device="cpu")
        trainer.train()
        assert trainer.updates == 0
        folder = trainer.save_folder
        outs[pkg] = {f: open(os.path.join(folder, f), "rb").read()
                     for f in sorted(os.listdir(folder)) if f.endswith("_output.json")}
    assert len(outs["torch"]) == 6 and outs["torch"] == outs["jax"]
    assert "glove_len" in json.loads(outs["torch"]["train_q_output.json"])


def test_timers_and_profiler_trace(tmp_path):
    t = Timers()
    with t.timer("x"):
        pass
    t.stop("never started")
    assert t.counts["x"] == 1 and "x: total" in t.report()
    with profiler_trace(None):
        pass
    with profiler_trace(str(tmp_path)):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert "aten::matmul" in f.read()
