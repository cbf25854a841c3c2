"""The port's multi-rank path against the JAX package on the same CPU mesh.

The port's ranks are gloo processes started by
``ruart_tpu_torch.parallel.launch.spawn`` (one torch thread each; they
import no JAX: ``torch_port_mesh_workers.py``); the JAX side runs here, on
the conftest's virtual CPU devices. Inputs: one collated batch of 4 items
under the default layouts (packed, deduplicated and compacted candidate
rows, packed questions, the fused encoder call), TINY_OVERRIDES with a
BERT of 4 heads of 64 (hidden 256, 2 layers), the port's seeded weights
(the flax tree through the weight bridge), dropout off, TUNE_PARTIAL with
tune_partial 20.

* Forward on (dp 2), (tp 2) and (dp 2, tp 2): the port's ranks against
  ``RUArtModel.apply`` on the JAX mesh of the same shape, within 1e-5 abs;
  also (tp 2) and (dp 2, tp 2) under INT8_BERT, against the JAX mesh
  forward of ``quantize_bert_params``'s tree, within 1e-5 abs (the
  tolerance of ``test_torch_port_quant.py``): the int8 projections whole
  on every rank, as the JAX rules leave ``kernel_q`` replicated.
* The same dp-2 forward with per-rank layer-norm moments (the dp
  all-reduce of the whole-tensor layer norm taken out) must land outside
  that tolerance.
* One dp-2 train step (Adamax, lr 1e-3, clip 10, LOCK_BERT): the loss
  within 1e-5 relative and the parameters within 0.05 * lr of the JAX step
  on the dp-2 mesh. Adamax's first step moves an element by
  lr * g / (|g| + 1e-8): an element the JAX step moved by less than
  0.9 * lr has |g| below ~1e-7, where rounding decides the direction in
  either package; those are held to Adamax's own bound (lr from the start).
* Against the port's one-rank step: a tp-2 step with the encoder unlocked,
  a dp-2 step with the shipped conf's dropout (the same masks), and an
  unlocked (dp 2, tp 2) SGD step whose clip binds (the clip's norm spans
  the tp shards).
* BF16 under tp 2: every row-parallel reduce runs in bf16 (the Dense's
  output type); the scores lie no further from the single-rank bf16
  scores than those lie from fp32.
* The trainer through the conf keys: 2 ranks, tensor_parallel 2, 2 steps,
  evaluation and saves; only rank 0 writes, the full checkpoint loads into
  a single-process trainer that gives the same scores within 1e-5, also
  through the INT8_BERT eval model, and a batch dp does not divide stays
  single-device.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.ops.quant import quantize_bert_params as jax_quantize_bert_params
from ruart_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ruart_tpu.parallel.mesh import shard_params as jax_shard_params
from ruart_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from ruart_tpu.train.optim import make_optimizer as jax_make_optimizer
from ruart_tpu.train.optim import make_row_pinner as jax_make_row_pinner
from ruart_tpu.train.train_step import init_train_state as jax_init_state
from ruart_tpu.train.train_step import make_train_step as jax_make_train_step
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import GLOBAL_KEYS, RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.parallel.launch import spawn
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
from ruart_tpu_torch.train.train_step import init_train_state, make_train_step
from ruart_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
LR = 1e-3
TUNE_ROWS = 20
BATCH = 4
VOCAB_SIZE = len(build_demo_vocab())
BERT = dict(vocab_size=VOCAB_SIZE, hidden_size=256, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128)


def _opt():
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": BATCH, "tune_partial": TUNE_ROWS, "lr": LR,
                "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "datadir": ".",
                "FEATURE_FOLDER": "."})
    for key in ("DROPOUT", "dropout_emb"):
        opt.pop(key)
    return opt


def _background(fn, *args):
    """Run ``fn`` on a thread; returns join(), which re-raises its error."""
    box = {}

    def run():
        try:
            fn(*args)
        except BaseException as e:  # handed to the joining test
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]

    return join


def _spawn(target, nprocs, *args):
    spawn(f"torch_port_mesh_workers:{target}", nprocs, args=args,
          env={"PYTHONPATH": HERE}, threads=1, timeout=240)


def _collated_batch(opt):
    cfg = Config(opt)
    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(BATCH, seed=5, n_ocr_range=(3, 9),
                                     n_es=6)
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="train",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    return Collator(cfg)([ds[i] for i in range(len(ds))])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs written for the ranks, and the ranks started in the
    background while the JAX side compiles here."""
    work = str(tmp_path_factory.mktemp("mesh"))
    opt = _opt()
    batch = _collated_batch(opt)
    q, ocr, od = batch[:3]
    # packed question rows (batch-global table), dense OCR rows (per
    # sample), compacted OD rows (cand_sel)
    assert "bert_packed" in q and "cand_sel" in od and "bert" in ocr
    spec = ModelSpec.from_config(Config(opt), BertConfig(**BERT))
    model = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    with open(os.path.join(work, "opt.json"), "w") as f:
        json.dump(opt, f)
    with open(os.path.join(work, "bert.json"), "w") as f:
        json.dump(BERT, f)
    torch.save(model.state_dict(), os.path.join(work, "state.pt"))
    np.savez(os.path.join(work, "batch.npz"), gt=batch[3], **{
        f"{name}/{k}": v for name, block in zip(("q", "ocr", "od"), batch[:3])
        for k, v in block.items()})
    join = _background(_spawn, "forward_ranks", 4, work)
    return {"work": work, "opt": opt, "batch": batch, "join": join,
            "flax": to_jax_params(model), "state": model.state_dict()}


@pytest.fixture(scope="module")
def port(setup):
    setup["join"]()
    work = setup["work"]
    out = torch.load(os.path.join(work, "out_0.pt"), weights_only=False)
    out.update(torch.load(os.path.join(work, "out_2.pt"), weights_only=False))
    out["dtypes"] = [json.load(open(os.path.join(work, f"dtypes_{r}.json")))
                     for r in (2, 3)]
    return out


def _jax_model(opt):
    cfg = JaxConfig(opt)
    spec = JaxModelSpec.from_config(cfg, JaxBertConfig(**BERT))
    return cfg, spec, JaxRUArtModel(spec)


def _jax_batch(batch, mesh):
    """Per-sample leaves split over dp, the batch-global tables replicated
    (as the JAX trainer's make_global_batch lays them out)."""
    split = NamedSharding(mesh, P("dp"))
    whole = NamedSharding(mesh, P())

    def put(block):
        return {k: jax.device_put(v, whole if k in GLOBAL_KEYS else split)
                for k, v in block.items()}

    q, ocr, od, gt = batch[:4]
    return put(q), put(ocr), put(od), jax.device_put(gt, split)


def _jax_mesh(dp, tp):
    return jax_make_mesh(jax.devices()[:dp * tp], tp=tp)


def jax_forward(setup, dp, tp, int8=False):
    opt, params = setup["opt"], setup["flax"]
    if int8:
        opt, params = dict(opt, INT8_BERT=True), jax_quantize_bert_params(params)
    _, _, model = _jax_model(opt)
    mesh = _jax_mesh(dp, tp)
    params = jax_shard_params(jax.tree.map(jnp.asarray, params), mesh)
    q, ocr, od, _ = _jax_batch(setup["batch"], mesh)
    fn = jax.jit(lambda p, a, b, c: model.apply(p, a, b, c,
                                                deterministic=True))
    return np.asarray(fn(params, q, ocr, od))


@pytest.mark.parametrize("dp,tp,int8", [(2, 1, False), (1, 2, False),
                                        (2, 2, False), (1, 2, True),
                                        (2, 2, True)],
                         ids=["dp2", "tp2", "dp2tp2", "tp2_int8",
                              "dp2tp2_int8"])
def test_forward_matches_jax_mesh(setup, port, dp, tp, int8):
    want = jax_forward(setup, dp, tp, int8)
    label = {(2, 1): "dp2", (1, 2): "tp2", (2, 2): "dp2tp2"}[(dp, tp)]
    got = port[label + ("_int8" if int8 else "")]
    assert got.shape == want.shape == (BATCH, want.shape[1])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if int8:
        # the int8 encoder ran: its scores lie off the fp32 ones
        assert np.abs(got - port[label]).max() > 10 * TOL
    if (dp, tp) == (2, 1):
        # teeth: the layer norm's moments taken per rank move the scores
        # well outside the tolerance
        off = np.abs(port["dp2_rank_moments"] - want).max()
        assert off > 100 * TOL, off


@pytest.fixture(scope="module")
def jax_step(setup):
    """One JAX train step on the dp-2 mesh: (loss, parameters)."""
    cfg, spec, model = _jax_model(setup["opt"])
    mesh = _jax_mesh(2, 1)
    params = jax_shard_params(jax.tree.map(jnp.asarray, setup["flax"]), mesh)
    tx = jax_make_optimizer("#", LR, 10.0, params, spec, True)
    step = jax_make_train_step(
        model, tx, jax_make_loss_fn("BCE_D1"),
        jax_make_row_pinner(params, spec, TUNE_ROWS), donate=False)
    state = jax_init_state(params, tx, cfg.seed)
    state, loss = step(state, *_jax_batch(setup["batch"], mesh))
    return float(loss), {k: v.numpy() for k, v in from_jax_params(
        jax.tree.map(np.asarray, state.params)).items()}


def _check_step(port, label, want_loss, want, start):
    np.testing.assert_allclose(float(port[f"{label}/loss"]), want_loss,
                               rtol=1e-5)
    prefix = f"{label}/param/"
    assert set(want) == {k[len(prefix):] for k in port if
                         k.startswith(prefix)}
    for name, w in want.items():
        got = port[prefix + name]
        noise = np.abs(w - start[name]) < 0.9 * LR
        np.testing.assert_allclose(got[~noise], w[~noise], atol=0.05 * LR,
                                   rtol=0, err_msg=name)
        assert (np.abs(got - start[name])[noise] <= LR * (1 + 1e-4)).all(), name
    assert not np.array_equal(port[prefix + "alphaBERT"], start["alphaBERT"])


@pytest.mark.parametrize("label", ["dp2", "dp2tp2"])
def test_train_step_matches_jax_dp2_mesh(setup, port, jax_step, label):
    """The dp-2 step against the JAX step on the dp-2 mesh; the (dp 2,
    tp 2) step against the same JAX step (the same global-batch update:
    it adds the tp-split word tables' gradients and their share of the
    clip's norm)."""
    start = {k: v.numpy() for k, v in setup["state"].items()}
    _check_step(port, label, *jax_step, start)


def _one_rank_step(setup, opt, opt_name="#", clip=10.0):
    """The port's one-rank train step from the same weights: (loss,
    parameters)."""
    spec = ModelSpec.from_config(Config(opt), BertConfig(**BERT))
    model = RUArtModel(spec)
    model.load_state_dict(setup["state"])
    step = make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(model, spec, TUNE_ROWS))
    state = init_train_state(
        model, Optimizer(opt_name, LR, clip, model, spec, True), 0)
    q, ocr, od = ({k: torch.from_numpy(v) for k, v in b.items()}
                  for b in setup["batch"][:3])
    _, loss = step(state, q, ocr, od, torch.from_numpy(setup["batch"][3]))
    return float(loss), {k: v.detach().numpy()
                         for k, v in model.named_parameters()}


@pytest.mark.parametrize("label", ["tp2_unlocked", "dp2_dropout"])
def test_step_matches_one_rank(setup, port, label):
    """Against the port's one-rank step from the same weights: with the
    encoder unlocked, the tp-2 step (gradients through the column- and
    row-parallel layers, the all-reduces' backward and the vocab-parallel
    word table); with the shipped conf's dropout, the dp-2 step (each site
    draws the global batch's mask from the shared generator and keeps its
    rows, so the step is the one-rank step)."""
    opt = dict(setup["opt"])
    if label == "tp2_unlocked":
        opt.pop("LOCK_BERT")
    else:
        opt.update(DROPOUT=0.3, dropout_emb=0.4)
    start = {k: v.numpy() for k, v in setup["state"].items()}
    _check_step(port, label, *_one_rank_step(setup, opt), start)
    query = "Bert.layer_0.attention_self.query.weight"
    assert np.array_equal(port[f"{label}/param/{query}"], start[query]) == (
        label == "dp2_dropout")


def test_dp2tp2_clip_takes_the_full_gradient_norm(setup, port):
    """SGD with the encoder unlocked and a clip that binds: every update
    is lr * g * clip / |g|, so the (dp 2, tp 2) step's updates have the
    one-rank step's scale only if the norm sums the squares of the tp
    shards (the encoder's split layers, the word tables) over tp. The
    scale (the least-squares ratio of the two updates over all
    parameters) within 1e-4 of 1, each update within 1% of the largest
    one plus fp32's resolution of the parameters (1e-7), the loss within
    1e-5 relative."""
    from torch_port_mesh_workers import SGD_CLIP

    opt = dict(setup["opt"])
    opt.pop("LOCK_BERT")
    want_loss, want = _one_rank_step(setup, opt, "SGD", SGD_CLIP)
    np.testing.assert_allclose(float(port["dp2tp2_sgd/loss"]), want_loss,
                               rtol=1e-5)
    start = {k: v.numpy().astype(np.float64) for k, v in
             setup["state"].items()}
    got = {k: port[f"dp2tp2_sgd/param/{k}"] - start[k] for k in want}
    want = {k: w - start[k] for k, w in want.items()}
    dot = sum(float((got[k] * want[k]).sum()) for k in want)
    ratio = dot / sum(float((w * w).sum()) for w in want.values())
    assert abs(ratio - 1) < 1e-4, ratio
    largest = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-2 * largest + 1e-7,
                                   rtol=0, err_msg=name)


def test_tp2_bf16_reduces_in_bf16(setup, port):
    """The row-parallel reduces take the layer's output type, bf16."""
    assert port["dtypes"] == [["torch.bfloat16"]] * 2
    spec = ModelSpec.from_config(Config(setup["opt"]), BertConfig(**BERT))
    single = {}
    q, ocr, od = ({k: torch.from_numpy(v) for k, v in b.items()}
                  for b in setup["batch"][:3])
    for dtype in ("float32", "bfloat16"):
        model = RUArtModel(dataclasses.replace(
            spec, bert=dataclasses.replace(spec.bert, dtype=dtype)))
        model.load_state_dict(setup["state"])
        with torch.no_grad():
            single[dtype] = model.eval()(q, ocr, od).numpy()
    bf16_move = np.abs(single["bfloat16"] - single["float32"]).max()
    assert 0 < np.abs(port["tp2_bf16"] - single["bfloat16"]).max() <= bf16_move


def _write_data(root):
    for label, n, seed in (("train", 8, 0), ("val", 4, 1)):
        raw = make_synthetic_raw_dataset(n, seed=seed)
        with open(os.path.join(root, f"{label}.msgpack"), "wb") as f:
            msgpack.pack(raw, f)
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({
        "Task": "train,val", "datadir": root,
        "FEATURE_FOLDER": os.path.join(root, "features"),
        "train_FILE": "train.msgpack", "val_FILE": "val.msgpack",
        "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
        "preprocess_od_name": "OD_bottom-up", "batch_size": 4, "epoch": 1,
        "tensor_parallel": 2,
    })
    return opt


def test_trainer_two_ranks_through_conf_keys(tmp_path):
    root = str(tmp_path)
    opt = _write_data(root)
    bert = dict(BertConfig.tiny(vocab_size=VOCAB_SIZE).__dict__)
    for key in ("attention_impl", "dtype", "quant", "mesh"):
        bert.pop(key)
    with open(os.path.join(root, "bert.json"), "w") as f:
        json.dump(bert, f)
    _spawn("trainer_ranks", 2, root, opt)
    ranks = [json.load(open(os.path.join(root, f"trainer_{r}.json")))
             for r in (0, 1)]
    for r in ranks:
        assert r["updates"] == 2 and np.isfinite(r["loss"])
        assert r["mesh"] == {"dp": 1, "tp": 2}
        # dp 2 does not divide a batch of 3: single-device
        assert r["small_batch_mesh"] is False
    assert ranks[0]["save_folder"] == ranks[1]["save_folder"]
    assert ranks[1]["written"] == []
    assert "full.ckpt" in ranks[0]["written"]
    assert "ANLS_best_model.ckpt" in ranks[0]["written"]
    assert os.listdir(os.path.join(root, "conf~")) == ["run_1"]
    got = np.load(os.path.join(root, "scores_0.npy"))
    np.testing.assert_array_equal(got, np.load(os.path.join(root,
                                                            "scores_1.npy")))

    from torch_port_mesh_workers import first_val_scores

    single = dict(opt)
    single.pop("tensor_parallel")
    trainer = Trainer(Config(single), bert_config=BertConfig(**bert),
                      device="cpu")
    _, _, embeddings = trainer._preprocess()
    trainer.setup_model(embeddings)
    trainer.load_model(os.path.join(root, "full.ckpt"))
    assert trainer.mesh is None and trainer.updates == 2
    np.testing.assert_allclose(first_val_scores(trainer), got, atol=TOL,
                               rtol=0)
    # INT8_BERT under tp 2: the eval model of the trained weights
    trainer._apply_int8_eval()
    for r in (0, 1):
        np.testing.assert_allclose(
            np.load(os.path.join(root, f"scores_int8_{r}.npy")),
            first_val_scores(trainer), atol=TOL, rtol=0)
