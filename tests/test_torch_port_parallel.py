"""The port's mesh logic against the JAX package, in one process:
``hybrid_mesh_shape`` (its errors included) and ``process_batch_slice``;
the sharding rule of every parameter of the tiny model and of the
4-head-of-64 model, mapped through the weight bridge onto the JAX
``param_pspec`` + ``_fits`` at tp 2 and 4 (and where the port keeps whole
heads, at tp 8 on the tiny model); ``tp_kernel_ok``; the batch slicing; the
CLI's one-rank-per-card decision; and the ``debug_nans`` conf key, which
stops a train or eval step at its first NaN with FloatingPointError."""

import jax
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import tp_kernel_ok as jax_tp_kernel_ok
from ruart_tpu.parallel import distributed as jax_distributed
from ruart_tpu.parallel.mesh import _fits as jax_fits
from ruart_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ruart_tpu.parallel.mesh import param_pspec as jax_param_pspec
from ruart_tpu_torch.cli import main as cli_main
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.presets import tiny_config
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import GLOBAL_KEYS, RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops.attention import tp_kernel_ok
from ruart_tpu_torch.parallel import distributed
from ruart_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    param_dim,
    shard_batch,
    shard_params,
)
from ruart_tpu_torch.text.wordpiece import build_demo_vocab
from ruart_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
VOCAB_SIZE = len(build_demo_vocab())
MODELS = {
    "tiny": BertConfig.tiny(vocab_size=VOCAB_SIZE),
    "4x64": BertConfig(vocab_size=VOCAB_SIZE, hidden_size=256,
                       num_hidden_layers=2, num_attention_heads=4,
                       intermediate_size=128),
}


@pytest.mark.parametrize("args", [(32, 4, 1), (32, 4, 4), (8, 1, 2),
                                  (8, 2, 4), (32, 4, 16), (32, 4, 3),
                                  (8, 1, 3)])
def test_hybrid_mesh_shape_matches_jax(args):
    try:
        want = jax_distributed.hybrid_mesh_shape(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            distributed.hybrid_mesh_shape(*args)
        assert str(got.value) == str(e)
    else:
        assert distributed.hybrid_mesh_shape(*args) == want


def test_process_batch_slice_matches_jax():
    for n, p in ((16, 2), (16, 4), (12, 3), (8, 1)):
        for r in range(p):
            assert (distributed.process_batch_slice(n, r, p)
                    == jax_distributed.process_batch_slice(n, r, p))
    with pytest.raises(AssertionError):
        distributed.process_batch_slice(10, 0, 3)
    # one process: the whole batch
    assert distributed.process_batch_slice(6) == slice(0, 6)


def _flax_leaf_to_port(path, value):
    """(port state-dict name, whether the bridge transposes the leaf: a
    Dense kernel)."""
    tree = node = {}
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value
    (name, tensor), = from_jax_params(tree).items()
    transposed = path[-1] == "kernel"
    assert tuple(tensor.shape) == tuple(np.shape(value))[::(-1 if transposed
                                                            else 1)]
    return name, transposed


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("bert", sorted(MODELS))
def test_param_rules_match_jax_param_pspec(bert):
    """Every parameter's tp-sharded dim equals the JAX rule's through the
    bridge (a flax [in, out] kernel sharded on 'tp' at dim j is the torch
    weight sharded at dim 1 - j), fallback to replication included (the
    50-row word tables do not divide by 4)."""
    bc = MODELS[bert]
    spec = ModelSpec.from_config(tiny_config(), bc)
    flax = to_jax_params(RUArtModel(spec))["params"]
    heads = bc.num_attention_heads
    n_sharded = 0
    for tp in (2, 4, 8):
        mesh = jax_make_mesh(jax.devices()[:8], tp=tp)
        for path, value in _leaves(flax):
            name, transposed = _flax_leaf_to_port(path, value)
            pspec = jax_param_pspec("/".join(path))
            want = None
            if "tp" in tuple(pspec) and jax_fits(pspec, value.shape, mesh):
                want = tuple(pspec).index("tp")
                want = 1 - want if transposed else want
            shape = value.shape[::-1] if transposed else value.shape
            got = param_dim(name, shape, tp, heads)
            if heads % tp and "attention_" in name and want is not None:
                # the port keeps whole heads (tp_kernel_ok): the JAX
                # package splits them and leaves the kernel
                assert got is None, name
                continue
            assert got == want, (tp, name)
            n_sharded += got is not None
    assert n_sharded > 0


def test_shard_params_slices_this_rank():
    bc = MODELS["4x64"]
    spec = ModelSpec.from_config(tiny_config(), bc)
    state = RUArtModel(spec).state_dict()
    mesh = Mesh.local(1, 2, tp_rank=1)
    local = shard_params(state, mesh, bc.num_attention_heads)
    q = "Bert.layer_0.attention_self.query.weight"
    out = "Bert.layer_1.output_dense.weight"
    assert torch.equal(local[q], state[q][128:])
    assert torch.equal(local[out], state[out][:, 64:])
    assert local["alphaBERT"] is state["alphaBERT"]
    # the rank model holds exactly those shapes
    model = RUArtModel(spec, mesh)
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in local.items()}


def test_tp_kernel_ok_keeps_the_kernel_whenever_tp_divides_heads():
    for heads, dh, tp in ((12, 64, 2), (12, 64, 4), (16, 64, 8), (4, 8, 2),
                          (4, 64, 2), (12, 64, 5), (4, 8, 3), (4, 8, 1)):
        assert tp_kernel_ok(heads, dh, tp) == (heads % tp == 0)
    # where the JAX package leaves its kernel for the 128-lane rule only
    assert not jax_tp_kernel_ok(4, 8, 2) and tp_kernel_ok(4, 8, 2)
    assert not jax_tp_kernel_ok(12, 64, 4) and tp_kernel_ok(12, 64, 4)


def test_shard_batch_keeps_rows_and_global_tables():
    cfg = tiny_config(batch_size=4)
    spec = ModelSpec.from_config(cfg, MODELS["tiny"])
    q, ocr, od, gt = make_synthetic_batch(spec, cfg, 4, seed=1)
    ocr = dict(ocr, cand_sel=np.arange(7))
    for d in range(2):
        lq, locr, _, lgt = shard_batch((q, ocr, od, gt), Mesh.local(2, 1, d),
                                       4, GLOBAL_KEYS)
        assert np.array_equal(lq["glove"], q["glove"][2 * d:2 * d + 2])
        assert np.array_equal(lgt, gt[2 * d:2 * d + 2])
        assert locr["cand_sel"] is ocr["cand_sel"]
    with pytest.raises(ValueError, match="not the batch"):
        shard_batch((q, ocr, od, gt), Mesh.local(2, 1), 2, GLOBAL_KEYS)


def test_one_process_mesh_has_no_collectives():
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.dp_group is None and mesh.tp_group is None
    x = torch.arange(6.0).reshape(2, 3)
    assert np.array_equal(distributed.fetch_local_first(x, mesh, dim=0),
                          x.numpy())
    assert distributed.fetch_local_first(x, mesh, materialize=False) is None


def test_cli_starts_one_rank_per_card(monkeypatch):
    monkeypatch.delenv("RUART_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli_main.cards_to_spawn(tiny_config()) == 4
    assert cli_main.cards_to_spawn(tiny_config(no_mesh=True)) == 0
    assert cli_main.cards_to_spawn(
        tiny_config(coordinator_address="localhost:1")) == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli_main.cards_to_spawn(tiny_config()) == 0
    assert cli_main.rank_overrides(2, 4, "localhost:9") == {
        "coordinator_address": "localhost:9", "num_processes": 4,
        "process_id": 2, "local_device_ids": "2"}
    from ruart_tpu_torch.parallel import launch

    calls = []
    monkeypatch.setattr(launch, "spawn",
                        lambda target, n, args: calls.append((target, n, args)))
    cli_main.spawn_ranks(4, ["--conf_file", "c"])
    assert calls == [("ruart_tpu_torch.cli.main:rank_main", 4,
                      (["--conf_file", "c"], "train"))]


def _trainer(**opt):
    cfg = tiny_config(batch_size=2, datadir=".", FEATURE_FOLDER=".", **opt)
    cli_main.apply_runtime_flags(cfg)
    trainer = Trainer(cfg, bert_config=MODELS["tiny"], device="cpu")
    trainer.setup_model({})
    q, ocr, od, gt = make_synthetic_batch(trainer.spec, cfg, 2, seed=3)
    q, ocr, od = ({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                  for b in (q, ocr, od))
    ocr["position"] = ocr["position"].clone()
    ocr["position"][0, 0, 0] = float("nan")
    return trainer, (q, ocr, od, torch.from_numpy(np.asarray(gt)))


def test_debug_nans_stops_at_the_first_nan():
    try:
        trainer, batch = _trainer(debug_nans=True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="ocr.position"):
            trainer.train_step(trainer.state, *batch)
        with pytest.raises(FloatingPointError, match="scores"):
            trainer.eval_step(*batch)
    finally:
        torch.autograd.set_detect_anomaly(False)
    # without the key the same step runs to its end on a NaN loss
    trainer, batch = _trainer()
    assert not torch.is_anomaly_enabled()
    _, loss = trainer.train_step(trainer.state, *batch)
    assert torch.isnan(loss)
    scores, _ = trainer.eval_step(*batch)
    assert torch.isnan(scores).any()
